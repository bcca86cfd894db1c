// The gamma-posterior kernel of one factor in (rank rows, long-axis
// columns) layout, shared by the two sweeps.
//
// sol.cu launches it as K2 sol_w_post / K3 sol_h_post on the factors of
// the cell-major sweep (W transposed, lwt (B, rp, np); H (B, rp, mp)),
// epi.cu as E3 epi_h_post on H of the gene-major sweep (B, rp, mp).
// The gene-major sweep's W is row-major (B, np, rp), as the JAX package
// lays it out: E2 epi_w_post has a kernel of its own (epi_w.cuh) that
// computes each entry with this file's gamma_post.
//
// Replaces: _post_tile (ccfindr_tpu/ops/pallas/sol.py:139-182) and the
//   epilogue kernel _h_epilogue_kernel (ccfindr_tpu/ops/pallas/
//   epilogue.py:134): the gamma posterior
//   with its zones -- live entries (rank k < r_live, long-axis index
//   < n_live); rank rows k < r outside the live zone but inside n_pin
//   pinned at fudge with e = d = 0; the rest 1 (k < r) or 0 (padding);
//   logl = log(fudge) where ln_raw <= fudge.  n_live < n_pin is the
//   JAX epilogue's m_live < m (mesh cell padding); the sol sweep has
//   n_live == n_pin.
// Bound: bytes -- it reads the sufficient-statistic partials and the
//   factor once and writes three factors: ~(nparts + 4) * rp * cols
//   words, plus one digamma/lgamma chain an entry.
// Design: one thread a long-axis index, looping over the rank rows; the
//   block first reduces the beta denominator (rowSums(eh) for W,
//   colSums(ew') for H) from the previous kernel's partials.  It writes
//   per-block partials of its rank sums and of the four scalars (U,
//   sum e, sum log l, dterm), in the layout K4 sol_finish reads.
#pragma once

#include <cuda_runtime.h>

#include "reduce.cuh"
#include "specials.cuh"

namespace ccfindr {

constexpr int kPostThreads = 256;
constexpr int kPostWarps = kPostThreads / 32;
constexpr int kMaxRp = 128;  // largest padded rank

// NaN / finiteness tests that need no math-library overloads (the
// build keeps IEEE semantics, so v != v and v - v are not folded)
template <typename T>
__device__ __forceinline__ bool is_nan(T v) { return v != v; }
template <typename T>
__device__ __forceinline__ bool is_finite(T v) { return v - v == T(0); }

// One entry of the gamma posterior, the function post_kernel and E2's
// epi_w_kernel (epi_w.cuh) both compute, so that they share its bits:
// al = a + lf sfx, be = 1 / (a/b + denominator); inside the live zone
// e = al be, ln = exp(psi(al)) be floored at fudge (NaN kept), d = al
// be^2 and the ELBO summands u, logl (log fudge where ln_raw <= fudge)
// and dt = sfx lf log lf; outside it e = d = u = logl = dt = 0 and ln
// is fudge where pinned (rank k < r and ``pin``), else 1 (k < r) or 0.
template <typename T>
struct PostOut {
  T e, ln, d, u, logl, dt;
};

template <typename T>
__device__ __forceinline__ PostOut<T> gamma_post(T sfx, T lfv, T a, T be,
                                                 T log_be, T a_over_b,
                                                 T fudge, T log_fudge,
                                                 bool live, int k, int r,
                                                 bool pin) {
  const T al = a + lfv * sfx;
  T psi, lgam;
  digamma_gammaln_both<T>(al, psi, lgam);
  const T ln_raw = exp(psi) * be;
  PostOut<T> o{T(0), T(0), T(0), T(0), T(0), T(0)};
  if (live) {
    o.e = al * be;
    o.ln = (ln_raw >= fudge || is_nan(ln_raw)) ? ln_raw : fudge;
    o.d = al * (be * be);
    o.u = -a_over_b * o.e + al * (T(1) + log_be) + lgam;
    o.logl = ln_raw > fudge ? psi + log_be : log_fudge;
    o.dt = sfx * lfv * log(lfv);
  } else {
    o.ln = (k < r && pin) ? fudge : (k < r ? T(1) : T(0));
  }
  return o;
}

template <typename T>
__global__ void __launch_bounds__(kPostThreads)
post_kernel(const T* __restrict__ sfx_part, int nsfx,
            const T* __restrict__ lf, const double* __restrict__ denom_part,
            int ndenom, const double* __restrict__ sc, int ab, int ext,
            int rp, int r, int n_live, int n_pin, T* __restrict__ e_out,
            T* __restrict__ l_out, T* __restrict__ d_out,
            double* __restrict__ rsum_part, double* __restrict__ scal_part) {
  __shared__ T be_s[kMaxRp];
  __shared__ T logbe_s[kMaxRp];
  __shared__ double wsum[kPostWarps][kMaxRp];
  __shared__ double red[kPostWarps];
  const int blk = blockIdx.x, b = blockIdx.y, nblk = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int col = blk * kPostThreads + tid;
  const double* scb = sc + b * 8;
  const T a = static_cast<T>(scb[ab]);
  const T bb = static_cast<T>(scb[ab + 1]);
  const T fudge = static_cast<T>(scb[4]);
  const T r_live = static_cast<T>(scb[5]);
  const T a_over_b = a / bb;
  const T log_fudge = log(fudge);
  if (tid < rp) {
    double s = 0.0;
    for (int p = 0; p < ndenom; ++p)
      s += denom_part[((size_t)b * ndenom + p) * rp + tid];
    const T be = T(1) / (a_over_b + static_cast<T>(s));
    be_s[tid] = be;
    logbe_s[tid] = log(be);
  }
  __syncthreads();

  const bool in_range = col < ext;
  const bool col_live = col < n_live;
  const bool col_pin = col < n_pin;
  double su = 0.0, se = 0.0, sl = 0.0, sd = 0.0;
  for (int k = 0; k < rp; ++k) {
    T e = T(0);
    if (in_range) {
      // element (k, col) of lane b, and of partial p of lane b
      const size_t off = ((size_t)b * rp + k) * ext + col;
      double acc = 0.0;
      for (int p = 0; p < nsfx; ++p) {
        const size_t bp = (size_t)b * nsfx + p;
        acc += static_cast<double>(sfx_part[(bp * rp + k) * ext + col]);
      }
      const T sfx = static_cast<T>(acc);
      const T lfv = lf[off];
      const bool live = static_cast<T>(k) < r_live && col_live;
      const PostOut<T> o =
          gamma_post(sfx, lfv, a, be_s[k], logbe_s[k], a_over_b, fudge,
                     log_fudge, live, k, r, col_pin);
      e = o.e;
      e_out[off] = o.e;
      l_out[off] = o.ln;
      d_out[off] = o.d;
      su += static_cast<double>(o.u);
      se += static_cast<double>(o.e);
      sl += static_cast<double>(o.logl);
      sd += static_cast<double>(o.dt);
    }
    const double ws = warp_sum(static_cast<double>(e));
    if (lane == 0) wsum[w][k] = ws;
  }
  __syncthreads();
  if (tid < rp) {
    double s = 0.0;
    for (int i = 0; i < kPostWarps; ++i) s += wsum[i][tid];
    rsum_part[((size_t)b * nblk + blk) * rp + tid] = s;
  }
  double* out = scal_part + ((size_t)b * nblk + blk) * 4;
  double v = block_sum(su, red);
  if (tid == 0) out[0] = v;
  v = block_sum(se, red);
  if (tid == 0) out[1] = v;
  v = block_sum(sl, red);
  if (tid == 0) out[2] = v;
  v = block_sum(sd, red);
  if (tid == 0) out[3] = v;
}

template <typename T>
cudaError_t launch_post(const void* sfx_part, int nsfx, const void* lf,
                        const double* denom_part, int ndenom,
                        const double* sc, int ab, int B, int ext, int rp,
                        int r, int n_live, int n_pin, void* e_out,
                        void* l_out, void* d_out, double* rsum_part,
                        double* scal_part, cudaStream_t stream) {
  const dim3 grid(ceil_div(ext, kPostThreads), B);
  post_kernel<T><<<grid, kPostThreads, 0, stream>>>(
      static_cast<const T*>(sfx_part), nsfx, static_cast<const T*>(lf),
      denom_part, ndenom, sc, ab, ext, rp, r, n_live, n_pin,
      static_cast<T*>(e_out), static_cast<T*>(l_out),
      static_cast<T*>(d_out), rsum_part, scal_part);
  return cudaGetLastError();
}

// tcode: factor type 0 float, 1 double.  ab: the sc slot of the prior
// shape (0 for W, 2 for H).
inline int post_entry(int tcode, const void* sfx_part, int nsfx, const void* lf,
               const double* denom_part, int ndenom, const double* sc,
               int ab, int B, int ext, int rp, int r, int n_live, int n_pin,
               void* e_out, void* l_out, void* d_out, double* rsum_part,
               double* scal_part, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rp > kMaxRp) return static_cast<int>(cudaErrorInvalidValue);
  if (tcode == 0)
    return static_cast<int>(launch_post<float>(
        sfx_part, nsfx, lf, denom_part, ndenom, sc, ab, B, ext, rp, r,
        n_live, n_pin, e_out, l_out, d_out, rsum_part, scal_part, s));
  if (tcode == 1)
    return static_cast<int>(launch_post<double>(
        sfx_part, nsfx, lf, denom_part, ndenom, sc, ab, B, ext, rp, r,
        n_live, n_pin, e_out, l_out, d_out, rsum_part, scal_part, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ccfindr
