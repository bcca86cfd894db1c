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
//   words, plus one digamma/lgamma chain a live entry.  At the 10x shape
//   (6 lanes of rp 16) K2 reads K1's 32 swn partials a gene: 56.8 MB
//   with its factor and outputs, 0.017 ms at 3.35 TB/s.
// What held the first design back: a thread owned a long-axis column
//   and walked its rp rank rows in series, each a serial sum of the
//   nparts partials and a double butterfly of e, and a block covered
//   256 columns of one lane, so K2 launched 96 blocks at the 10x shape
//   (under one an SM) of 16 dependent rounds each: 0.062 ms a launch,
//   ~0.9 TB/s (H100 80GB HBM3, 700 W, tools/bench_post.py).
// Design: a thread an entry.  A block covers all rp rank rows of
//   kPostCols long-axis columns of one lane (the wrapper's
//   sol.POST_COLS), and its 256 threads walk the block's rp x kPostCols
//   entries with consecutive threads on consecutive columns, so every
//   load of the partials and the factor and every store of e, ln and d
//   is a warp's 128 contiguous bytes in float; a warp holds 32 columns
//   of one rank row, so the rank sums are a butterfly a warp and one
//   shared slot a 32-column segment.  Each entry still adds its
//   partials in order p = 0 .. nparts - 1 in double, kPostLoads loads
//   issued before their adds, and computes gamma_post, so e, ln and d
//   have the first design's bits.  The block first reduces the beta
//   denominator (rowSums(eh) for W, colSums(ew') for H) from the
//   previous kernel's partials: every thread stages whole partials into
//   shared memory, kPostStage doubles at a time, and one thread a rank
//   adds them in order p.  It writes one partial a block of its
//   rank sums and of the four scalars (U, sum e, sum log l, dterm), each
//   summed in double in a fixed order, in the layout K4 sol_finish reads.
//   The block's work depends on (ext, rp) alone, never on the lane
//   count, and its partials on its own kPostCols columns: kPostCols
//   divides 512, so a cell shard of a multiple of 512 cells gives the
//   single-device partials (sol_sharded).  No atomic.  On the same card
//   (tools/bench_post.py, a launch in a CUDA graph) K2 at 10x takes
//   ~0.029 ms and K3 ~0.035, near 55% of their bytes' floor: the
//   denominator each block recomputes (K3 reads K2's 128 partials a
//   rank) and the entries' chains share the time with the loads; 64 or
//   128 columns a block, 8 loads in flight, an unrolled entry loop or a
//   5-block register cap were each slower at some site.
#pragma once

#include <cuda_runtime.h>

#include "reduce.cuh"
#include "specials.cuh"

namespace ccfindr {

constexpr int kPostThreads = 256;
constexpr int kPostWarps = kPostThreads / 32;
constexpr int kPostCols = 32;   // long-axis columns a block (sol.POST_COLS)
constexpr int kPostSegs = kPostCols / 32;  // warps a rank row spans
constexpr int kPostLoads = 16;  // partial loads in flight a thread
constexpr int kPostStage = 2048;  // denominator doubles staged at once
constexpr int kMaxRp = 128;  // largest padded rank
static_assert(kPostCols % 32 == 0 && kPostThreads % kPostCols == 0 &&
                  512 % kPostCols == 0,
              "a warp holds one rank row's columns, and a block's columns "
              "divide the mesh's 512-cell shards");
static_assert(kPostThreads >= kMaxRp + 4, "rank sums and scalars in one step");

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

// s + p[0] + p[stride] + ... + p[(count-1) stride] in double, in that
// order, with kIn loads issued before their adds: the bits of the
// serial loop.
template <int kIn, typename T>
__device__ __forceinline__ double ordered_sum(const T* __restrict__ p,
                                              int count, size_t stride,
                                              double s = 0.0) {
  int i = 0;
  for (; i + kIn <= count; i += kIn) {
    T v[kIn];
#pragma unroll
    for (int q = 0; q < kIn; ++q) v[q] = p[(size_t)(i + q) * stride];
#pragma unroll
    for (int q = 0; q < kIn; ++q) s += static_cast<double>(v[q]);
  }
  for (; i < count; ++i) s += static_cast<double>(p[(size_t)i * stride]);
  return s;
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
  __shared__ double rs_s[kMaxRp * kPostSegs];
  __shared__ double red[4][kPostWarps];
  __shared__ double den_s[kPostStage];
  const int blk = blockIdx.x, b = blockIdx.y, nblk = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const double* scb = sc + b * 8;
  const T a = static_cast<T>(scb[ab]);
  const T bb = static_cast<T>(scb[ab + 1]);
  const T fudge = static_cast<T>(scb[4]);
  const T r_live = static_cast<T>(scb[5]);
  const T a_over_b = a / bb;
  const T log_fudge = log(fudge);
  // the denominator: whole partials staged through shared memory by
  // every thread, then rank tid's running sum over them in order p
  const double* dp = denom_part + (size_t)b * ndenom * rp;
  const int dtotal = ndenom * rp, dchunk = (kPostStage / rp) * rp;
  double dsum = 0.0;
  for (int base = 0; base < dtotal; base += dchunk) {
    const int cnt = min(dchunk, dtotal - base);
#pragma unroll 8
    for (int i = tid; i < cnt; i += kPostThreads) den_s[i] = dp[base + i];
    __syncthreads();
    if (tid < rp)
      dsum = ordered_sum<kPostLoads>(den_s + tid, cnt / rp, rp, dsum);
    __syncthreads();
  }
  if (tid < rp) {
    const T be = T(1) / (a_over_b + static_cast<T>(dsum));
    be_s[tid] = be;
    logbe_s[tid] = log(be);
  }
  __syncthreads();

  // entry i of the block: rank row k = i / kPostCols, column c; a warp's
  // 32 entries share k (rp * kPostCols is a multiple of 32, so a warp
  // is in the loop or out of it as a whole)
  const size_t plane = (size_t)rp * ext;  // one partial of a lane
  const T* sfx_b = sfx_part + (size_t)b * nsfx * plane;
  double su = 0.0, se = 0.0, sl = 0.0, sd = 0.0;
  for (int i = tid; i < rp * kPostCols; i += kPostThreads) {
    const int k = i / kPostCols, c = i % kPostCols;
    const int col = blk * kPostCols + c;
    T e = T(0);
    if (col < ext) {
      const size_t off = (size_t)k * ext + col;  // in a lane's plane
      const T sfx = static_cast<T>(
          ordered_sum<kPostLoads>(sfx_b + off, nsfx, plane));
      const size_t o = (size_t)b * plane + off;
      const T lfv = lf[o];
      const bool live = static_cast<T>(k) < r_live && col < n_live;
      const PostOut<T> po =
          gamma_post(sfx, lfv, a, be_s[k], logbe_s[k], a_over_b, fudge,
                     log_fudge, live, k, r, col < n_pin);
      e = po.e;
      e_out[o] = po.e;
      l_out[o] = po.ln;
      d_out[o] = po.d;
      su += static_cast<double>(po.u);
      se += static_cast<double>(po.e);
      sl += static_cast<double>(po.logl);
      sd += static_cast<double>(po.dt);
    }
    const double ws = warp_sum(static_cast<double>(e));
    if (lane == 0) rs_s[k * kPostSegs + c / 32] = ws;
  }
  su = warp_sum(su);
  se = warp_sum(se);
  sl = warp_sum(sl);
  sd = warp_sum(sd);
  if (lane == 0) {
    red[0][w] = su;
    red[1][w] = se;
    red[2][w] = sl;
    red[3][w] = sd;
  }
  __syncthreads();
  const size_t pb = (size_t)b * nblk + blk;
  if (tid < rp) {  // rank k's segments in column order
    double s = 0.0;
    for (int j = 0; j < kPostSegs; ++j) s += rs_s[tid * kPostSegs + j];
    rsum_part[pb * rp + tid] = s;
  }
  const int q = tid - kMaxRp;
  if (q >= 0 && q < 4) {  // scalar q: the warps' sums in warp order
    double s = 0.0;
    for (int j = 0; j < kPostWarps; ++j) s += red[q][j];
    scal_part[pb * 4 + q] = s;
  }
}

template <typename T>
cudaError_t launch_post(const void* sfx_part, int nsfx, const void* lf,
                        const double* denom_part, int ndenom,
                        const double* sc, int ab, int B, int ext, int rp,
                        int r, int n_live, int n_pin, void* e_out,
                        void* l_out, void* d_out, double* rsum_part,
                        double* scal_part, cudaStream_t stream) {
  const dim3 grid(ceil_div(ext, kPostCols), B);
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
