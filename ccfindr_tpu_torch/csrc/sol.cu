// The VB sweep on Hopper: four kernels that together replace the
// single-launch Pallas kernel ccfindr_tpu/ops/pallas/sol.py::_sol_kernel.
//
// On the TPU, _sol_kernel walked one sequential grid: the X pass over
// all (gene, cell) tiles, the W posterior on the last cell-tile column,
// the H posterior on wide blocks, and the ELBO assembly plus the hyper
// Newton on the last step, carrying the sufficient statistics in VMEM
// scratch between phases.  Hopper blocks run in no order, so each phase
// boundary is a launch boundary here (the factoring of
// ccfindr_tpu/ops/pallas/sol_sharded.py):
//
//   K1 sol_xpass   X pass: swn / shn partials, x*log(wth), rowSums(eh)
//   K2 sol_w_post  W gamma posterior + colSums(ew') + W scalar partials
//   K3 sol_h_post  H gamma posterior + rowSums(eh') + H scalar partials
//   K4 sol_finish  ELBO assembly (pend, dterm) and the damped Newton
//
// All launch in order on the caller's stream.  Every reduction across
// blocks goes through per-block partials that the next kernel adds in a
// fixed order (no atomics), so a sweep is deterministic run to run.
// Scalar partials are reduced in double for both factor types (the
// JAX kernel Kahan-compensated its f32 scalar sums instead).
//
// Layouts (row-major, leading lane axis B where the JAX package used
// vmap): X (np, mp) of int8/int16/float/double; lwt (B, rp, np) -- W
// transposed, rank rows pad 0, gene columns pad 1; lh and eh
// (B, rp, mp) -- cell columns pad 1 (lh) / 0 (eh); sc (B, 8) double
// [aw, bw, ah, bh, fudge, r_live, lgx, do_elbo]; scal (B, 16) double
// with the slot layout of the enum below.  n and m are the true gene
// and cell counts; columns in [n, np) / [m, mp) are padding.
//
// Products are FP32 (or FP64) FMAs in the factor type, never TF32, and
// x / wth is an exact IEEE division (no fast-math build).

#include <cuda_runtime.h>

#include <cstdint>

#include "reduce.cuh"
#include "specials.cuh"

namespace ccfindr {

constexpr int kSub = 64;       // K1 subtile edge (genes and cells)
constexpr int kChunk = 512;    // genes and cells one K1 block covers
constexpr int kThreads = 256;  // K1-K3 block size
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRp = 128;    // largest padded rank

// scal slots
enum {
  kXlog = 0, kU2, kU3, kSew, kSlw, kSeh, kSlh, kDtw, kDth,
  kPend, kDterm, kAw, kBw, kAh, kBh, kHfail, kNscal
};

// NaN / finiteness tests that need no math-library overloads (the
// build keeps IEEE semantics, so v != v and v - v are not folded)
template <typename T>
__device__ __forceinline__ bool is_nan(T v) { return v != v; }
template <typename T>
__device__ __forceinline__ bool is_finite(T v) { return v - v == T(0); }

// ---------------------------------------------------------------------
// K1 sol_xpass
//
// Replaces: _sol_kernel's phase X (sol.py:210-260): wth = lwt^T lh,
//   u = x / wth, swnt += lh u^T, shn += lwt u, rowSums(eh) of the
//   INCOMING eh, and the x*log(wth) ELBO term under do_elbo.
// Bound: the stream of X (1-8 bytes an element) plus 3*2*rp flops an
//   element -- at rp = 16 and int8 X that is 96 flops a byte, so the
//   FP32 pipes, not HBM, are the roof for this simple kernel.
// Design: a block owns a 512 x 512 (gene x cell) chunk of one lane and
//   walks it in 64 x 64 subtiles staged in shared memory (lwt and lh
//   slices, u).  swn for the current gene subtile accumulates in
//   shared memory across the cell subtiles; shn is accumulated in the
//   block's own slice of the per-gene-chunk partial (read-modify-write
//   by the owning thread only).  Partials cost rp*4*(1/512 + 1/512)
//   bytes an X element and lane (0.25x int8 X at rp = 16).
// ---------------------------------------------------------------------
template <typename T, typename XT>
__global__ void __launch_bounds__(kThreads)
xpass_kernel(const XT* __restrict__ x, const T* __restrict__ lwt,
             const T* __restrict__ lh, const T* __restrict__ eh,
             const double* __restrict__ sc, int np, int mp, int rp,
             T* __restrict__ swn_part, T* __restrict__ shn_part,
             double* __restrict__ xlog_part,
             double* __restrict__ ehs_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* lw_s = reinterpret_cast<T*>(smem_raw);  // rp x kSub
  T* lh_s = lw_s + rp * kSub;                // rp x kSub
  T* sw_s = lh_s + rp * kSub;                // rp x kSub
  T* u_s = sw_s + rp * kSub;                 // kSub x (kSub + 1)
  __shared__ double red[kWarps];

  const int cc = blockIdx.x, gc = blockIdx.y, b = blockIdx.z;
  const int ncc = gridDim.x, ngc = gridDim.y;
  const int tid = threadIdx.x;
  const T* lwt_b = lwt + (size_t)b * rp * np;
  const T* lh_b = lh + (size_t)b * rp * mp;
  const bool do_elbo = sc[b * 8 + 7] > 0.0;
  const int g_begin = gc * kChunk, g_end = min(g_begin + kChunk, np);
  const int c_begin = cc * kChunk, c_end = min(c_begin + kChunk, mp);
  T* swn_b = swn_part + ((size_t)b * ncc + cc) * rp * np;
  T* shn_b = shn_part + ((size_t)b * ngc + gc) * rp * mp;
  const int nsub = rp * kSub;
  constexpr int kU = kSub + 1;  // odd stride: conflict-free columns
  double xl = 0.0;

  for (int g0 = g_begin; g0 < g_end; g0 += kSub) {
    const int gn = min(kSub, g_end - g0);
    __syncthreads();  // readers of the previous gene subtile are done
    for (int e = tid; e < nsub; e += kThreads) {
      const int k = e / kSub, i = e % kSub;
      lw_s[e] = i < gn ? lwt_b[(size_t)k * np + g0 + i] : T(0);
      sw_s[e] = T(0);
    }
    for (int c0 = c_begin; c0 < c_end; c0 += kSub) {
      const int cn = min(kSub, c_end - c0);
      __syncthreads();  // readers of the previous lh_s / u_s are done
      for (int e = tid; e < nsub; e += kThreads) {
        const int k = e / kSub, j = e % kSub;
        lh_s[e] = j < cn ? lh_b[(size_t)k * mp + c0 + j] : T(0);
      }
      __syncthreads();
      for (int e = tid; e < kSub * kSub; e += kThreads) {
        const int i = e / kSub, j = e % kSub;
        T u = T(0);
        if (i < gn && j < cn) {
          T w = T(0);
          for (int k = 0; k < rp; ++k)
            w = fma(lw_s[k * kSub + i], lh_s[k * kSub + j], w);
          const T xv = static_cast<T>(x[(size_t)(g0 + i) * mp + c0 + j]);
          u = xv / w;
          if (do_elbo) xl += static_cast<double>(xv * log(w));
        }
        u_s[i * kU + j] = u;
      }
      __syncthreads();
      // shn: entry (k, j) summed over the subtile's genes
      for (int e = tid; e < nsub; e += kThreads) {
        const int k = e / kSub, j = e % kSub;
        if (j < cn) {
          T s = T(0);
          for (int i = 0; i < gn; ++i)
            s = fma(lw_s[k * kSub + i], u_s[i * kU + j], s);
          T* dst = shn_b + (size_t)k * mp + c0 + j;
          *dst = (g0 == g_begin) ? s : *dst + s;
        }
      }
      // swn: entry (k, i) summed over the subtile's cells
      for (int e = tid; e < nsub; e += kThreads) {
        const int k = e / kSub, i = e % kSub;
        T s = T(0);
        for (int j = 0; j < cn; ++j)
          s = fma(u_s[i * kU + j], lh_s[k * kSub + j], s);
        sw_s[e] += s;
      }
    }
    // each sw_s entry is owned by one thread throughout: no barrier
    for (int e = tid; e < nsub; e += kThreads) {
      const int k = e / kSub, i = e % kSub;
      if (i < gn) swn_b[(size_t)k * np + g0 + i] = sw_s[e];
    }
  }

  const double xs = block_sum(xl, red);
  if (tid == 0) xlog_part[((size_t)b * ngc + gc) * ncc + cc] = xs;

  // rowSums of the incoming eh over this cell chunk, once per chunk
  if (gc == 0) {
    const T* eh_b = eh + (size_t)b * rp * mp;
    const int lane = tid & 31;
    for (int k = tid >> 5; k < rp; k += kWarps) {
      double s = 0.0;
      for (int j = c_begin + lane; j < c_end; j += 32)
        s += static_cast<double>(eh_b[(size_t)k * mp + j]);
      s = warp_sum(s);
      if (lane == 0) ehs_part[((size_t)b * ncc + cc) * rp + k] = s;
    }
  }
}

// ---------------------------------------------------------------------
// K2 sol_w_post / K3 sol_h_post (one kernel, two launches)
//
// Replaces: _sol_kernel's W epilogue (sol.py:262-281) and H phase
//   (sol.py:283-300), i.e. _post_tile (sol.py:139-182): the gamma
//   posterior of one factor in the (rank rows, long-axis columns)
//   layout both sides share, with its zones -- live entries; rank rows
//   in [r_live, r) pinned at fudge with e = d = 0; padding columns 1
//   (rows < r) or 0; logl = log(fudge) where ln_raw <= fudge.
// Bound: small -- it reads the sufficient-statistic partials and the
//   factor once and writes three factors: ~(nparts + 4) * rp * cols
//   words, plus one digamma/lgamma chain an entry.
// Design: one thread a column, looping over the rank rows; the block
//   first reduces the beta denominator (rowSums(eh) for W, colSums(ew')
//   for H) from the previous kernel's partials.  It writes per-block
//   partials of its rank sums and of the four scalars (U, sum e,
//   sum log l, dterm) for the next kernel.
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
post_kernel(const T* __restrict__ sfx_part, int nsfx,
            const T* __restrict__ lf, const double* __restrict__ denom_part,
            int ndenom, const double* __restrict__ sc, int ab, int ext,
            int rp, int r, int n_true, T* __restrict__ e_out,
            T* __restrict__ l_out, T* __restrict__ d_out,
            double* __restrict__ rsum_part, double* __restrict__ scal_part) {
  __shared__ T be_s[kMaxRp];
  __shared__ T logbe_s[kMaxRp];
  __shared__ double wsum[kWarps][kMaxRp];
  __shared__ double red[kWarps];
  const int blk = blockIdx.x, b = blockIdx.y, nblk = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int col = blk * kThreads + tid;
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
  const bool col_live = col < n_true;
  double su = 0.0, se = 0.0, sl = 0.0, sd = 0.0;
  for (int k = 0; k < rp; ++k) {
    T e = T(0);
    if (in_range) {
      const size_t off = ((size_t)b * rp + k) * ext + col;
      double acc = 0.0;
      for (int p = 0; p < nsfx; ++p)
        acc += static_cast<double>(
            sfx_part[(((size_t)b * nsfx + p) * rp + k) * ext + col]);
      const T sfx = static_cast<T>(acc);
      const T lfv = lf[off];
      const bool live = static_cast<T>(k) < r_live && col_live;
      const T be = be_s[k], log_be = logbe_s[k];
      const T al = a + lfv * sfx;
      T psi, lgam;
      digamma_gammaln_both<T>(al, psi, lgam);
      const T ln_raw = exp(psi) * be;
      T ln, d = T(0), u = T(0), logl = T(0), dt = T(0);
      if (live) {
        e = al * be;
        ln = (ln_raw >= fudge || is_nan(ln_raw)) ? ln_raw : fudge;
        d = al * (be * be);
        u = -a_over_b * e + al * (T(1) + log_be) + lgam;
        logl = ln_raw > fudge ? psi + log_be : log_fudge;
        dt = sfx * lfv * log(lfv);
      } else {
        ln = (k < r && col_live) ? fudge : (k < r ? T(1) : T(0));
      }
      e_out[off] = e;
      l_out[off] = ln;
      d_out[off] = d;
      su += static_cast<double>(u);
      se += static_cast<double>(e);
      sl += static_cast<double>(logl);
      sd += static_cast<double>(dt);
    }
    const double ws = warp_sum(static_cast<double>(e));
    if (lane == 0) wsum[w][k] = ws;
  }
  __syncthreads();
  if (tid < rp) {
    double s = 0.0;
    for (int i = 0; i < kWarps; ++i) s += wsum[i][tid];
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

// ---------------------------------------------------------------------
// K4 sol_finish
//
// Replaces: _sol_kernel's last grid step (sol.py:302-324) and
//   _newton_scalar (sol.py:90-136): pend = -csum(ew').rsum(eh') - lgx
//   + U2 + U3 + the prior constants; dterm = -(DTW + DTH) + xlog; the
//   damped Newton of the gamma shapes with iterated halving, non-finite
//   steps zeroed, and a per-lane hyper mask.
// Bound: latency -- a few hundred dependent scalar operations a lane.
// Design: one warp a lane reduces every partial in a fixed order in
//   double (lane-strided sums, then a butterfly); lane 0 assembles the
//   ELBO in double and runs the Newton in the factor type, as the JAX
//   kernel ran it in its factor dtype.
// ---------------------------------------------------------------------
template <typename T>
__device__ T newton_step(T a0, T mean_e, T mean_l, T b0, bool enabled) {
  if (!enabled) return T(0);
  return (log(a0) - digamma_approx<T>(a0) - mean_e / b0 + T(1) + mean_l
          - log(b0)) / (T(1) / a0 - trigamma<T>(a0));
}

template <typename T>
__device__ T positive_step(T a0, T d) {
  // halve until a0 - d > 0 (reference R/bayesian.R:28-35); a
  // non-finite step is zeroed first so the loop ends
  if (!is_finite(d)) d = T(0);
  for (int i = 0; i < 4096 && a0 - d <= T(0); ++i) d = d * T(0.5);
  return d;
}

template <typename T>
__global__ void finish_kernel(const double* __restrict__ sc,
                              const double* __restrict__ xlog_part, int nx,
                              const double* __restrict__ csum_part,
                              const double* __restrict__ wscal_part, int nbw,
                              const double* __restrict__ rsum_part,
                              const double* __restrict__ hscal_part, int nbh,
                              int rp, int n, int m, int mask, int niter,
                              double tol, double* __restrict__ scal) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const double* scb = sc + b * 8;
  const double xlog = warp_strided_sum(xlog_part + (size_t)b * nx, nx, 1,
                                       lane);
  double ws[4], hs[4];
  for (int q = 0; q < 4; ++q) {
    ws[q] = warp_strided_sum(wscal_part + (size_t)b * nbw * 4 + q, nbw, 4,
                             lane);
    hs[q] = warp_strided_sum(hscal_part + (size_t)b * nbh * 4 + q, nbh, 4,
                             lane);
  }
  double cr = 0.0;
  for (int k = 0; k < rp; ++k) {
    const double c = warp_strided_sum(csum_part + (size_t)b * nbw * rp + k,
                                      nbw, rp, lane);
    const double h = warp_strided_sum(rsum_part + (size_t)b * nbh * rp + k,
                                      nbh, rp, lane);
    cr += c * h;
  }
  if (lane != 0) return;

  const double aw = scb[0], bw = scb[1], ah = scb[2], bh = scb[3];
  const double r_live = scb[5], lgx = scb[6];
  const double nr = n * r_live, rm = r_live * m;
  const double u1 = -cr - lgx;
  const double const_w = nr * (aw * log(aw / bw) - gammaln_approx<double>(aw));
  const double const_h = rm * (ah * log(ah / bh) - gammaln_approx<double>(ah));
  double* out = scal + (size_t)b * kNscal;
  out[kXlog] = xlog;
  out[kU2] = ws[0];
  out[kSew] = ws[1];
  out[kSlw] = ws[2];
  out[kDtw] = ws[3];
  out[kU3] = hs[0];
  out[kSeh] = hs[1];
  out[kSlh] = hs[2];
  out[kDth] = hs[3];
  out[kPend] = u1 + ws[0] + const_w + hs[0] + const_h;
  out[kDterm] = -(ws[3] + hs[3]) + xlog;

  const bool m0 = mask & 1, m1 = mask & 2, m2 = mask & 4, m3 = mask & 8;
  const T aw0 = static_cast<T>(aw), bw0 = static_cast<T>(bw);
  const T ah0 = static_cast<T>(ah), bh0 = static_cast<T>(bh);
  const T lwm = static_cast<T>(ws[2] / nr), ewm = static_cast<T>(ws[1] / nr);
  const T lhm = static_cast<T>(hs[2] / rm), ehm = static_cast<T>(hs[1] / rm);
  T aw1 = aw0, ah1 = ah0;
  bool failed = false;
  if (m0 || m2) {
    bool done = false;
    for (int it = 0; !done && it < niter - 1; ++it) {
      const T dw = positive_step<T>(aw1, newton_step<T>(aw1, ewm, lwm, bw0, m0));
      const T dh = positive_step<T>(ah1, newton_step<T>(ah1, ehm, lhm, bh0, m2));
      const T a1 = aw1 - dw, h1 = ah1 - dh;
      const T fw = T(1) - a1 / aw1, fh = T(1) - h1 / ah1;
      aw1 = a1;
      ah1 = h1;
      done = fw * fw + fh * fh < static_cast<T>(tol);
    }
    failed = !done;
  }
  out[kAw] = static_cast<double>(aw1);
  out[kBw] = static_cast<double>(m1 ? ewm : bw0);
  out[kAh] = static_cast<double>(ah1);
  out[kBh] = static_cast<double>(m3 ? ehm : bh0);
  out[kHfail] = failed ? 1.0 : 0.0;
}

// ---------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------
template <typename T, typename XT>
cudaError_t launch_xpass(const void* x, const void* lwt, const void* lh,
                         const void* eh, const double* sc, int B, int np,
                         int mp, int rp, void* swn_part, void* shn_part,
                         double* xlog_part, double* ehs_part,
                         cudaStream_t stream) {
  const dim3 grid(ceil_div(mp, kChunk), ceil_div(np, kChunk), B);
  const size_t smem = (size_t)(3 * rp * kSub + kSub * (kSub + 1)) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      xpass_kernel<T, XT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  xpass_kernel<T, XT><<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const T*>(lwt),
      static_cast<const T*>(lh), static_cast<const T*>(eh), sc, np, mp, rp,
      static_cast<T*>(swn_part), static_cast<T*>(shn_part), xlog_part,
      ehs_part);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_post(const void* sfx_part, int nsfx, const void* lf,
                        const double* denom_part, int ndenom,
                        const double* sc, int ab, int B, int ext, int rp,
                        int r, int n_true, void* e_out, void* l_out,
                        void* d_out, double* rsum_part, double* scal_part,
                        cudaStream_t stream) {
  const dim3 grid(ceil_div(ext, kThreads), B);
  post_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(sfx_part), nsfx, static_cast<const T*>(lf),
      denom_part, ndenom, sc, ab, ext, rp, r, n_true,
      static_cast<T*>(e_out), static_cast<T*>(l_out),
      static_cast<T*>(d_out), rsum_part, scal_part);
  return cudaGetLastError();
}

int post_entry(int tcode, const void* sfx_part, int nsfx, const void* lf,
               const double* denom_part, int ndenom, const double* sc,
               int ab, int B, int ext, int rp, int r, int n_true,
               void* e_out, void* l_out, void* d_out, double* rsum_part,
               double* scal_part, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rp > kMaxRp) return static_cast<int>(cudaErrorInvalidValue);
  if (tcode == 0)
    return launch_post<float>(sfx_part, nsfx, lf, denom_part, ndenom, sc, ab,
                              B, ext, rp, r, n_true, e_out, l_out, d_out,
                              rsum_part, scal_part, s);
  if (tcode == 1)
    return launch_post<double>(sfx_part, nsfx, lf, denom_part, ndenom, sc, ab,
                               B, ext, rp, r, n_true, e_out, l_out, d_out,
                               rsum_part, scal_part, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ccfindr

using namespace ccfindr;

// C interface, bound with ctypes by ccfindr_tpu_torch/ops/kernels/sol.py.
// tcode: factor type 0 float, 1 double.  xcode: X type 0 int8, 1 int16,
// 2 float, 3 double.  Each returns cudaGetLastError() after its launch.
extern "C" {

int sol_xpass(int tcode, int xcode, const void* x, const void* lwt,
              const void* lh, const void* eh, const double* sc, int B,
              int np, int mp, int rp, void* swn_part, void* shn_part,
              double* xlog_part, double* ehs_part, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rp > kMaxRp) return static_cast<int>(cudaErrorInvalidValue);
#define XPASS(T, XT)                                                     \
  return static_cast<int>(launch_xpass<T, XT>(                           \
      x, lwt, lh, eh, sc, B, np, mp, rp, swn_part, shn_part, xlog_part,  \
      ehs_part, s))
  switch (tcode * 4 + xcode) {
    case 0: XPASS(float, int8_t);
    case 1: XPASS(float, int16_t);
    case 2: XPASS(float, float);
    case 3: XPASS(float, double);
    case 4: XPASS(double, int8_t);
    case 5: XPASS(double, int16_t);
    case 6: XPASS(double, float);
    case 7: XPASS(double, double);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef XPASS
}

int sol_w_post(int tcode, const void* swn_part, int ncc, const void* lwt,
               const double* ehs_part, int nehs, const double* sc, int B,
               int np, int rp, int r, int n, void* ewt, void* lwtn,
               void* dwt, double* csum_part, double* wscal_part,
               void* stream) {
  return post_entry(tcode, swn_part, ncc, lwt, ehs_part, nehs, sc, 0, B, np,
                    rp, r, n, ewt, lwtn, dwt, csum_part, wscal_part, stream);
}

int sol_h_post(int tcode, const void* shn_part, int ngc, const void* lh,
               const double* csum_part, int nbw, const double* sc, int B,
               int mp, int rp, int r, int m, void* ehn, void* lhn, void* dhn,
               double* rsum_part, double* hscal_part, void* stream) {
  return post_entry(tcode, shn_part, ngc, lh, csum_part, nbw, sc, 2, B, mp,
                    rp, r, m, ehn, lhn, dhn, rsum_part, hscal_part, stream);
}

int sol_finish(int tcode, const double* sc, const double* xlog_part, int nx,
               const double* csum_part, const double* wscal_part, int nbw,
               const double* rsum_part, const double* hscal_part, int nbh,
               int B, int rp, int n, int m, int mask, int niter, double tol,
               double* scal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tcode == 0)
    finish_kernel<float><<<B, 32, 0, s>>>(sc, xlog_part, nx, csum_part,
                                          wscal_part, nbw, rsum_part,
                                          hscal_part, nbh, rp, n, m, mask,
                                          niter, tol, scal);
  else if (tcode == 1)
    finish_kernel<double><<<B, 32, 0, s>>>(sc, xlog_part, nx, csum_part,
                                           wscal_part, nbw, rsum_part,
                                           hscal_part, nbh, rp, n, m, mask,
                                           niter, tol, scal);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
