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

#include "fused.cuh"
#include "post.cuh"
#include "reduce.cuh"
#include "specials.cuh"

namespace ccfindr {

// scal slots
enum {
  kXlog = 0, kU2, kU3, kSew, kSlw, kSeh, kSlh, kDtw, kDth,
  kPend, kDterm, kAw, kBw, kAh, kBh, kHfail, kNscal
};

// ---------------------------------------------------------------------
// K1 sol_xpass
//
// Replaces: the X phase of _sol_kernel (ccfindr_tpu/ops/pallas/sol.py:185,
//   its grid steps over the (gene, cell) tiles, :210-260) and, launched
//   on one cell shard, _xpass_kernel (ccfindr_tpu/ops/pallas/
//   sol_sharded.py:80): for each lane wth = lwt^T lh, u = x / wth, the
//   swn partials of each cell chunk (B, ncc, rp, np), the shn partials
//   of each gene chunk (B, ngc, rp, mp), sum x*log(wth) in double per
//   (gene chunk, cell chunk) under the lane's runtime do_elbo (sc[b, 7]),
//   and rowSums of the INCOMING eh per cell chunk.  kBf16 is the JAX
//   kernel's mxu_bf16 (bf16.cuh): lwt, lh and u rounded to bf16, sums and
//   log(wth) in the factor type.
// Bound on this card: the FP32 pipes.  3 products of 2*rp flops an X
//   element and lane: at the 10x shape (4,096 x 8,192 int8, 6 lanes of
//   rp 16) 19.3 GFLOP, 0.29 ms at 67 TFLOP/s, against 33.5 MB of X
//   (0.01 ms at 3.35 TB/s); beside the products an element costs a
//   division and a log.  The first design (one element a thread) ran
//   at 6.8 TFLOP/s, ~10% of the pipes (2.856 ms, H100 80GB HBM3,
//   700 W): two scalar shared loads an FMA, the IEEE division's
//   slow-path call in the hot loop, and a read-modify-write of the shn
//   partial in device memory for every gene subtile.
// Design: E1's walk (fused.cuh) with kWt: 16 x 16 threads with 4 x 4
//   register tiles; wth from 16-byte shared fragments of the rank-major
//   lwt tile (four genes at one rank, ldw) and of lh, each load feeding
//   8 FMAs; u by div_rn, the division's fast path inlined; X and both
//   factor tiles staged by cp.async into a double buffer, one barrier a
//   step; swn (the resident output) reduced a step by a half-warp
//   reduce-scatter into shared rows, written once a block as its cell
//   chunk's partial; shn (the streamed output) in registers across the
//   gene subtiles of an S-tile, written once.  A block owns one chunk of
//   genes x one chunk of cells of a lane (the wrapper's sol.CHUNK): the
//   second grid axis keeps the card full where a cell shard is narrow.
//   The chunks do not depend on the lane count, so a lane's bits do not
//   either; a cell chunk that divides a shard's extent makes K1s's
//   partials, gathered in shard order, the single-device launch's.
//   Every sum is in a fixed order, no atomic: two launches are
//   bit-identical.  On an H100 80GB HBM3 at 700 W
//   (tools/bench_sol_xpass.py): 1.42 ms at the 10x shape (13.6 TFLOP/s,
//   3,072 blocks), 0.367 ms on a 2,048-cell shard (768 blocks), where
//   512 x 512 chunks give 192 blocks and 0.464 ms.
// K1s, the per-shard X pass of the cell-sharded mesh, is this launch on
//   one cell shard: X's row stride ldx reads the shard's column window
//   of a larger X in place, and lh/eh are the shard's own.
// ---------------------------------------------------------------------
// ---------------------------------------------------------------------
// K2 sol_w_post / K3 sol_h_post: post_kernel of post.cuh on the factors
// in the (rank rows, long-axis columns) layout both sides share here.
// ---------------------------------------------------------------------

// ---------------------------------------------------------------------
// K4 sol_finish
//
// Replaces: _sol_kernel's last grid step (sol.py:302-324) and
//   _newton_scalar (sol.py:90-136): pend = -csum(ew').rsum(eh') - lgx
//   + U2 + U3 + the prior constants; dterm = -(DTW + DTH) + xlog; the
//   damped Newton of the gamma shapes with iterated halving, non-finite
//   steps zeroed, and a per-lane hyper mask.  Fed the partials of the
//   cell shards gathered in shard order, it is also the port of
//   ccfindr_tpu/ops/pallas/sol_sharded.py::_fin_kernel (:220).
// Bound: latency -- the partial sums' loads, then a few hundred
//   dependent scalar operations a lane (up to niter - 1 Newton steps).
// What held the first design back: one warp a lane made its 1 + 8 +
//   2 rp sums one after another (41 rounds of loads and a butterfly at
//   rp 16, 0.034 ms a launch at the 10x shape) before the Newton
//   started, and the redesigned posterior writes 8x more, narrower block
//   partials.
// Design: one block of kFinThreads a lane; sum j of the 9 + 2 rp (x log
//   wth, the 4 W and 4 H scalars, then csum_k and rsum_k for each k) is
//   one warp_strided_sum, in the first design's order, on warp j %
//   kFinWarps, so the warps make them at once, into shared memory.
//   Thread 0 then forms csum . rsum in k order, assembles the ELBO in
//   double and runs the Newton in the factor type, as the JAX kernel ran
//   it in its factor dtype: on the same partials every output slot has
//   the first design's bits.  At the 10x shape (H100 80GB HBM3, 700 W,
//   tools/bench_post.py) the sums take ~0.008 ms (0.013 one warp a
//   lane) and a launch ~0.025, the rest the Newton's 5-7 steps on one
//   thread.
// ---------------------------------------------------------------------
constexpr int kFinThreads = 512;
constexpr int kFinWarps = kFinThreads / 32;

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
__global__ void __launch_bounds__(kFinThreads)
finish_kernel(const double* __restrict__ sc,
              const double* __restrict__ xlog_part, int nx,
              const double* __restrict__ csum_part,
              const double* __restrict__ wscal_part, int nbw,
              const double* __restrict__ rsum_part,
              const double* __restrict__ hscal_part, int nbh, int rp, int n,
              int m, int mask, int niter, double tol,
              double* __restrict__ scal) {
  __shared__ double sums[9 + 2 * kMaxRp];
  const int b = blockIdx.x, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const double* scb = sc + b * 8;
  // sum j: 0 x log wth, 1-4 the W scalars, 5-8 the H scalars, then
  // csum_k (9 + 2k) and rsum_k (10 + 2k)
  for (int j = w; j < 9 + 2 * rp; j += kFinWarps) {
    const double* p;
    int count, stride;
    if (j == 0) {
      p = xlog_part + (size_t)b * nx;
      count = nx;
      stride = 1;
    } else if (j < 5) {
      p = wscal_part + (size_t)b * nbw * 4 + (j - 1);
      count = nbw;
      stride = 4;
    } else if (j < 9) {
      p = hscal_part + (size_t)b * nbh * 4 + (j - 5);
      count = nbh;
      stride = 4;
    } else if ((j - 9) % 2 == 0) {
      p = csum_part + (size_t)b * nbw * rp + (j - 9) / 2;
      count = nbw;
      stride = rp;
    } else {
      p = rsum_part + (size_t)b * nbh * rp + (j - 9) / 2;
      count = nbh;
      stride = rp;
    }
    const double v = warp_strided_sum(p, count, stride, lane);
    if (lane == 0) sums[j] = v;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const double xlog = sums[0];
  double ws[4], hs[4];
  for (int q = 0; q < 4; ++q) {
    ws[q] = sums[1 + q];
    hs[q] = sums[5 + q];
  }
  double cr = 0.0;
  for (int k = 0; k < rp; ++k) cr += sums[9 + 2 * k] * sums[10 + 2 * k];

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
template <typename T, typename XT, bool kBf16>
cudaError_t launch_sol_xpass(const void* x, size_t ldx, const void* lwt,
                             const void* lh, const void* eh, const double* sc,
                             int B, int np, int mp, int rp, int gchunk,
                             int cchunk, void* swn_part, void* shn_part,
                             double* xlog_part, double* ehs_part,
                             cudaStream_t stream) {
  return launch_xpass_walk<T, XT, true, kBf16, true, true>(
      x, ldx, lwt, lh, B, np, mp, rp, gchunk, cchunk, swn_part, shn_part,
      xlog_part, sc, eh, ehs_part, stream);
}

}  // namespace ccfindr

using namespace ccfindr;

// C interface, bound with ctypes by ccfindr_tpu_torch/ops/kernels/sol.py.
// tcode: factor type 0 float, 1 double.  xcode: X type 0 int8, 1 int16,
// 2 float, 3 double.  bf16: round the X pass's operands to bf16.  ldx:
// X's row stride (mp for a whole X).  Each returns cudaGetLastError()
// after its launch.
extern "C" {

// gchunk, cchunk: the genes and cells a K1 block covers (sol.CHUNK).
int sol_xpass(int tcode, int xcode, int bf16, const void* x,
              const void* lwt, const void* lh, const void* eh,
              const double* sc, int B, int np, int mp, int ldx, int rp,
              int gchunk, int cchunk, void* swn_part, void* shn_part,
              double* xlog_part, double* ehs_part, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rp > kMaxRp || ldx < mp) return static_cast<int>(cudaErrorInvalidValue);
#define XPASS(T, XT)                                                       \
  return static_cast<int>(                                                 \
      bf16 ? launch_sol_xpass<T, XT, true>(x, (size_t)ldx, lwt, lh, eh, sc, \
                                           B, np, mp, rp, gchunk, cchunk,  \
                                           swn_part, shn_part, xlog_part,  \
                                           ehs_part, s)                    \
           : launch_sol_xpass<T, XT, false>(x, (size_t)ldx, lwt, lh, eh,   \
                                            sc, B, np, mp, rp, gchunk,     \
                                            cchunk, swn_part, shn_part,    \
                                            xlog_part, ehs_part, s))
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
  return post_entry(tcode, swn_part, ncc, lwt, ehs_part, nehs, sc, 0, B,
                    np, rp, r, n, n, ewt, lwtn, dwt, csum_part, wscal_part,
                    stream);
}

// m_live: the live cells, m_pin (>= m_live): the extent whose rank rows
// below r are pinned at fudge past m_live (mesh cell padding).  K3s, the
// H posterior of a cell shard (with K2 on the gathered swn partials,
// the port of sol_sharded.py::_epi_kernel, :149), is this entry on the
// shard's shn partials and lh with the shard-relative extents.
int sol_h_post(int tcode, const void* shn_part, int ngc, const void* lh,
               const double* csum_part, int nbw, const double* sc, int B,
               int mp, int rp, int r, int m_live, int m_pin, void* ehn,
               void* lhn, void* dhn, double* rsum_part, double* hscal_part,
               void* stream) {
  return post_entry(tcode, shn_part, ngc, lh, csum_part, nbw, sc, 2, B,
                    mp, rp, r, m_live, m_pin, ehn, lhn, dhn, rsum_part,
                    hscal_part, stream);
}

int sol_finish(int tcode, const double* sc, const double* xlog_part, int nx,
               const double* csum_part, const double* wscal_part, int nbw,
               const double* rsum_part, const double* hscal_part, int nbh,
               int B, int rp, int n, int m, int mask, int niter, double tol,
               double* scal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tcode == 0)
    finish_kernel<float><<<B, kFinThreads, 0, s>>>(sc, xlog_part, nx, csum_part,
                                          wscal_part, nbw, rsum_part,
                                          hscal_part, nbh, rp, n, m, mask,
                                          niter, tol, scal);
  else if (tcode == 1)
    finish_kernel<double><<<B, kFinThreads, 0, s>>>(sc, xlog_part, nx, csum_part,
                                           wscal_part, nbw, rsum_part,
                                           hscal_part, nbh, rp, n, m, mask,
                                           niter, tol, scal);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
