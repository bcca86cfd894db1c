// The gene-major VB sweep on Hopper: the X pass of the JAX package's
// fused kernels and its posterior epilogues, in the JAX package's
// layouts (W row-major (B, np, rp), H (B, rp, mp), a leading lane axis
// B where it used vmap).
//
//   E1  fused_xpass  swn, shn and sum x*log(wth), one template for both
//                    loop orders: layout 'gm' replaces
//                    ccfindr_tpu/ops/pallas/vb_kernels.py:326
//                    _fused_gm_kernel, layout 'cm' :280 _fused_cm_kernel
//   E1s fused_sum    the fixed-order sum of E1's per-chunk partials
//   E2  epi_w_post   ccfindr_tpu/ops/pallas/epilogue.py:71
//                    _w_epilogue_kernel (post_kernel of post.cuh)
//   E3  epi_h_post   epilogue.py:134 _h_epilogue_kernel (the same)
//
// A sweep of the gene-major loop (ops/kernels/epilogue.py::vb_run_epi)
// is E1, E1s, E2, E3 and K4 sol_finish (sol.cu), which reads E2's and
// E3's partials.  There is no padding contract: the kernels mask ragged
// edges themselves.  Division is exact IEEE (the TPU kernels' approximate
// reciprocal, vb_kernels.py:45 _recip_mul, is not carried); products are
// FP32 (or FP64) FMAs, never TF32; no atomics: every cross-block sum
// goes through per-block partials added in a fixed order, so two
// launches are bit-identical.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused.cuh"
#include "post.cuh"
#include "reduce.cuh"

namespace ccfindr {

// ---------------------------------------------------------------------
// E1s fused_sum
//
// Adds E1's partials: out[b, e] = sum_p part[b, p, e] for e < L, in
// double in the order p = 0, 1, ..., rounded once to the factor type;
// the last block column adds each lane's xlog partials (one warp).
// What M3 ml_xlog_sum is to M1.  Bound: bytes (the partials, read
// once).
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kXThreads)
fused_sum_kernel(const T* __restrict__ part, int P, int L,
                 const double* __restrict__ xlog_part, int Q,
                 T* __restrict__ out, double* __restrict__ xlog) {
  const int b = blockIdx.y;
  if (blockIdx.x == gridDim.x - 1) {
    if (threadIdx.x < 32) {
      const double v = warp_strided_sum(xlog_part + (size_t)b * Q, Q, 1,
                                        threadIdx.x);
      if (threadIdx.x == 0) xlog[b] = v;
    }
    return;
  }
  const int e = blockIdx.x * kXThreads + threadIdx.x;
  if (e >= L) return;
  double acc = 0.0;
  for (int p = 0; p < P; ++p)
    acc += static_cast<double>(part[((size_t)b * P + p) * L + e]);
  out[(size_t)b * L + e] = static_cast<T>(acc);
}

// ---------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------
template <typename T, typename XT>
cudaError_t fused_xpass_x(int gm, int bf16, const void* x, const void* lw,
                          const void* lh, int B, int np, int mp, int rp,
                          int chunk, void* full, void* part,
                          double* xlog_part, cudaStream_t s) {
#define E1(GM, BF)                                                       \
  return launch_fused_xpass<T, XT, GM, BF>(x, (size_t)mp, lw, lh, B, np, mp, \
                                           rp, chunk, full, part, xlog_part, \
                                           s)
  if (gm) {
    if (bf16) E1(true, true);
    E1(true, false);
  }
  if (bf16) E1(false, true);
  E1(false, false);
#undef E1
}

}  // namespace ccfindr

using namespace ccfindr;

// C interface, bound with ctypes by ccfindr_tpu_torch/ops/kernels/
// vb_kernels.py (E1, E1s) and ops/kernels/epilogue.py (E2, E3).  tcode:
// factor type 0 float, 1 double.  xcode: X type 0 int8, 1 int16,
// 2 float, 3 double.  Each returns cudaGetLastError() after its launch.
extern "C" {

// gm: 1 for layout 'gm', 0 for 'cm'.  full: swn (B, np, rp) for 'gm',
// shn (B, rp, mp) for 'cm'; part: the other one's per-chunk partials.
int fused_xpass(int tcode, int xcode, int gm, int bf16, const void* x,
                const void* lw, const void* lh, int B, int np, int mp,
                int rp, int chunk, void* full, void* part,
                double* xlog_part, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rp > kMaxRp || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define E1X(T, XT)                                                        \
  return static_cast<int>(fused_xpass_x<T, XT>(gm, bf16, x, lw, lh, B, np, \
                                               mp, rp, chunk, full, part,  \
                                               xlog_part, s))
  switch (tcode * 4 + xcode) {
    case 0: E1X(float, int8_t);
    case 1: E1X(float, int16_t);
    case 2: E1X(float, float);
    case 3: E1X(float, double);
    case 4: E1X(double, int8_t);
    case 5: E1X(double, int16_t);
    case 6: E1X(double, float);
    case 7: E1X(double, double);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef E1X
}

int fused_sum(int tcode, const void* part, int P, int L,
              const double* xlog_part, int Q, int B, void* out, double* xlog,
              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(ceil_div(L, kXThreads) + 1, B);
  if (tcode == 0)
    fused_sum_kernel<float><<<grid, kXThreads, 0, s>>>(
        static_cast<const float*>(part), P, L, xlog_part, Q,
        static_cast<float*>(out), xlog);
  else if (tcode == 1)
    fused_sum_kernel<double><<<grid, kXThreads, 0, s>>>(
        static_cast<const double*>(part), P, L, xlog_part, Q,
        static_cast<double*>(out), xlog);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// E2: W (B, np, rp) row-major; ehs_part (B, nehs, rp) the partials of
// rowSums(eh); rows >= n are padding.
int epi_w_post(int tcode, const void* swn, const void* lw,
               const double* ehs_part, int nehs, const double* sc, int B,
               int np, int rp, int r, int n, void* ew, void* lwn, void* dw,
               double* csum_part, double* wscal_part, void* stream) {
  return post_entry<true>(tcode, swn, 1, lw, ehs_part, nehs, sc, 0, B, np,
                          rp, r, n, n, ew, lwn, dw, csum_part, wscal_part,
                          stream);
}

// E3: H (B, rp, mp); csum_part (B, nbw, rp) E2's colSums(ew') partials;
// cells in [m_live, m) are pinned at fudge, cells >= m are padding.
int epi_h_post(int tcode, const void* shn, const void* lh,
               const double* csum_part, int nbw, const double* sc, int B,
               int mp, int rp, int r, int m_live, int m, void* eh, void* lhn,
               void* dh, double* rsum_part, double* hscal_part,
               void* stream) {
  return post_entry<false>(tcode, shn, 1, lh, csum_part, nbw, sc, 2, B, mp,
                           rp, r, m_live, m, eh, lhn, dh, rsum_part,
                           hscal_part, stream);
}

}  // extern "C"
