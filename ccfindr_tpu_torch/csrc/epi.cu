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
//                    (sum.cuh)
//   E2  epi_w_post   ccfindr_tpu/ops/pallas/epilogue.py:71
//                    _w_epilogue_kernel (epi_w.cuh: a thread an entry
//                    of the row-major W)
//   E3  epi_h_post   epilogue.py:134 _h_epilogue_kernel (post_kernel of
//                    post.cuh)
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

#include "epi_w.cuh"
#include "epi_xpass.cuh"
#include "fused.cuh"
#include "post.cuh"
#include "reduce.cuh"
#include "sum.cuh"

namespace ccfindr {

// div_rn (fused.cuh) against the division on n samples: out[i] = 0
// where its fast path does not apply, 1 where it gives the division's
// bits, 2 where it does not (a self-test for the card).
__global__ void div_rn_check_kernel(const float* __restrict__ x,
                                    const float* __restrict__ w, int64_t n,
                                    unsigned char* __restrict__ out) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    bool fast;
    const float f = div_rn(x[i], w[i], fast);
    out[i] = !fast ? 0
                   : (__float_as_uint(f) == __float_as_uint(x[i] / w[i]) ? 1
                                                                         : 2);
  }
}

// E1's instantiations with double factors are compiled in epi_f64.cu:
// its 32 instantiations made this file the build's long pole (the kernels
// build one nvcc a source, all at once)
E1_EXTERN(extern, double)

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
  if (tcode == 0)
    return static_cast<int>(launch_fused_sum<float>(
        static_cast<const float*>(part), P, L, xlog_part, Q, B,
        static_cast<float*>(out), xlog, s));
  if (tcode == 1)
    return static_cast<int>(launch_fused_sum<double>(
        static_cast<const double*>(part), P, L, xlog_part, Q, B,
        static_cast<double*>(out), xlog, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// div_rn (fused.cuh) against the division on n float samples; out (n)
// uint8: 0 outside its fast path, 1 the same bits, 2 other bits.
int div_rn_check(const float* x, const float* w, int64_t n,
                 unsigned char* out, void* stream) {
  div_rn_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, n, out);
  return static_cast<int>(cudaGetLastError());
}

// E2: W (B, np, rp) row-major; ehs_part (B, nehs, rp) the partials of
// rowSums(eh); rows >= n are padding; csum_part and wscal_part one
// partial a block of kE2Cols genes (epi_w.cuh).
int epi_w_post(int tcode, const void* swn, const void* lw,
               const double* ehs_part, int nehs, const double* sc, int B,
               int np, int rp, int r, int n, void* ew, void* lwn, void* dw,
               double* csum_part, double* wscal_part, void* stream) {
  return epi_w_entry(tcode, swn, lw, ehs_part, nehs, sc, B, np, rp, r, n, ew,
                     lwn, dw, csum_part, wscal_part, stream);
}

// E3: H (B, rp, mp); csum_part (B, nbw, rp) E2's colSums(ew') partials;
// cells in [m_live, m) are pinned at fudge, cells >= m are padding.
int epi_h_post(int tcode, const void* shn, const void* lh,
               const double* csum_part, int nbw, const double* sc, int B,
               int mp, int rp, int r, int m_live, int m, void* eh, void* lhn,
               void* dh, double* rsum_part, double* hscal_part,
               void* stream) {
  return post_entry(tcode, shn, 1, lh, csum_part, nbw, sc, 2, B, mp, rp, r,
                    m_live, m, eh, lhn, dh, rsum_part, hscal_part, stream);
}

}  // extern "C"
