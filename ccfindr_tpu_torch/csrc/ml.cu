// The maximum-likelihood (Lee-Seung KL) passes on Hopper: the two Pallas
// kernels of ccfindr_tpu/ops/pallas/ml_kernels.py as two walks of the X
// pass template (fused.cuh) without its streamed output (kStr = false).
//
//   M1 ml_hpass     hn = w^T (x / wh) and each lane's sum of x*log(wh):
//                   per-block partials, which the lane's last block adds
//                   in block order (reduce.cuh lane_tail_sum; the TPU
//                   kernel kept a Kahan-summed SMEM scalar)
//   M2 ml_wpass     wn = (x / wh) h^T
//
// A sweep runs M1 on (w, h) and M2 on (w, h') with h' the updated
// H, so wh is formed twice: the W pass needs the new H.  The
// multiplicative updates between the passes (h * hn + pn) / (colSums w +
// pd), the eps clamp and the rank mask stay torch ops in
// ccfindr_tpu_torch/ops/ml.py, as they stayed XLA ops around the Pallas
// kernels in ccfindr_tpu/ops/ml.py.
//
// Layouts (row-major, leading lane axis B where the JAX package used
// vmap): X (n, m) of int8/int16/float/double, shared by every lane;
// w (B, n, r); h (B, r, m); hn (B, r, m); wn (B, n, r); r <= 128.  These
// are the walk's own: w is E1's rank-minor lw (B, np, rp), h its lh, hn
// the rank-major resident output of layout 'cm' and wn the rank-minor
// one of 'gm'.  There is no padding: the walk masks the ragged edges
// itself, so the TPU padding contract (X 0, W rows 1, H columns 1, rank
// rows 0) has no counterpart here.  A lane's masked rank rows [rank, r)
// hold eps and enter wh (eps^2 an element) like any other row, as on the
// TPU.
//
// Products are FP32 (or FP64) FMAs in the factor type, never TF32;
// x / wh is div_rn, the IEEE division's bits, with the division itself
// outside div_rn's range, and log is the exact libdevice log (no
// fast-math build).  Where x is 0, u = 0 and x*log(wh) adds a zero: the
// sums are those of the elements where x is not 0.
//
// ---------------------------------------------------------------------
// M1 ml_hpass
//
// Replaces: ml_kernels.py:39 _ml_h_kernel: hn = w^T (x / wh) and
//   sum x*log(wh) for the same (w, h).
// Bound: the FP32 pipes -- 2 r FMAs an element for wh and 2 r for hn
//   (4 r flops an element and lane) against 1-8 bytes of X: at r = 16
//   and int8 X, 64 flops a byte.  Beside the products, an element costs
//   a division and a log.
// Design: the walk in layout 'cm': a block owns kMlHChunk cells of one
//   lane and walks all n genes in 64 x 64 steps of 4 x 4 register tiles
//   (cp.async double buffer); hn is the resident output, a component
//   summed over a half-warp by shuffles a step and added to the chunk's
//   rows in shared memory, written once.  Only the x*log(wh) sum crosses
//   blocks: one double partial a block, added by the lane's last block.
//
// M2 ml_wpass
//
// Replaces: ml_kernels.py:64 _ml_w_kernel: wn = (x / wh) h^T for the
//   updated h.
// Bound: as M1 without the log (4 r flops an element and lane).
// Design: the walk in layout 'gm': a block owns kMlWChunk genes of one
//   lane and walks all m cells; wn is the resident output, rank-minor as
//   (B, n, r) wants it.  No cross-block sum.
//
// The chunks are constants (ops/kernels/ml.py H_CHUNK, W_CHUNK), never
// derived from the lane count, so a lane's bits do not depend on the
// batch it runs in: what checkpoint/resume and lane compaction rely on.
// ---------------------------------------------------------------------

#include <cuda_runtime.h>

#include <cstdint>

#include "fused.cuh"

namespace ccfindr {

constexpr int kMlMaxR = 128;     // largest rank
constexpr int kMlHChunk = 64;    // cells an M1 block owns (ml.py H_CHUNK)
constexpr int kMlWChunk = 64;    // genes an M2 block owns (ml.py W_CHUNK)

template <typename T, typename XT>
cudaError_t launch_hpass(const void* x, const void* w, const void* h, int B,
                         int n, int m, int r, int chunk, void* hn,
                         double* xlog_part, unsigned* tickets, double* xlog,
                         cudaStream_t stream) {
  return launch_xpass_walk<T, XT, false, false, true, false, false>(
      x, (size_t)m, w, h, B, n, m, r, chunk, n, hn, nullptr, xlog_part,
      nullptr, nullptr, nullptr, stream, tickets, xlog);
}

template <typename T, typename XT>
cudaError_t launch_wpass(const void* x, const void* w, const void* h, int B,
                         int n, int m, int r, int chunk, void* wn,
                         cudaStream_t stream) {
  return launch_xpass_walk<T, XT, true, false, false, false, false>(
      x, (size_t)m, w, h, B, n, m, r, chunk, m, wn, nullptr, nullptr,
      nullptr, nullptr, nullptr, stream);
}

}  // namespace ccfindr

using namespace ccfindr;

// C interface, bound with ctypes by ccfindr_tpu_torch/ops/kernels/ml.py.
// tcode: factor type 0 float, 1 double.  xcode: X type 0 int8, 1 int16,
// 2 float, 3 double.  Each returns cudaGetLastError() after its launch.
extern "C" {

#define ML_DISPATCH(LAUNCH, ...)                                  \
  switch (tcode * 4 + xcode) {                                    \
    case 0: return static_cast<int>(LAUNCH<float, int8_t>(__VA_ARGS__));   \
    case 1: return static_cast<int>(LAUNCH<float, int16_t>(__VA_ARGS__));  \
    case 2: return static_cast<int>(LAUNCH<float, float>(__VA_ARGS__));    \
    case 3: return static_cast<int>(LAUNCH<float, double>(__VA_ARGS__));   \
    case 4: return static_cast<int>(LAUNCH<double, int8_t>(__VA_ARGS__));  \
    case 5: return static_cast<int>(LAUNCH<double, int16_t>(__VA_ARGS__)); \
    case 6: return static_cast<int>(LAUNCH<double, float>(__VA_ARGS__));   \
    case 7: return static_cast<int>(LAUNCH<double, double>(__VA_ARGS__));  \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }

// xlog_part (B, ceil(m / kMlHChunk)) the per-block partials; tickets (B)
// the lanes' counters, 0 before and after; xlog (B) each lane's sum.
int ml_hpass(int tcode, int xcode, const void* x, const void* w,
             const void* h, int B, int n, int m, int r, void* hn,
             double* xlog_part, unsigned* tickets, double* xlog,
             void* stream) {
  if (r < 1 || r > kMlMaxR) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ML_DISPATCH(launch_hpass, x, w, h, B, n, m, r, kMlHChunk, hn, xlog_part,
              tickets, xlog, s)
}

int ml_wpass(int tcode, int xcode, const void* x, const void* w,
             const void* h, int B, int n, int m, int r, void* wn,
             void* stream) {
  if (r < 1 || r > kMlMaxR) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ML_DISPATCH(launch_wpass, x, w, h, B, n, m, r, kMlWChunk, wn, s)
}

#undef ML_DISPATCH

}  // extern "C"
