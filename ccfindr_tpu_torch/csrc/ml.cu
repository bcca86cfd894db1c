// The maximum-likelihood (Lee-Seung KL) passes on Hopper: the two Pallas
// kernels of ccfindr_tpu/ops/pallas/ml_kernels.py as CUDA.
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
// w (B, n, r); h (B, r, m); hn (B, r, m); wn (B, n, r); r <= 128.  There
// is no padding: a block masks the ragged edge of its strip itself, so
// the TPU padding contract (X 0, W rows 1, H columns 1, rank rows 0) has
// no counterpart here.  A lane's masked rank rows [rank, r) hold eps and
// enter wh (eps^2 an element) like any other row, as on the TPU.
//
// Products are FP32 (or FP64) FMAs in the factor type, never TF32;
// x / wh is an exact IEEE division and log is the exact libdevice log
// (no fast-math build).  Where x is 0, a = 0 and x*log(wh) = 0 exactly,
// so those elements skip wh altogether: the results are the same.

#include <cuda_runtime.h>

#include <cstdint>

#include "reduce.cuh"

namespace ccfindr {

constexpr int kMlSub = 64;       // genes x cells of a shared-memory subtile
constexpr int kMlThreads = 256;  // M1/M2 block size
constexpr int kMlWarps = kMlThreads / 32;
constexpr int kMlMaxR = 128;     // largest rank
constexpr int kMlU = kMlSub + 1;  // odd stride of a_s: conflict-free columns

// a = x / (w h) over one kMlSub x kMlSub subtile into a_s (0 outside the
// gn x cn corner and where x is 0); returns this thread's sum of
// x*log(wh) when ``xlog`` is set.  w_s and h_s hold the subtile's
// factors rank-major (w_s[k * kMlSub + i], h_s[k * kMlSub + j]).
template <typename T, typename XT, bool kXlog>
__device__ __forceinline__ double ratio_subtile(
    const XT* __restrict__ x, int m, int g0, int gn, int c0, int cn, int r,
    const T* w_s, const T* h_s, T* a_s) {
  double xl = 0.0;
  for (int e = threadIdx.x; e < kMlSub * kMlSub; e += kMlThreads) {
    // a warp shares i and walks 32 consecutive cells: w_s broadcasts,
    // h_s and X are read at consecutive addresses
    const int i = e / kMlSub, j = e % kMlSub;
    T a = T(0);
    if (i < gn && j < cn) {
      const T xv = static_cast<T>(x[(size_t)(g0 + i) * m + c0 + j]);
      if (xv != T(0)) {
        T wh = T(0);
        for (int k = 0; k < r; ++k)
          wh = fma(w_s[k * kMlSub + i], h_s[k * kMlSub + j], wh);
        a = xv / wh;
        if (kXlog) xl += static_cast<double>(xv * log(wh));
      }
    }
    a_s[i * kMlU + j] = a;
  }
  return xl;
}

// ---------------------------------------------------------------------
// M1 ml_hpass
//
// Replaces: ml_kernels.py:39 _ml_h_kernel: hn = w^T (x / wh) and
//   sum x*log(wh) for the same (w, h).
// Bound: 2 r FMAs an element for wh and 2 r for hn against 1-8 bytes of
//   X -- at r = 16 and int8 X that is 64 flops a byte, so the FP32 pipes
//   (here: shared-memory operand traffic, two loads an FMA), not HBM,
//   are the roof of this simple kernel.
// Design: a block owns one lane's strip of kMlSub cells and walks all n
//   genes in kMlSub subtiles, so hn needs no cross-block sum: its r x
//   kMlSub entries accumulate in shared memory, each owned by one thread,
//   and are written once.  The strip's h slice is staged once; w's
//   subtile rows are contiguous in (B, n, r) and load coalesced.  Only
//   the x*log(wh) sum crosses blocks: one double partial a block; the
//   lane's last block to finish adds them in block order (reduce.cuh
//   lane_tail_sum: one warp, lane-strided, then the butterfly).
// ---------------------------------------------------------------------
template <typename T, typename XT>
__global__ void __launch_bounds__(kMlThreads)
ml_hpass_kernel(const XT* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ h, int n, int m, int r,
                T* __restrict__ hn, double* __restrict__ xlog_part,
                unsigned* __restrict__ tickets, double* __restrict__ xlog) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);  // r x kMlSub
  T* h_s = w_s + r * kMlSub;                // r x kMlSub
  T* acc_s = h_s + r * kMlSub;              // r x kMlSub
  T* a_s = acc_s + r * kMlSub;              // kMlSub x kMlU
  __shared__ double red[kMlWarps];

  const int blk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int c0 = blk * kMlSub, cn = min(kMlSub, m - c0);
  const T* w_b = w + (size_t)b * n * r;
  const T* h_b = h + (size_t)b * r * m;
  const int nsub = r * kMlSub;
  for (int e = tid; e < nsub; e += kMlThreads) {
    const int k = e / kMlSub, j = e % kMlSub;
    h_s[e] = j < cn ? h_b[(size_t)k * m + c0 + j] : T(0);
    acc_s[e] = T(0);
  }

  double xl = 0.0;
  for (int g0 = 0; g0 < n; g0 += kMlSub) {
    const int gn = min(kMlSub, n - g0);
    __syncthreads();  // readers of the previous w_s / a_s are done
    for (int e = tid; e < gn * r; e += kMlThreads) {
      const int i = e / r, k = e % r;
      w_s[k * kMlSub + i] = w_b[(size_t)g0 * r + e];
    }
    __syncthreads();
    xl += ratio_subtile<T, XT, true>(x, m, g0, gn, c0, cn, r, w_s, h_s, a_s);
    __syncthreads();
    // hn entry (k, j) += sum over the subtile's genes; a warp shares k
    for (int e = tid; e < nsub; e += kMlThreads) {
      const int k = e / kMlSub, j = e % kMlSub;
      T s = T(0);
      for (int i = 0; i < gn; ++i)
        s = fma(w_s[k * kMlSub + i], a_s[i * kMlU + j], s);
      acc_s[e] += s;
    }
  }
  // each acc_s entry is owned by one thread throughout: no barrier
  for (int e = tid; e < nsub; e += kMlThreads) {
    const int k = e / kMlSub, j = e % kMlSub;
    if (j < cn) hn[((size_t)b * r + k) * m + c0 + j] = acc_s[e];
  }
  const double xs = block_sum(xl, red);
  if (tid == 0) xlog_part[(size_t)b * gridDim.x + blk] = xs;
  lane_tail_sum(xlog_part + (size_t)b * gridDim.x, gridDim.x, tickets + b,
                xlog + b);
}

// ---------------------------------------------------------------------
// M2 ml_wpass
//
// Replaces: ml_kernels.py:64 _ml_w_kernel: wn = (x / wh) h^T for the
//   updated h.
// Bound: as M1 (2 r + 2 r FMAs an element).
// Design: the transpose of M1: a block owns one lane's strip of kMlSub
//   genes and walks all m cells in kMlSub subtiles; the strip's w slice
//   is staged once, wn's r x kMlSub entries accumulate in shared memory
//   (one owner thread each) and are written once, row-contiguous in
//   (B, n, r).  No cross-block sum.
// ---------------------------------------------------------------------
template <typename T, typename XT>
__global__ void __launch_bounds__(kMlThreads)
ml_wpass_kernel(const XT* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ h, int n, int m, int r,
                T* __restrict__ wn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);  // r x kMlSub
  T* h_s = w_s + r * kMlSub;                // r x kMlSub
  T* acc_s = h_s + r * kMlSub;              // r x kMlSub
  T* a_s = acc_s + r * kMlSub;              // kMlSub x kMlU

  const int blk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int g0 = blk * kMlSub, gn = min(kMlSub, n - g0);
  const T* w_b = w + (size_t)b * n * r;
  const T* h_b = h + (size_t)b * r * m;
  const int nsub = r * kMlSub;
  for (int e = tid; e < nsub; e += kMlThreads) acc_s[e] = T(0);
  for (int e = tid; e < gn * r; e += kMlThreads) {
    const int i = e / r, k = e % r;
    w_s[k * kMlSub + i] = w_b[(size_t)g0 * r + e];
  }

  for (int c0 = 0; c0 < m; c0 += kMlSub) {
    const int cn = min(kMlSub, m - c0);
    __syncthreads();  // readers of the previous h_s / a_s are done
    for (int e = tid; e < nsub; e += kMlThreads) {
      const int k = e / kMlSub, j = e % kMlSub;
      h_s[e] = j < cn ? h_b[(size_t)k * m + c0 + j] : T(0);
    }
    __syncthreads();
    ratio_subtile<T, XT, false>(x, m, g0, gn, c0, cn, r, w_s, h_s, a_s);
    __syncthreads();
    // wn entry (i, k) += sum over the subtile's cells; a warp shares k
    // and reads a_s down a column (odd stride: no bank conflicts)
    for (int e = tid; e < nsub; e += kMlThreads) {
      const int k = e / kMlSub, i = e % kMlSub;
      T s = T(0);
      for (int j = 0; j < cn; ++j)
        s = fma(a_s[i * kMlU + j], h_s[k * kMlSub + j], s);
      acc_s[e] += s;
    }
  }
  __syncthreads();  // acc_s is read across owners below
  for (int e = tid; e < gn * r; e += kMlThreads) {
    const int i = e / r, k = e % r;
    wn[((size_t)b * n + g0) * r + e] = acc_s[k * kMlSub + i];
  }
}

// ---------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------
template <typename T>
size_t ml_smem(int r) {
  return (size_t)(3 * r * kMlSub + kMlSub * kMlU) * sizeof(T);
}

template <typename T, typename XT>
cudaError_t launch_hpass(const void* x, const void* w, const void* h, int B,
                         int n, int m, int r, void* hn, double* xlog_part,
                         unsigned* tickets, double* xlog,
                         cudaStream_t stream) {
  const dim3 grid(ceil_div(m, kMlSub), B);
  const size_t smem = ml_smem<T>(r);
  cudaError_t err = cudaFuncSetAttribute(
      ml_hpass_kernel<T, XT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ml_hpass_kernel<T, XT><<<grid, kMlThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const T*>(w),
      static_cast<const T*>(h), n, m, r, static_cast<T*>(hn), xlog_part,
      tickets, xlog);
  return cudaGetLastError();
}

template <typename T, typename XT>
cudaError_t launch_wpass(const void* x, const void* w, const void* h, int B,
                         int n, int m, int r, void* wn, cudaStream_t stream) {
  const dim3 grid(ceil_div(n, kMlSub), B);
  const size_t smem = ml_smem<T>(r);
  cudaError_t err = cudaFuncSetAttribute(
      ml_wpass_kernel<T, XT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ml_wpass_kernel<T, XT><<<grid, kMlThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const T*>(w),
      static_cast<const T*>(h), n, m, r, static_cast<T*>(wn));
  return cudaGetLastError();
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

// xlog_part (B, ceil(m / 64)) the per-block partials; tickets (B) the
// lanes' counters, 0 before and after; xlog (B) each lane's sum.
int ml_hpass(int tcode, int xcode, const void* x, const void* w,
             const void* h, int B, int n, int m, int r, void* hn,
             double* xlog_part, unsigned* tickets, double* xlog,
             void* stream) {
  if (r < 1 || r > kMlMaxR) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ML_DISPATCH(launch_hpass, x, w, h, B, n, m, r, hn, xlog_part, tickets,
              xlog, s)
}

int ml_wpass(int tcode, int xcode, const void* x, const void* w,
             const void* h, int B, int n, int m, int r, void* wn,
             void* stream) {
  if (r < 1 || r > kMlMaxR) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ML_DISPATCH(launch_wpass, x, w, h, B, n, m, r, wn, s)
}

#undef ML_DISPATCH

}  // extern "C"
