// E1s fused_sum: the fixed-order sum of the X pass's per-chunk partials
// (epi.cu binds it for E1 and P1; tools/bench_fused_sum.py times its
// variants).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "reduce.cuh"

namespace ccfindr {

// ---------------------------------------------------------------------
// E1s fused_sum
//
// Replaces: the sum over chunks that _fused_gm_kernel (ccfindr_tpu/ops/
//   pallas/vb_kernels.py:326) kept in VMEM across its sequential grid:
//   out[b, e] = sum_p part[b, p, e] for e < L, in double in the order
//   p = 0, 1, ..., rounded once to the factor type; the last block
//   column adds each lane's xlog partials (one warp).
// Bound: bytes -- the partials, read once (at 100,000 x 4,096, 3 lanes
//   of rp 16 and E1's chunk of 256 genes, 0.31 GB: 0.092 ms at
//   3.35 TB/s).
// Design: a thread owns kSumBytes of consecutive elements (2 floats or
//   1 double) and loads them as one vector from kSumUnroll consecutive
//   partials before it adds any, each element's sum still taken in
//   p order (the bits of the one-element chain).  Where the rows of the
//   partials are not aligned to the vector, or past the last whole
//   vector, a thread adds its elements one by one in the same order.
//   Blocks of 64 threads spread the threads evenly over the SMs.  On an
//   H100 80GB HBM3 at 700 W, at the shape above, in turns
//   (tools/bench_fused_sum.py): 0.1017 ms, 90.5% of the bound, against
//   0.1021 for one element a thread, 0.1055 for 16-byte loads (half the
//   warps in flight) and 0.1038 for Tensor.sum.
// ---------------------------------------------------------------------
constexpr int kSumThreads = 64;
constexpr int kSumUnroll = 8;
constexpr int kSumBytes = 8;

// kBytes of raw data, as the load instruction of that width takes it
template <int kBytes>
struct RawVec;
template <>
struct RawVec<16> {
  using type = int4;
};
template <>
struct RawVec<8> {
  using type = int2;
};
template <>
struct RawVec<4> {
  using type = int;
};

template <typename T, int kVec>
union VecOf {
  typename RawVec<kVec * sizeof(T)>::type raw;
  T v[kVec];
};

template <typename T, int kThreads, int kUnroll, int kVec>
__global__ void __launch_bounds__(kThreads)
fused_sum_kernel(const T* __restrict__ part, int P, int L, int vec,
                 const double* __restrict__ xlog_part, int Q,
                 T* __restrict__ out, double* __restrict__ xlog) {
  using Raw = typename RawVec<kVec * sizeof(T)>::type;
  const int b = blockIdx.y;
  if (blockIdx.x == gridDim.x - 1) {
    if (threadIdx.x < 32) {
      const double v = warp_strided_sum(xlog_part + (size_t)b * Q, Q, 1,
                                        threadIdx.x);
      if (threadIdx.x == 0) xlog[b] = v;
    }
    return;
  }
  const int e0 = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (e0 >= L) return;
  const T* src = part + (size_t)b * P * L + e0;
  double acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.0;
  if (vec && e0 + kVec <= L) {
    int p = 0;
    for (; p + kUnroll <= P; p += kUnroll) {
      VecOf<T, kVec> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u].raw =
            __ldg(reinterpret_cast<const Raw*>(src + (size_t)(p + u) * L));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          acc[i] += static_cast<double>(v[u].v[i]);
    }
    for (; p < P; ++p) {
      VecOf<T, kVec> v;
      v.raw = __ldg(reinterpret_cast<const Raw*>(src + (size_t)p * L));
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] += static_cast<double>(v.v[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (e0 + i < L)
        for (int p = 0; p < P; ++p)
          acc[i] += static_cast<double>(src[(size_t)p * L + i]);
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    if (e0 + i < L) out[(size_t)b * L + e0 + i] = static_cast<T>(acc[i]);
}

// One launch: part (B, P, L), xlog_part (B, Q); out (B, L), xlog (B,).
template <typename T, int kThreads = kSumThreads, int kUnroll = kSumUnroll,
          int kVec = static_cast<int>(kSumBytes / sizeof(T))>
cudaError_t launch_fused_sum(const T* part, int P, int L,
                             const double* xlog_part, int Q, int B, T* out,
                             double* xlog, cudaStream_t stream) {
  constexpr size_t kBytes = kVec * sizeof(T);
  const int vec = (static_cast<size_t>(L) * sizeof(T)) % kBytes == 0 &&
                  (reinterpret_cast<uintptr_t>(part) & (kBytes - 1)) == 0;
  const dim3 grid(ceil_div(L, kThreads * kVec) + 1, B);
  fused_sum_kernel<T, kThreads, kUnroll, kVec><<<grid, kThreads, 0, stream>>>(
      part, P, L, vec, xlog_part, Q, out, xlog);
  return cudaGetLastError();
}

}  // namespace ccfindr
