// Fixed-order reductions shared by the kernels of sol.cu and ml.cu.
//
// No atomics anywhere: a sum across a warp is a butterfly, a sum across
// a block goes through one shared slot a warp, and a sum across blocks
// goes through per-block partials that a later kernel adds in a fixed
// order.  So every kernel of the package is deterministic run to run.

#pragma once

#include <cuda_runtime.h>

namespace ccfindr {

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // the same value in every lane
}

// Sum over the block; the result is valid in thread 0.  Every thread
// must call it; ``red`` holds one double a warp.
__device__ __forceinline__ double block_sum(double v, double* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// Sum of p[0], p[stride], ..., p[(count-1)*stride] by one warp: lane-
// strided partial sums, then the butterfly.  Every lane gets the sum.
__device__ __forceinline__ double warp_strided_sum(const double* p, int count,
                                                   int stride, int lane) {
  double s = 0.0;
  for (int i = lane; i < count; i += 32) s += p[(size_t)i * stride];
  return warp_sum(s);
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace ccfindr
