// Fixed-order reductions shared by the kernels of the package.
//
// No atomic in any sum: a sum across a warp is a butterfly, a sum across
// a block goes through one shared slot a warp, and a sum across blocks
// goes through per-block partials added in a fixed order, by a later
// kernel or by the producer's last block of a lane (lane_tail_sum: one
// ticket counter a lane decides which block adds the partials, never the
// order of the addition).  So every kernel of the package is
// deterministic run to run.

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

// The tail of a producer that writes one double partial a block for
// each lane: call it with every thread of the block after thread 0 has
// written this block's partial.  Thread 0 takes a ticket from the lane's
// counter (the one atomic); the block that takes the lane's last ticket
// adds the lane's nblk partials part[0..nblk) as warp_strided_sum adds
// them (lane-strided, then the butterfly: the bits of a separate
// one-warp sum), writes *out and puts the counter back to 0 for the
// next launch.  The counters start at 0 (the wrappers allocate them
// zeroed, once a device and stream).
__device__ __forceinline__ void lane_tail_sum(const double* part, int nblk,
                                              unsigned* ticket,
                                              double* out) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();  // this block's partial is visible before its ticket
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(nblk - 1);
  }
  __syncthreads();
  if (last && threadIdx.x < 32) {
    __threadfence();
    double s = 0.0;  // __ldcg: the other blocks' partials, from L2
    for (int i = threadIdx.x; i < nblk; i += 32) s += __ldcg(part + i);
    s = warp_sum(s);
    if (threadIdx.x == 0) {
      *out = s;
      *ticket = 0u;
    }
  }
}

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

}  // namespace ccfindr
