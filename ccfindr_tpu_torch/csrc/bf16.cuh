// bfloat16 rounding of the X-pass operands (precision='bf16').
//
// The JAX package's mxu_bf16 option casts the three products' operands
// to bf16 and accumulates in the factor type (ccfindr_tpu/ops/pallas/
// sol.py:218-234, vb_kernels.py:302-307).  Here the operands are
// rounded to the nearest bf16 (ties to even) and kept in the factor
// type, so every product of two rounded operands is exact in float and
// the sums accumulate as before.  A double is rounded to float first,
// as PyTorch's .to(torch.bfloat16) does, which the plain versions use.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace ccfindr {

__device__ __forceinline__ float round_bf16(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return v;  // NaN stays NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ double round_bf16(double v) {
  return static_cast<double>(round_bf16(static_cast<float>(v)));
}

// The operand as the products take it: rounded under bf16, else as is.
template <bool kBf16, typename T>
__device__ __forceinline__ T operand(T v) {
  if constexpr (kBf16) return round_bf16(v);
  return v;
}

// The same at a nonzero that ``keep`` may exempt: the sparse passes
// leave the operands of the JAX tile layout's overflow tail unrounded,
// as its bf16 mode does (ccfindr_tpu/ops/tile.py:611-621).
template <bool kBf16, typename T>
__device__ __forceinline__ T operand(T v, bool keep) {
  if constexpr (kBf16) return keep ? v : round_bf16(v);
  return v;
}

}  // namespace ccfindr
