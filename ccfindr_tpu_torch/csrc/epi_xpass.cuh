// E1 fused_xpass's launcher by factor and X type (epi.cu), shared with
// epi_f64.cu, which compiles its double-factor instantiations.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "fused.cuh"

namespace ccfindr {

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

// fused_xpass_x<T, XT> for every X type, declared (extern) or defined
// (nothing) by explicit instantiation
#define E1_INSTANCE(EXT, T, XT)                                            \
  EXT template cudaError_t fused_xpass_x<T, XT>(                          \
      int, int, const void*, const void*, const void*, int, int, int, int, \
      int, void*, void*, double*, cudaStream_t);
#define E1_EXTERN(EXT, T)                                                  \
  E1_INSTANCE(EXT, T, int8_t)                                              \
  E1_INSTANCE(EXT, T, int16_t)                                             \
  E1_INSTANCE(EXT, T, float)                                               \
  E1_INSTANCE(EXT, T, double)

}  // namespace ccfindr
