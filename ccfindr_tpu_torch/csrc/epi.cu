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

#include "bf16.cuh"
#include "post.cuh"
#include "reduce.cuh"

namespace ccfindr {

constexpr int kXSub = 64;            // E1 subtile edge (genes and cells)
constexpr int kXLd = kXSub + 1;      // odd row stride: conflict-free reads
constexpr int kXThreads = 256;       // E1 / E1s block size
constexpr int kXWarps = kXThreads / 32;

// ---------------------------------------------------------------------
// E1 fused_xpass
//
// Replaces: _fused_gm_kernel (vb_kernels.py:326, layout 'gm') and
//   _fused_cm_kernel (:280, layout 'cm'): for each lane wth = lw lh,
//   u = x / wth, swn = u lh^T (B, np, rp), shn = lw^T u (B, rp, mp),
//   and xlog = sum x log(wth) in double.  kBf16 is their mxu_bf16:
//   lw and lh are rounded to bf16 before the products and u after the
//   division (bf16.cuh); sums and log(wth) stay in the factor type.
// Bound: the FP32 pipes -- 3 products of 2*rp flops an X element and
//   lane (6*rp): at 100,000 x 4,096, rp 16, 39 GFLOP a lane a sweep,
//   >= 0.59 ms a lane at 67 TFLOP/s, against 0.41 GB of int8 X read
//   (0.12 ms at 3.35 TB/s).
// Design: a block owns one chunk of the outer axis of one lane and
//   walks the whole inner axis in 64 x 64 subtiles staged in shared
//   memory (the lw and lh slices, u).
//   * 'gm' (outer = genes): the chunk's swn rows accumulate in shared
//     memory across all cells and leave complete; shn of each cell
//     subtile is summed over the chunk's genes into the block's own
//     slice of the per-gene-chunk partial (B, ngc, rp, mp).
//   * 'cm' (outer = cells), the dual: the chunk's shn columns stay on
//     chip across all genes; swn leaves as per-cell-chunk partials
//     (B, ncc, np, rp).
//   The partial's slice is read-modify-written by its owning thread
//   only.  The wrapper sizes the chunk (512 and up by doubling) so the
//   partials stay below the bytes of X: at the 'gm' shape above, 6
//   lanes of rp 16 in float32, 196 chunks of 512 genes give
//   6 * 196 * 16 * 4,096 * 4 B = 0.31 GB against 0.41 GB of int8 X.
// ---------------------------------------------------------------------
template <typename T, typename XT, bool kGM, bool kBf16>
__global__ void __launch_bounds__(kXThreads)
fused_xpass_kernel(const XT* __restrict__ x, const T* __restrict__ lw,
                   const T* __restrict__ lh, int np, int mp, int rp,
                   int chunk, T* __restrict__ full, T* __restrict__ part,
                   double* __restrict__ xlog_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* lw_s = reinterpret_cast<T*>(smem_raw);  // rp x kXLd, [k][gene]
  T* lh_s = lw_s + rp * kXLd;                // rp x kXLd, [k][cell]
  T* acc_s = lh_s + rp * kXLd;               // rp * kXSub (see below)
  T* u_s = acc_s + rp * kXSub;               // kXSub x kXLd, [gene][cell]
  __shared__ double red[kXWarps];

  const int o = blockIdx.x, b = blockIdx.y, nchunk = gridDim.x;
  const int tid = threadIdx.x;
  const T* lw_b = lw + (size_t)b * np * rp;
  const T* lh_b = lh + (size_t)b * rp * mp;
  const int nsub = rp * kXSub;
  const int o_begin = o * chunk;
  const int o_end = min(o_begin + chunk, kGM ? np : mp);
  const int i_end = kGM ? mp : np;  // the inner axis, walked whole
  double xl = 0.0;

  // lw rows g0.. (row-major, k fastest: a coalesced read)
  auto load_lw = [&](int g0, int gn) {
    for (int e = tid; e < nsub; e += kXThreads) {
      const int i = e / rp, k = e % rp;
      lw_s[k * kXLd + i] =
          i < gn ? operand<kBf16>(lw_b[(size_t)(g0 + i) * rp + k]) : T(0);
    }
  };
  auto load_lh = [&](int c0, int cn) {
    for (int e = tid; e < nsub; e += kXThreads) {
      const int k = e / kXSub, j = e % kXSub;
      lh_s[k * kXLd + j] =
          j < cn ? operand<kBf16>(lh_b[(size_t)k * mp + c0 + j]) : T(0);
    }
  };
  // u for the staged subtiles; 0 outside the ragged edge
  auto form_u = [&](int g0, int gn, int c0, int cn) {
    for (int e = tid; e < kXSub * kXSub; e += kXThreads) {
      const int i = e / kXSub, j = e % kXSub;
      T u = T(0);
      if (i < gn && j < cn) {
        T w = T(0);
        for (int k = 0; k < rp; ++k)
          w = fma(lw_s[k * kXLd + i], lh_s[k * kXLd + j], w);
        const T xv = static_cast<T>(x[(size_t)(g0 + i) * mp + c0 + j]);
        u = operand<kBf16>(xv / w);
        xl += static_cast<double>(xv * log(w));
      }
      u_s[i * kXLd + j] = u;
    }
  };
  // shn entry (k, j) of the subtile, summed over its genes
  auto shn_entry = [&](int k, int j, int gn) {
    T s = T(0);
    for (int i = 0; i < gn; ++i)
      s = fma(lw_s[k * kXLd + i], u_s[i * kXLd + j], s);
    return s;
  };
  // swn entry (i, k) of the subtile, summed over its cells
  auto swn_entry = [&](int i, int k, int cn) {
    T s = T(0);
    for (int j = 0; j < cn; ++j)
      s = fma(u_s[i * kXLd + j], lh_s[k * kXLd + j], s);
    return s;
  };

  if constexpr (kGM) {
    // acc_s holds the gene subtile's swn as [gene][k]
    for (int g0 = o_begin; g0 < o_end; g0 += kXSub) {
      const int gn = min(kXSub, o_end - g0);
      __syncthreads();  // readers of the previous lw_s are done
      load_lw(g0, gn);
      for (int e = tid; e < nsub; e += kXThreads) acc_s[e] = T(0);
      for (int c0 = 0; c0 < i_end; c0 += kXSub) {
        const int cn = min(kXSub, i_end - c0);
        __syncthreads();  // readers of the previous lh_s / u_s are done
        load_lh(c0, cn);
        __syncthreads();
        form_u(g0, gn, c0, cn);
        __syncthreads();
        T* shn_b = part + ((size_t)b * nchunk + o) * rp * mp;
        for (int e = tid; e < nsub; e += kXThreads) {
          const int k = e / kXSub, j = e % kXSub;
          if (j < cn) {
            const T s = shn_entry(k, j, gn);
            T* dst = shn_b + (size_t)k * mp + c0 + j;
            *dst = (g0 == o_begin) ? s : *dst + s;
          }
        }
        for (int e = tid; e < nsub; e += kXThreads) {
          const int i = e / rp, k = e % rp;
          if (i < gn) acc_s[e] += swn_entry(i, k, cn);
        }
      }
      // each acc_s entry is owned by one thread throughout: no barrier
      T* swn_b = full + ((size_t)b * np + g0) * rp;
      for (int e = tid; e < nsub; e += kXThreads)
        if (e / rp < gn) swn_b[e] = acc_s[e];
    }
  } else {
    // acc_s holds the cell subtile's shn as [k][cell]
    for (int c0 = o_begin; c0 < o_end; c0 += kXSub) {
      const int cn = min(kXSub, o_end - c0);
      __syncthreads();  // readers of the previous lh_s are done
      load_lh(c0, cn);
      for (int e = tid; e < nsub; e += kXThreads) acc_s[e] = T(0);
      for (int g0 = 0; g0 < i_end; g0 += kXSub) {
        const int gn = min(kXSub, i_end - g0);
        __syncthreads();  // readers of the previous lw_s / u_s are done
        load_lw(g0, gn);
        __syncthreads();
        form_u(g0, gn, c0, cn);
        __syncthreads();
        for (int e = tid; e < nsub; e += kXThreads) {
          const int k = e / kXSub, j = e % kXSub;
          if (j < cn) acc_s[e] += shn_entry(k, j, gn);
        }
        T* swn_b = part + (((size_t)b * nchunk + o) * np + g0) * rp;
        for (int e = tid; e < nsub; e += kXThreads) {
          const int i = e / rp, k = e % rp;
          if (i < gn) {
            const T s = swn_entry(i, k, cn);
            T* dst = swn_b + e;
            *dst = (c0 == o_begin) ? s : *dst + s;
          }
        }
      }
      // each acc_s entry is owned by one thread throughout: no barrier
      T* shn_b = full + (size_t)b * rp * mp;
      for (int e = tid; e < nsub; e += kXThreads) {
        const int k = e / kXSub, j = e % kXSub;
        if (j < cn) shn_b[(size_t)k * mp + c0 + j] = acc_s[e];
      }
    }
  }

  const double xs = block_sum(xl, red);
  if (tid == 0) xlog_part[(size_t)b * nchunk + o] = xs;
}

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
template <typename T, typename XT, bool kGM, bool kBf16>
cudaError_t launch_fused_xpass(const void* x, const void* lw, const void* lh,
                               int B, int np, int mp, int rp, int chunk,
                               void* full, void* part, double* xlog_part,
                               cudaStream_t stream) {
  const dim3 grid(ceil_div(kGM ? np : mp, chunk), B);
  const size_t smem =
      (size_t)(2 * rp * kXLd + rp * kXSub + kXSub * kXLd) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      fused_xpass_kernel<T, XT, kGM, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_xpass_kernel<T, XT, kGM, kBf16><<<grid, kXThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const T*>(lw),
      static_cast<const T*>(lh), np, mp, rp, chunk, static_cast<T*>(full),
      static_cast<T*>(part), xlog_part);
  return cudaGetLastError();
}

template <typename T, typename XT>
cudaError_t fused_xpass_x(int gm, int bf16, const void* x, const void* lw,
                          const void* lh, int B, int np, int mp, int rp,
                          int chunk, void* full, void* part,
                          double* xlog_part, cudaStream_t s) {
#define E1(GM, BF)                                                        \
  return launch_fused_xpass<T, XT, GM, BF>(x, lw, lh, B, np, mp, rp, chunk, \
                                           full, part, xlog_part, s)
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
