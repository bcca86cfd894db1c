// The sparse capacity passes on Hopper: the Pallas tile kernel of
// ccfindr_tpu/ops/tile.py as two CUDA kernels over a CSR layout.
//
//   S1 sp_rowpass  per gene row g of one lane b, at each nonzero (c, x)
//                  of the row: wth = lw[b,g,:] . lh[b,:,c] (an SDDMM),
//                  a = x / wth; then swn[b,g,:] += a lh[b,:,c] (an
//                  SpMM), a into a (B, nnz) buffer in CSR order, and
//                  one double partial of x*log(wth) a block
//   S2 sp_colpass  per cell column c of one lane b, over the CSC view of
//                  the same nonzeros: shn[b,:,c] = sum a lw[b,g,:], a
//                  read through the CSC -> CSR permutation
//
// M3 ml_xlog_sum (ml.cu) adds S1's partials in block order.  The phases
// map onto them as: VB sweep S1 (swn, a, xlog) + S2 + M3; ML H phase
// S1 (a, xlog) + S2 + M3; ML W phase S1 (swn).
//
// Replaces: ccfindr_tpu/ops/tile.py:348 _tile_kernel (with _tile_pass,
//   fused_tile, tile_ml_h, tile_ml_w).  The TPU kernel expanded
//   fixed-width slot blocks into dense VMEM tiles for the MXU, packed
//   (col << 16 | val) into int32, kept a COO overflow tail and a Kahan
//   sum in SMEM across its sequential grid; none of that is carried.
// Bound: the gathers.  Each nonzero, lane and pass reads one row of lh
//   (S1) or lw (S2), 4 r bytes in float32, at a data-dependent address
//   (served mostly from L2: the factors of a lane are a few MB), against
//   2 r FMAs: a few flops a byte, far below the card's FP32 roof.
// Design: each nonzero's index and value are read once a pass, 32 at a
//   time by one coalesced load of the warp and handed out by shuffles;
//   S2 reads a once more, also coalesced by chunk.  A group of G lanes
//   (G = 4, 8, 16 or 32 from r) holds one factor row in registers, so a
//   warp takes 32 / G nonzeros at once and a row's gather is one
//   contiguous G-lane load.  swn and shn accumulate in registers and are
//   written once; a warp owns its row (S1) or cell (S2), so no sum
//   crosses blocks except x*log(wth).  No atomics: two launches are
//   bit-identical.
//
// Layouts (row-major, leading lane axis B): indptr (n+1) int64 and col
// (nnz) int32, val (nnz) int16/float/double: the CSR; colptr (m+1)
// int64, rowc (nnz) int32 and perm (nnz) int32: the CSC's row index and
// the CSR position of each CSC position; lw (B, n, r); lht (B, m, r) --
// lh transposed, so a cell's row is contiguous; swn (B, n, r); a
// (B, nnz); shn (B, r, m); do_elbo (B) double; r <= 128.  An empty row
// or column gets zeros.  Offsets into the (B, nnz) buffer are 64-bit.
//
// Arithmetic is FP32 (or FP64) FMAs in the factor type, exact IEEE
// division and the exact libdevice log (no fast-math build).  As in the
// JAX package's COO and tile paths, a non-positive wth is replaced by 1.
// kBf16 is the tile kernel's mxu_bf16 (precision='bf16', ccfindr_tpu/
// ops/tile.py:398-452): S1 rounds the gathered lw row and lh column to
// bf16 before forming wth and rounds a = x/wth after the division (the
// rounded a is what it sums and stores); S2 sums the rounded a against
// the rounded lw row.  Sums and log(wth) stay in the factor type
// (bf16.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "bf16.cuh"
#include "reduce.cuh"

namespace ccfindr {

constexpr int kSpThreads = 256;            // S1/S2 block size
constexpr int kSpWarps = kSpThreads / 32;  // rows (S1) or cells (S2) a block
constexpr int kSpMaxR = 128;               // largest rank
constexpr unsigned kFull = 0xffffffffu;

// Lanes of a group that holds one factor row: the smallest of 4, 8, 16,
// 32 that covers r, so a group lane holds one component up to r = 32 and
// four at r = 128.
inline int group_of(int r) { return r <= 4 ? 4 : r <= 8 ? 8 : r <= 16 ? 16 : 32; }

// ---------------------------------------------------------------------
// S1 sp_rowpass
// ---------------------------------------------------------------------
template <typename T, typename XT, int G, bool kBf16>
__global__ void __launch_bounds__(kSpThreads)
sp_rowpass_kernel(const int64_t* __restrict__ indptr,
                  const int* __restrict__ col, const XT* __restrict__ val,
                  const T* __restrict__ lw, const T* __restrict__ lht,
                  const double* __restrict__ do_elbo, int n, int m, int r,
                  int64_t nnz, T* __restrict__ swn, T* __restrict__ abuf,
                  double* __restrict__ part) {
  constexpr int NG = 32 / G;                  // nonzeros a warp takes at once
  constexpr int KP = G == 32 ? kSpMaxR / 32 : 1;  // components a lane holds
  __shared__ double red[kSpWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % G, grp = lane / G;
  const int b = blockIdx.y;
  const int g = blockIdx.x * kSpWarps + warp;
  const bool xlog = part != nullptr && do_elbo[b] > 0.0;
  double xl = 0.0;

  if (g < n) {  // warp-uniform
    const T* lw_g = lw + ((size_t)b * n + g) * r;
    const T* lh_b = lht + (size_t)b * m * r;
    T w[KP], acc[KP];
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const int k = sub + j * G;
      w[j] = k < r ? operand<kBf16>(lw_g[k]) : T(0);
      acc[j] = T(0);
    }
    const int64_t p_end = indptr[g + 1];
    for (int64_t p0 = indptr[g]; p0 < p_end; p0 += 32) {
      // one coalesced load of up to 32 nonzeros, handed out by shuffles
      const int64_t pl = p0 + lane;
      const bool mine = pl < p_end;
      const int c_l = mine ? col[pl] : 0;
      const T x_l = mine ? static_cast<T>(val[pl]) : T(0);
      const int cnt = static_cast<int>(p_end - p0 < 32 ? p_end - p0 : 32);
      T a_mine = T(0);
#pragma unroll 4
      for (int q = 0; q < cnt; q += NG) {  // warp-uniform trip count
        const int t = q + grp;             // the chunk slot of this group
        const bool live = t < cnt;
        const int c = __shfl_sync(kFull, c_l, t);
        const T xv = __shfl_sync(kFull, x_l, t);
        T lh[KP];
        T s = T(0);
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          const int k = sub + j * G;
          lh[j] = (live && k < r) ? operand<kBf16>(lh_b[(size_t)c * r + k])
                                  : T(0);
          s = fma(w[j], lh[j], s);
        }
        // the group's dot product: a butterfly inside G lanes leaves
        // the same sum in each of them
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
        const T wth = s > T(0) ? s : T(1);
        const T a = live ? operand<kBf16>(xv / wth) : T(0);
#pragma unroll
        for (int j = 0; j < KP; ++j) acc[j] = fma(a, lh[j], acc[j]);
        if (xlog && live && sub == 0) xl += static_cast<double>(xv * log(wth));
        // slot lane's ratio moves to lane `lane`, for one coalesced store
        const T a_t = __shfl_sync(kFull, a, (lane % NG) * G);
        if (lane / NG == q / NG) a_mine = a_t;
      }
      if (abuf != nullptr && mine) abuf[(size_t)b * nnz + pl] = a_mine;
    }
    // the groups' partial rows, summed in a fixed butterfly order
#pragma unroll
    for (int o = 16; o >= G; o >>= 1)
#pragma unroll
      for (int j = 0; j < KP; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], o);
    if (swn != nullptr && grp == 0) {
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        const int k = sub + j * G;
        if (k < r) swn[((size_t)b * n + g) * r + k] = acc[j];
      }
    }
  }
  if (part != nullptr) {
    const double xs = block_sum(xl, red);
    if (threadIdx.x == 0) part[(size_t)b * gridDim.x + blockIdx.x] = xs;
  }
}

// ---------------------------------------------------------------------
// S2 sp_colpass
// ---------------------------------------------------------------------
template <typename T, int G, bool kBf16>
__global__ void __launch_bounds__(kSpThreads)
sp_colpass_kernel(const int64_t* __restrict__ colptr,
                  const int* __restrict__ rowc, const int* __restrict__ perm,
                  const T* __restrict__ abuf, const T* __restrict__ lw, int n,
                  int m, int r, int64_t nnz, T* __restrict__ shn) {
  constexpr int NG = 32 / G;
  constexpr int KP = G == 32 ? kSpMaxR / 32 : 1;
  __shared__ T stage[kSpMaxR * kSpWarps];  // the block's shn columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % G, grp = lane / G;
  const int b = blockIdx.y;
  const int c = blockIdx.x * kSpWarps + warp;
  T acc[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) acc[j] = T(0);

  if (c < m) {  // warp-uniform
    const T* a_b = abuf + (size_t)b * nnz;
    const T* lw_b = lw + (size_t)b * n * r;
    const int64_t q_end = colptr[c + 1];
    for (int64_t q0 = colptr[c]; q0 < q_end; q0 += 32) {
      const int64_t ql = q0 + lane;
      const bool mine = ql < q_end;
      const int g_l = mine ? rowc[ql] : 0;
      const T a_l = mine ? a_b[perm[ql]] : T(0);
      const int cnt = static_cast<int>(q_end - q0 < 32 ? q_end - q0 : 32);
#pragma unroll 4
      for (int q = 0; q < cnt; q += NG) {
        const int t = q + grp;
        const bool live = t < cnt;
        const int g = __shfl_sync(kFull, g_l, t);
        const T a = __shfl_sync(kFull, a_l, t);
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          const int k = sub + j * G;
          if (live && k < r)
            acc[j] = fma(a, operand<kBf16>(lw_b[(size_t)g * r + k]), acc[j]);
        }
      }
    }
#pragma unroll
    for (int o = 16; o >= G; o >>= 1)
#pragma unroll
      for (int j = 0; j < KP; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], o);
  }
  // stage the block's kSpWarps columns, then write each rank row's
  // stretch of consecutive cells together
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const int k = sub + j * G;
      if (k < r) stage[k * kSpWarps + warp] = acc[j];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < r * kSpWarps; e += kSpThreads) {
    const int k = e / kSpWarps;
    const int cc = blockIdx.x * kSpWarps + e % kSpWarps;
    if (cc < m) shn[((size_t)b * r + k) * m + cc] = stage[e];
  }
}

// ---------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------
template <typename T, typename XT, int G, bool kBf16>
cudaError_t launch_rowpass(const int64_t* indptr, const int* col,
                           const void* val, const void* lw, const void* lht,
                           const double* do_elbo, int B, int n, int m, int r,
                           int64_t nnz, void* swn, void* abuf, double* part,
                           cudaStream_t stream) {
  const dim3 grid(ceil_div(n, kSpWarps), B);
  sp_rowpass_kernel<T, XT, G, kBf16><<<grid, kSpThreads, 0, stream>>>(
      indptr, col, static_cast<const XT*>(val), static_cast<const T*>(lw),
      static_cast<const T*>(lht), do_elbo, n, m, r, nnz,
      static_cast<T*>(swn), static_cast<T*>(abuf), part);
  return cudaGetLastError();
}

template <typename T, typename XT, bool kBf16>
cudaError_t rowpass_any_g(const int64_t* indptr, const int* col,
                          const void* val, const void* lw, const void* lht,
                          const double* do_elbo, int B, int n, int m, int r,
                          int64_t nnz, void* swn, void* abuf, double* part,
                          cudaStream_t s) {
#define S1G(G)                                                            \
  return launch_rowpass<T, XT, G, kBf16>(indptr, col, val, lw, lht,       \
                                         do_elbo, B, n, m, r, nnz, swn,   \
                                         abuf, part, s)
  switch (group_of(r)) {
    case 4: S1G(4);
    case 8: S1G(8);
    case 16: S1G(16);
    default: S1G(32);
  }
#undef S1G
}

template <typename T, int G, bool kBf16>
cudaError_t launch_colpass(const int64_t* colptr, const int* rowc,
                           const int* perm, const void* abuf, const void* lw,
                           int B, int n, int m, int r, int64_t nnz, void* shn,
                           cudaStream_t stream) {
  const dim3 grid(ceil_div(m, kSpWarps), B);
  sp_colpass_kernel<T, G, kBf16><<<grid, kSpThreads, 0, stream>>>(
      colptr, rowc, perm, static_cast<const T*>(abuf),
      static_cast<const T*>(lw), n, m, r, nnz, static_cast<T*>(shn));
  return cudaGetLastError();
}

template <typename T, bool kBf16>
cudaError_t colpass_any_g(const int64_t* colptr, const int* rowc,
                          const int* perm, const void* abuf, const void* lw,
                          int B, int n, int m, int r, int64_t nnz, void* shn,
                          cudaStream_t s) {
#define S2G(G)                                                             \
  return launch_colpass<T, G, kBf16>(colptr, rowc, perm, abuf, lw, B, n, m, \
                                     r, nnz, shn, s)
  switch (group_of(r)) {
    case 4: S2G(4);
    case 8: S2G(8);
    case 16: S2G(16);
    default: S2G(32);
  }
#undef S2G
}

}  // namespace ccfindr

using namespace ccfindr;

// C interface, bound with ctypes by ccfindr_tpu_torch/ops/kernels/sparse.py.
// tcode: factor type 0 float, 1 double.  xcode: value type 1 int16,
// 2 float, 3 double (the codes of ml.cu; int8 is not taken).  bf16: 1
// for the mxu_bf16 rounding.  swn, abuf and part may each be null, which
// skips that output.  Each returns cudaGetLastError() after its launch.
extern "C" {

int sp_rowpass(int tcode, int xcode, int bf16, const int64_t* indptr,
               const int* col, const void* val, const void* lw,
               const void* lht, const double* do_elbo, int B, int n, int m,
               int r, int64_t nnz, void* swn, void* abuf, double* part,
               void* stream) {
  if (r < 1 || r > kSpMaxR) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SP_ROW(T, XT)                                                       \
  return static_cast<int>(                                                 \
      bf16 ? rowpass_any_g<T, XT, true>(indptr, col, val, lw, lht, do_elbo, \
                                        B, n, m, r, nnz, swn, abuf, part, s) \
           : rowpass_any_g<T, XT, false>(indptr, col, val, lw, lht,         \
                                         do_elbo, B, n, m, r, nnz, swn,     \
                                         abuf, part, s))
  switch (tcode * 4 + xcode) {
    case 1: SP_ROW(float, int16_t);
    case 2: SP_ROW(float, float);
    case 3: SP_ROW(float, double);
    case 5: SP_ROW(double, int16_t);
    case 6: SP_ROW(double, float);
    case 7: SP_ROW(double, double);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SP_ROW
}

int sp_colpass(int tcode, int bf16, const int64_t* colptr, const int* rowc,
               const int* perm, const void* abuf, const void* lw, int B,
               int n, int m, int r, int64_t nnz, void* shn, void* stream) {
  if (r < 1 || r > kSpMaxR) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SP_COL(T)                                                          \
  return static_cast<int>(                                                \
      bf16 ? colpass_any_g<T, true>(colptr, rowc, perm, abuf, lw, B, n, m, \
                                    r, nnz, shn, s)                        \
           : colpass_any_g<T, false>(colptr, rowc, perm, abuf, lw, B, n, m, \
                                     r, nnz, shn, s))
  switch (tcode) {
    case 0: SP_COL(float);
    case 1: SP_COL(double);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SP_COL
}

}  // extern "C"
