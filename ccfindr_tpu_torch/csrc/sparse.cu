// The sparse capacity passes on Hopper: the Pallas tile kernel of
// ccfindr_tpu/ops/tile.py as two CUDA kernels over a CSR layout.
//
//   S1 sp_rowpass  per gene row g of one lane b, at each nonzero (c, x)
//                  of the row: wth = lw[b,g,:] . lh[b,:,c] (an SDDMM),
//                  a = x / wth; then swn[b,g,:] += a lh[b,:,c] (an
//                  SpMM), a into a (B, nnz) buffer in CSR order, and
//                  one double partial of x*log(wth) a block, which the
//                  lane's last block adds in block order
//                  (reduce.cuh lane_tail_sum)
//   S2 sp_colpass  per cell column c of one lane b, over the CSC view of
//                  the same nonzeros: shn[b,:,c] = sum a lw[b,g,:], a
//                  read through the CSC -> CSR permutation
//
// The phases map onto them as: VB sweep S1 (swn, a, xlog) + S2; ML H
// phase S1 (a, xlog) + S2; ML W phase S1 (swn).
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
// Design: each nonzero's index and value are read once a pass by one
//   coalesced load of a warp.  A warp owns a gene row (S1) or a cell
//   column (S2); at r <= 32 a thread takes one nonzero of it at a time
//   and that nonzero's whole factor row (S1), or RK / V threads take a
//   nonzero, each a 16-byte slice of its row (S2 where rows are 16-byte
//   aligned, see its note); above
//   32 a group walk, a warp a nonzero.  swn and shn accumulate in
//   registers and are written once; a warp owns its row or cell, so no
//   sum crosses blocks except x*log(wth).  No atomic in any sum (one
//   ticket a block picks the lane's adder): two launches are
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
// division (S1: fused.cuh's div_rn, the same bits) and the exact
// libdevice log (no fast-math build).  As in the
// JAX package's COO and tile paths, a non-positive wth is replaced by 1.
// kBf16 is the tile kernel's mxu_bf16 (precision='bf16', ccfindr_tpu/
// ops/tile.py:398-452): S1 rounds the gathered lw row and lh column to
// bf16 before forming wth and rounds a = x/wth after the division (the
// rounded a is what it sums and stores); S2 sums the rounded a against
// the rounded lw row.  Sums and log(wth) stay in the factor type
// (bf16.cuh).  tail (nnz) uint8, CSR order, may be null: under kBf16
// the nonzeros it flags keep every operand unrounded (wth, a, and the
// rows each sum takes), as the JAX kernel's COO overflow tail does
// (ccfindr_tpu/ops/tile.py:611-621, ops/ell.py _tail_scan); without
// kBf16 it is not read.

#include <cuda_runtime.h>

#include <cstdint>

#include "bf16.cuh"
#include "fused.cuh"  // div_ieee
#include "reduce.cuh"

namespace ccfindr {

constexpr int kSpThreads = 256;            // S1/S2 block size
constexpr int kSpWarps = kSpThreads / 32;  // rows (S1) or cells (S2) a block
constexpr int kSpMaxR = 128;               // largest rank
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------
// S1 sp_rowpass
//
// Replaces: the row side of ccfindr_tpu/ops/tile.py:348 _tile_kernel
//   (wth, a = x / wth, swn and x*log(wth) at the nonzeros; tile_ml_h's
//   a and x*log(wth), tile_ml_w's swn).
// Bound: the gathers -- at the 10x shape (4,096 x 8,192 at 10%, 2.57 M
//   nonzeros, r 16, float) each nonzero and lane reads one 64-byte lh row
//   at a random cell, 0.16 GB a lane from L2/L1 (a lane's lht is 0.5 MB),
//   against 4 r flops and one division and log: the same gathers S2
//   makes.  The device-memory bytes (CSR, a, swn) bound it far below.
// What held the group design (today the r > 32 kernel below) to 3x S2's
//   time: a group of G lanes held one lh row, so a warp took 32 / G
//   nonzeros a step, each paying two shuffles to hand out (c, x), a
//   log2 G butterfly of dependent shuffles for wth, a division in all G
//   lanes, a shuffle to place a, and a log in one lane of each group.
// Design (r <= 32, RK the rank rounded up to 4, 8, 16 or 32): a warp owns
//   a gene row and a thread one nonzero of it at a time, 32 a step, read
//   by one coalesced load of the warp.  The thread holds the row's lw in
//   registers and loads its cell's lh row as 16-byte vectors (element by
//   element where rows are not 16-byte aligned, as at r = 6), forms wth
//   with r FMAs of its own, divides with div_rn (the IEEE division's
//   bits; the division itself outside its range), adds a lh into its
//   own r-wide swn accumulator, stores its a (coalesced, CSR order) and
//   adds x log(wth) to its double.  No shuffle per nonzero: the warp's
//   accumulators are reduced once a row, a fixed-order reduce-scatter
//   (RK - 1 + log2(32 / RK) shuffles), and the lanes that hold a
//   component store it.
// Design (r > 32): the group design with G = 32, a lane holding 4 of up
//   to 128 components, kept as a second instantiation chosen by r in
//   the launcher: a thread-owned nonzero would hold 3 r registers (lw,
//   lh and swn rows: 384 at r = 128), past the card's 255, and a rank
//   slab walk would read the row's CSR and lh twice.  A warp still
//   takes one nonzero a step there, with a 5-shuffle butterfly for wth
//   over 4 r flops; ranks above 32 are outside the workflow's scans
//   (ranks 2..8 bundled, 8..16 at 10x, 16 on the atlas leg).
// Both: one double partial of x log(wth) a block (8 rows), added by the
//   lane's last block (reduce.cuh lane_tail_sum); every sum in a fixed
//   order, so two launches are bit-identical and a lane's bits do not
//   depend on its batch (a block is one lane's).
// ptxas -v (float factors, int16 values; chip_smoke.py phase 8 prints
//   it): RK 16 72 registers (3 blocks of 256 an SM), RK 32 125 (2), RK
//   8 54, RK 4 52, the group walk 54, 0 bytes of spills each; a cap of
//   64 registers (4 blocks) spills 20 bytes at RK 16 and runs 1-7%
//   slower (tools/bench_sparse_pass.py).
// ---------------------------------------------------------------------

// Components 0 .. RK - 1 of a factor row (or of a slice of one), 0 from
// r on, as the products take them: 16-byte loads where ``vec`` (r *
// sizeof(T) a multiple of 16 and the factor 16-byte aligned) and RK
// spans whole 16-byte chunks, else one element at a time.
template <int RK, bool kBf16, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int r,
                                         bool vec, T (&v)[RK],
                                         bool keep = false) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  bool loaded = false;
  if constexpr (RK % V == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < RK; k += V) {
        if (k < r) {
          if constexpr (sizeof(T) == 4) {
            const float4 t = *reinterpret_cast<const float4*>(p + k);
            v[k] = t.x, v[k + 1] = t.y, v[k + 2] = t.z, v[k + 3] = t.w;
          } else {
            const double2 t = *reinterpret_cast<const double2*>(p + k);
            v[k] = t.x, v[k + 1] = t.y;
          }
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[k + j] = T(0);
        }
      }
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int k = 0; k < RK; ++k) v[k] = k < r ? p[k] : T(0);
  }
#pragma unroll
  for (int k = 0; k < RK; ++k) v[k] = operand<kBf16>(v[k], keep);
}

// One step of warp_reduce_scatter and the steps after it: a lane keeps
// the half (H components) of v that its lane bit names and adds its
// partner's copy of that half, into v[0 .. H).
template <int RK, int H, typename T>
__device__ __forceinline__ void reduce_halves(T (&v)[RK], int lane) {
  if constexpr (H >= 1) {
    constexpr int o = 32 * H / RK;  // 16 at the first step
    const bool hi = lane & o;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const T keep = hi ? v[i + H] : v[i];
      const T send = hi ? v[i] : v[i + H];
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
    reduce_halves<RK, H / 2>(v, lane);
  }
}

// v[k] summed over the warp in a fixed order: a reduce-scatter, then a
// butterfly over the 32 / RK lanes left holding the same component.
// Returns component lane / (32 / RK), the same bits in each of those
// lanes.  RK - 1 + log2(32 / RK) shuffles.
template <int RK, typename T>
__device__ __forceinline__ T warp_reduce_scatter(T (&v)[RK], int lane) {
  reduce_halves<RK, RK / 2>(v, lane);
  T z = v[0];
#pragma unroll
  for (int o = 16 / RK; o > 0; o >>= 1) z += __shfl_xor_sync(kFull, z, o);
  return z;
}

template <typename T, typename XT, int RK, bool kBf16>
__global__ void __launch_bounds__(kSpThreads, sizeof(T) * RK <= 32    ? 4
                                              : sizeof(T) * RK <= 64  ? 3
                                              : sizeof(T) * RK <= 128 ? 2
                                                                      : 1)
sp_rowpass_kernel(const int64_t* __restrict__ indptr,
                  const int* __restrict__ col, const XT* __restrict__ val,
                  const uint8_t* __restrict__ tail,
                  const T* __restrict__ lw, const T* __restrict__ lht,
                  const double* __restrict__ do_elbo, int n, int m, int r,
                  int64_t nnz, bool vec, T* __restrict__ swn,
                  T* __restrict__ abuf, double* __restrict__ part,
                  unsigned* __restrict__ tickets,
                  double* __restrict__ xlog_sum) {
  static_assert(RK >= 4 && RK <= 32 && (RK & (RK - 1)) == 0, "RK");
  __shared__ double red[kSpWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int g = blockIdx.x * kSpWarps + warp;
  const bool xlog = part != nullptr && do_elbo[b] > 0.0;
  double xl = 0.0;

  if (g < n) {  // warp-uniform
    const T* lh_b = lht + (size_t)b * m * r;
    const T* lw_g = lw + ((size_t)b * n + g) * r;
    T w[RK], acc[RK];
    load_row<RK, kBf16>(lw_g, r, vec, w);
#pragma unroll
    for (int k = 0; k < RK; ++k) acc[k] = T(0);
    const int64_t p_beg = indptr[g], p_end = indptr[g + 1];
    // a step: nonzero p of the row for each thread (warp-uniform trips)
    for (int64_t p = p_beg + lane; p - lane < p_end; p += 32) {
      if (p < p_end) {
        const int c = col[p];
        const T xv = static_cast<T>(val[p]);
        const bool keep = kBf16 && tail != nullptr && tail[p] != 0;
        T h[RK];
        load_row<RK, kBf16>(lh_b + (size_t)c * r, r, vec, h, keep);
        T s = T(0);
        if (keep) {
          // a tail nonzero (rare): the row's lw unrounded, read again
          // (cached) rather than held beside the rounded copy
#pragma unroll
          for (int k = 0; k < RK; ++k)
            if (k < r) s = fma(lw_g[k], h[k], s);
        } else {
#pragma unroll
          for (int k = 0; k < RK; ++k) s = fma(w[k], h[k], s);
        }
        const T wth = s > T(0) ? s : T(1);
        const T a = operand<kBf16>(div_ieee(xv, wth), keep);
#pragma unroll
        for (int k = 0; k < RK; ++k) acc[k] = fma(a, h[k], acc[k]);
        if (abuf != nullptr) abuf[(size_t)b * nnz + p] = a;
        if (xlog) xl += static_cast<double>(xv * log(wth));
      }
    }
    const T z = warp_reduce_scatter(acc, lane);
    constexpr int kShare = 32 / RK;  // lanes holding one component
    const int k = lane / kShare;
    if (swn != nullptr && lane % kShare == 0 && k < r)
      swn[((size_t)b * n + g) * r + k] = z;
  }
  if (part != nullptr) {
    const double xs = block_sum(xl, red);
    if (threadIdx.x == 0) part[(size_t)b * gridDim.x + blockIdx.x] = xs;
    lane_tail_sum(part + (size_t)b * gridDim.x, gridDim.x, tickets + b,
                  xlog_sum + b);
  }
}

// r > 32: a warp a nonzero, lane sub holding components sub + 32 j
template <typename T, typename XT, bool kBf16>
__global__ void __launch_bounds__(kSpThreads)
sp_rowpass_group_kernel(const int64_t* __restrict__ indptr,
                        const int* __restrict__ col,
                        const XT* __restrict__ val,
                        const uint8_t* __restrict__ tail,
                        const T* __restrict__ lw,
                        const T* __restrict__ lht,
                        const double* __restrict__ do_elbo, int n, int m,
                        int r, int64_t nnz, T* __restrict__ swn,
                        T* __restrict__ abuf, double* __restrict__ part,
                        unsigned* __restrict__ tickets,
                        double* __restrict__ xlog_sum) {
  constexpr int KP = kSpMaxR / 32;  // components a lane holds
  __shared__ double red[kSpWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
      const int k = lane + 32 * j;
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
      const int k_l = kBf16 && mine && tail != nullptr && tail[pl] != 0;
      const int cnt = static_cast<int>(p_end - p0 < 32 ? p_end - p0 : 32);
      T a_mine = T(0);
#pragma unroll 4
      for (int t = 0; t < cnt; ++t) {
        const int c = __shfl_sync(kFull, c_l, t);
        const T xv = __shfl_sync(kFull, x_l, t);
        const bool keep = kBf16 && __shfl_sync(kFull, k_l, t) != 0;
        T lh[KP];
        T s = T(0);
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          const int k = lane + 32 * j;
          lh[j] = k < r ? operand<kBf16>(lh_b[(size_t)c * r + k], keep)
                        : T(0);
          // a tail nonzero (rare, warp-uniform): the row's lw unrounded,
          // read again (cached) rather than held beside the rounded copy
          s = fma(keep && k < r ? lw_g[k] : w[j], lh[j], s);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
        const T wth = s > T(0) ? s : T(1);
        const T a = operand<kBf16>(div_ieee(xv, wth), keep);
#pragma unroll
        for (int j = 0; j < KP; ++j) acc[j] = fma(a, lh[j], acc[j]);
        if (xlog && lane == 0) xl += static_cast<double>(xv * log(wth));
        if (lane == t) a_mine = a;
      }
      if (abuf != nullptr && mine) abuf[(size_t)b * nnz + pl] = a_mine;
    }
    if (swn != nullptr) {
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        const int k = lane + 32 * j;
        if (k < r) swn[((size_t)b * n + g) * r + k] = acc[j];
      }
    }
  }
  if (part != nullptr) {
    const double xs = block_sum(xl, red);
    if (threadIdx.x == 0) part[(size_t)b * gridDim.x + blockIdx.x] = xs;
    lane_tail_sum(part + (size_t)b * gridDim.x, gridDim.x, tickets + b,
                  xlog_sum + b);
  }
}

// ---------------------------------------------------------------------
// S2 sp_colpass
//
// Replaces: the column side of ccfindr_tpu/ops/tile.py:348 _tile_kernel
//   (shn = lw^T (X / wth) at the nonzeros, from the row pass's a).
// Bound: the gathers -- at the 10x shape each nonzero and lane reads
//   one 64-byte lw row at a random gene and one a at a random CSR
//   position (through perm), from L2 (a lane's lw is 0.26 MB, its a 10
//   MB), against 2 r flops: ~1.5 GB of 32-byte sectors from L2 a launch
//   for 6 lanes.  The device-memory bytes (CSC, perm, a once, shn) bound
//   it far below; on the atlas leg a (128 MB a lane) comes from device
//   memory.
// What held the earlier designs back (tools/bench_sparse_pass.py, H100):
//   the group walk (today the r > 32 kernel below: G lanes a row, 32 / G
//   nonzeros a step, (g, a) handed out by two shuffles a nonzero) spent
//   its issue slots on shuffles; S1's design on this side (a thread a
//   nonzero and its whole row, four 16-byte loads a nonzero at r 16 in
//   float, each touching 32 rows; bench variant s2_row) was faster at
//   10x but 10% slower than the group walk on the atlas leg.
// Design (r <= 32, RK the rank rounded up to 4, 8, 16 or 32): a warp
//   owns a cell column.  Where rows are 16-byte aligned (``vec``) kTpn =
//   RK / V threads share a nonzero, each a V-wide, 16-byte slice of its
//   lw row, so a warp takes 32 / kTpn nonzeros a step and each of its
//   loads covers whole rows (8 rows at r 16 in float).  Elsewhere (r =
//   6 in float) V = RK: a thread takes a nonzero and its whole row,
//   element by element, as S1 does.  Each thread reads its nonzero's
//   gene and CSR position (the kTpn threads of a nonzero read the same
//   words: one request), gathers a through perm and adds a times its
//   slice into its V accumulators: no shuffle a nonzero.  The 32 /
//   kTpn partial sums of a slice are added once a column by a fixed
//   butterfly, and the block's kSpWarps columns are staged in shared
//   memory and written a rank row at a time.
// Design (r > 32): the group walk with G = 32, a lane holding 4 of up to
//   128 components; a warp takes one nonzero a step there, handed out by
//   two shuffles (ranks above 32 are outside the workflow's scans).
// Both: a thread's nonzeros are added in CSC order, then the warp's in
//   a fixed order, so two launches are bit-identical and a lane's bits
//   do not depend on its batch (a block is one lane's).  Under kBf16
//   the gathered lw slice is rounded to bf16 and multiplied by the
//   already-rounded a; the sums stay in the factor type.
// ptxas -v (float factors; chip_smoke.py phase 8 prints r 16): 28
//   registers with 16-byte slices (RK 4 to 32), 32 to 46 with whole
//   rows a thread (RK 8, 16), the group walk 40, 0 bytes of spills each.
//   Reading a in CSC order instead of through perm (timing only, bench
//   variant s2_csc_a) takes 30% off at the 10x shape, 40% on the atlas
//   leg: the gather of a is a 32-byte sector for 4 bytes.
// ---------------------------------------------------------------------
template <typename T, int RK, int V, bool kBf16>
__global__ void __launch_bounds__(kSpThreads)
sp_colpass_kernel(const int64_t* __restrict__ colptr,
                  const int* __restrict__ rowc, const int* __restrict__ perm,
                  const uint8_t* __restrict__ tail,
                  const T* __restrict__ abuf, const T* __restrict__ lw, int n,
                  int m, int r, int64_t nnz, bool vec, T* __restrict__ shn) {
  static_assert(RK >= 4 && RK <= 32 && (RK & (RK - 1)) == 0, "RK");
  static_assert(V >= 1 && V <= RK && RK % V == 0, "V");
  constexpr int kTpn = RK / V;     // threads a nonzero
  constexpr int kNps = 32 / kTpn;  // nonzeros a step
  __shared__ T stage[RK * kSpWarps];  // the block's shn columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / kTpn, k0 = (lane % kTpn) * V;
  const int b = blockIdx.y;
  const int c = blockIdx.x * kSpWarps + warp;

  if (c < m) {  // warp-uniform
    const T* a_b = abuf + (size_t)b * nnz;
    const T* lw_b = lw + (size_t)b * n * r + k0;
    T acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = T(0);
    const int64_t q_beg = colptr[c], q_end = colptr[c + 1];
    // a step: nonzero q of the column for each slot (warp-uniform trips)
    for (int64_t q = q_beg + slot; q - slot < q_end; q += kNps) {
      if (q < q_end) {
        const int g = rowc[q];
        const int p = perm[q];
        const T a = a_b[p];
        const bool keep = kBf16 && tail != nullptr && tail[p] != 0;
        T w[V];
        load_row<V, kBf16>(lw_b + (size_t)g * r, r - k0, vec, w, keep);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = fma(a, w[j], acc[j]);
      }
    }
#pragma unroll
    for (int o = 16; o >= kTpn; o >>= 1)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], o);
    if (slot == 0) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (k0 + j < r) stage[(k0 + j) * kSpWarps + warp] = acc[j];
    }
  }
  // write each rank row's stretch of the block's consecutive cells
  __syncthreads();
  for (int e = threadIdx.x; e < r * kSpWarps; e += kSpThreads) {
    const int k = e / kSpWarps;
    const int cc = blockIdx.x * kSpWarps + e % kSpWarps;
    if (cc < m) shn[((size_t)b * r + k) * m + cc] = stage[e];
  }
}

// r > 32: a warp a nonzero, lane sub holding components sub + 32 j
template <typename T, bool kBf16>
__global__ void __launch_bounds__(kSpThreads)
sp_colpass_group_kernel(const int64_t* __restrict__ colptr,
                        const int* __restrict__ rowc,
                        const int* __restrict__ perm,
                        const uint8_t* __restrict__ tail,
                        const T* __restrict__ abuf, const T* __restrict__ lw,
                        int n, int m, int r, int64_t nnz,
                        T* __restrict__ shn) {
  constexpr int KP = kSpMaxR / 32;  // components a lane holds
  __shared__ T stage[kSpMaxR * kSpWarps];  // the block's shn columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
      // one coalesced load of up to 32 nonzeros, handed out by shuffles
      const int64_t ql = q0 + lane;
      const bool mine = ql < q_end;
      const int g_l = mine ? rowc[ql] : 0;
      const int p_l = mine ? perm[ql] : 0;
      const T a_l = mine ? a_b[p_l] : T(0);
      const int k_l = kBf16 && mine && tail != nullptr && tail[p_l] != 0;
      const int cnt = static_cast<int>(q_end - q0 < 32 ? q_end - q0 : 32);
#pragma unroll 4
      for (int t = 0; t < cnt; ++t) {
        const int g = __shfl_sync(kFull, g_l, t);
        const T a = __shfl_sync(kFull, a_l, t);
        const bool keep = kBf16 && __shfl_sync(kFull, k_l, t) != 0;
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          const int k = lane + 32 * j;
          if (k < r)
            acc[j] = fma(a, operand<kBf16>(lw_b[(size_t)g * r + k], keep),
                         acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const int k = lane + 32 * j;
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
template <typename T, typename XT, int RK, bool kBf16>
cudaError_t launch_rowpass(const int64_t* indptr, const int* col,
                           const void* val, const uint8_t* tail,
                           const void* lw, const void* lht,
                           const double* do_elbo, int B, int n, int m, int r,
                           int64_t nnz, void* swn, void* abuf, double* part,
                           unsigned* tickets, double* xlog,
                           cudaStream_t stream) {
  const dim3 grid(ceil_div(n, kSpWarps), B);
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  if constexpr (RK > 32) {
    sp_rowpass_group_kernel<T, XT, kBf16><<<grid, kSpThreads, 0, stream>>>(
        indptr, col, static_cast<const XT*>(val), tail,
        static_cast<const T*>(lw),
        static_cast<const T*>(lht), do_elbo, n, m, r, nnz,
        static_cast<T*>(swn), static_cast<T*>(abuf), part, tickets, xlog);
  } else {
    const bool vec = (r * sizeof(T)) % 16 == 0 && aligned(lw) && aligned(lht);
    sp_rowpass_kernel<T, XT, RK, kBf16><<<grid, kSpThreads, 0, stream>>>(
        indptr, col, static_cast<const XT*>(val), tail,
        static_cast<const T*>(lw),
        static_cast<const T*>(lht), do_elbo, n, m, r, nnz, vec,
        static_cast<T*>(swn), static_cast<T*>(abuf), part, tickets, xlog);
  }
  return cudaGetLastError();
}

// S1's instantiation by r: the thread-owned nonzero with RK = 4, 8, 16
// or 32 components, the group walk above 32
template <typename T, typename XT, bool kBf16>
cudaError_t rowpass_any_r(const int64_t* indptr, const int* col,
                          const void* val, const uint8_t* tail,
                          const void* lw, const void* lht,
                          const double* do_elbo, int B, int n, int m, int r,
                          int64_t nnz, void* swn, void* abuf, double* part,
                          unsigned* tickets, double* xlog, cudaStream_t s) {
#define S1R(RK)                                                           \
  return launch_rowpass<T, XT, RK, kBf16>(indptr, col, val, tail, lw, lht,\
                                          do_elbo, B, n, m, r, nnz, swn,  \
                                          abuf, part, tickets, xlog, s)
  if (r <= 4) S1R(4);
  if (r <= 8) S1R(8);
  if (r <= 16) S1R(16);
  if (r <= 32) S1R(32);
  S1R(kSpMaxR);
#undef S1R
}

template <typename T, int RK, bool kBf16>
cudaError_t launch_colpass(const int64_t* colptr, const int* rowc,
                           const int* perm, const uint8_t* tail,
                           const void* abuf, const void* lw,
                           int B, int n, int m, int r, int64_t nnz, void* shn,
                           cudaStream_t stream) {
  const dim3 grid(ceil_div(m, kSpWarps), B);
  if constexpr (RK > 32) {
    sp_colpass_group_kernel<T, kBf16><<<grid, kSpThreads, 0, stream>>>(
        colptr, rowc, perm, tail, static_cast<const T*>(abuf),
        static_cast<const T*>(lw), n, m, r, nnz, static_cast<T*>(shn));
  } else if ((r * sizeof(T)) % 16 == 0) {
    // 16-byte rows; the caller passes lw 16-byte aligned (this launch
    // refuses it otherwise), so the instantiation, and with it the
    // order of each sum, depends on r and T alone
    if ((reinterpret_cast<uintptr_t>(lw) & 15) != 0)
      return cudaErrorMisalignedAddress;
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    sp_colpass_kernel<T, RK, kVec, kBf16><<<grid, kSpThreads, 0, stream>>>(
        colptr, rowc, perm, tail, static_cast<const T*>(abuf),
        static_cast<const T*>(lw), n, m, r, nnz, true, static_cast<T*>(shn));
  } else {
    sp_colpass_kernel<T, RK, RK, kBf16><<<grid, kSpThreads, 0, stream>>>(
        colptr, rowc, perm, tail, static_cast<const T*>(abuf),
        static_cast<const T*>(lw), n, m, r, nnz, false,
        static_cast<T*>(shn));
  }
  return cudaGetLastError();
}

// S2's instantiation by r, as S1's: RK = 4, 8, 16 or 32 components a
// row, in 16-byte slices where rows are aligned, the group walk above 32
template <typename T, bool kBf16>
cudaError_t colpass_any_r(const int64_t* colptr, const int* rowc,
                          const int* perm, const uint8_t* tail,
                          const void* abuf, const void* lw,
                          int B, int n, int m, int r, int64_t nnz, void* shn,
                          cudaStream_t s) {
#define S2R(RK)                                                              \
  return launch_colpass<T, RK, kBf16>(colptr, rowc, perm, tail, abuf, lw, B, \
                                      n, m, r, nnz, shn, s)
  if (r <= 4) S2R(4);
  if (r <= 8) S2R(8);
  if (r <= 16) S2R(16);
  if (r <= 32) S2R(32);
  S2R(kSpMaxR);
#undef S2R
}

}  // namespace ccfindr

using namespace ccfindr;

// C interface, bound with ctypes by ccfindr_tpu_torch/ops/kernels/sparse.py.
// tcode: factor type 0 float, 1 double.  xcode: value type 1 int16,
// 2 float, 3 double (the codes of ml.cu; int8 is not taken).  bf16: 1
// for the mxu_bf16 rounding, tail (may be null) its exempt nonzeros.
// swn, abuf and part may each be null, which
// skips that output; with part, tickets (B, 0 before and after) and xlog
// (B, each lane's sum of the partials) are taken too.  Each returns
// cudaGetLastError() after its launch.
extern "C" {

int sp_rowpass(int tcode, int xcode, int bf16, const int64_t* indptr,
               const int* col, const void* val, const uint8_t* tail,
               const void* lw,
               const void* lht, const double* do_elbo, int B, int n, int m,
               int r, int64_t nnz, void* swn, void* abuf, double* part,
               unsigned* tickets, double* xlog, void* stream) {
  if (r < 1 || r > kSpMaxR) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SP_ROW(T, XT)                                                       \
  return static_cast<int>(                                                 \
      bf16 ? rowpass_any_r<T, XT, true>(indptr, col, val, tail, lw, lht,    \
                                        do_elbo, B, n, m, r, nnz, swn,      \
                                        abuf, part, tickets, xlog, s)       \
           : rowpass_any_r<T, XT, false>(indptr, col, val, nullptr, lw,     \
                                         lht, do_elbo, B, n, m, r, nnz,     \
                                         swn, abuf, part, tickets, xlog, s))
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
               const int* perm, const uint8_t* tail, const void* abuf,
               const void* lw, int B,
               int n, int m, int r, int64_t nnz, void* shn, void* stream) {
  if (r < 1 || r > kSpMaxR) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SP_COL(T)                                                          \
  return static_cast<int>(                                                \
      bf16 ? colpass_any_r<T, true>(colptr, rowc, perm, tail, abuf, lw, B, \
                                    n, m, r, nnz, shn, s)                  \
           : colpass_any_r<T, false>(colptr, rowc, perm, nullptr, abuf, lw, \
                                     B, n, m, r, nnz, shn, s))
  switch (tcode) {
    case 0: SP_COL(float);
    case 1: SP_COL(double);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SP_COL
}

}  // extern "C"
