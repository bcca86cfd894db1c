// E2 epi_w_post: the W gamma posterior of the gene-major sweep, on W
// in the JAX package's row-major layout (B, np, rp), a thread an entry.
//
// Replaces: ccfindr_tpu/ops/pallas/epilogue.py:71 _w_epilogue_kernel:
//   for each live entry (rank k < r_live, gene < n) al = a + lw swn,
//   be = 1 / (a/b + rowSums(eh)_k), e = al be, lwn = exp(psi(al)) be
//   floored at fudge, d = al be^2; the ELBO terms U, sum e, sum log l and
//   the dterm, and the rank sums colSums(ew) that E3 and K4 read.  The
//   zones are post.cuh's: ranks k < r outside the live zone are pinned
//   at fudge, padding is 1 (k < r) or 0, logl = log(fudge) where
//   ln_raw <= fudge.
// Bound: bytes or instructions, whichever the data makes larger.  A
//   live entry runs the digamma/lgamma shift chain (specials.cuh: in
//   float one IEEE division a step while its argument is below 6, at
//   most 6 steps, then three more divisions and two logs) and one exp
//   and one more log, against 20 bytes of device memory in float (swn
//   and lw read, e, lwn and d written).  At the gene-major shape
//   (100,000 genes, 3 lanes of rp 16) the 96 MB take 0.029 ms at 3.35
//   TB/s.  chip_smoke.py counts the instructions the live entries need
//   on its inputs from this kernel's SASS (Smoke.post_need: a count an
//   entry plus a count a shift step it takes) and prints the bound.
// What held post.cuh's layout back here: a thread owned a gene and
//   looped over its rp ranks, so each warp-wide load and store touched
//   32 rows rp words apart (at rp 16 in float, 32 sectors an
//   instruction where 4 would do, the three outputs written at one
//   eighth of their sector width), and each rank's colSums cost a
//   5-shuffle double butterfly in every thread.
// Design: a block owns kE2Cols genes of one lane; thread tid owns rank
//   k = tid % rp of genes j, j + gstep, ... (j = tid / rp, gstep = 256
//   / rp genes a step), so consecutive threads touch consecutive words
//   on every load and store; at an rp that does not divide 256 the last
//   256 % rp threads idle.  A thread keeps one double rank sum (its k
//   is fixed), and the block adds the gstep sums of each rank in
//   shared memory in thread order: one reduction a block, no shuffle a
//   rank.  The entry loop is unrolled by two: two independent
//   digamma/lgamma chains in flight a thread, and the compiler then
//   needs fewer registers (ptxas -v in float: 47 registers, 5 blocks
//   an SM, where the loop taken one entry at a time needs 62, and 4;
//   double 80, 0 spills; tools/bench_epi_post.py times both, and a cap
//   of 5 or 6 blocks an SM, and 128 genes a block).  Each entry is
//   post.cuh's gamma_post, the function post_kernel calls, so e, lwn
//   and d have K2's bits on the transposed layout; only the order of
//   the per-block partials moved.
//   The genes a block are a constant (ops/kernels/epilogue.py E2_COLS),
//   never derived from the lane count: a block holds one lane, so a
//   lane's partials and bits do not depend on its batch.
#pragma once

#include <cuda_runtime.h>

#include "post.cuh"
#include "reduce.cuh"
#include "specials.cuh"

namespace ccfindr {

constexpr int kE2Threads = 256;
constexpr int kE2Cols = 256;  // genes a block

template <typename T>
__global__ void __launch_bounds__(kE2Threads)
epi_w_kernel(const T* __restrict__ swn, const T* __restrict__ lw,
             const double* __restrict__ ehs_part, int nehs,
             const double* __restrict__ sc, int np, int rp, int r, int n,
             T* __restrict__ ew, T* __restrict__ lwn, T* __restrict__ dw,
             double* __restrict__ csum_part,
             double* __restrict__ wscal_part) {
  __shared__ T be_s[kMaxRp];
  __shared__ T logbe_s[kMaxRp];
  __shared__ double rsum_s[kE2Threads];
  __shared__ double red[kE2Threads / 32];
  const int blk = blockIdx.x, b = blockIdx.y, nblk = gridDim.x;
  const int tid = threadIdx.x;
  const double* scb = sc + b * 8;
  const T a = static_cast<T>(scb[0]);
  const T bb = static_cast<T>(scb[1]);
  const T fudge = static_cast<T>(scb[4]);
  const T r_live = static_cast<T>(scb[5]);
  const T a_over_b = a / bb;
  const T log_fudge = log(fudge);
  if (tid < rp) {
    double s = 0.0;
    for (int p = 0; p < nehs; ++p)
      s += ehs_part[((size_t)b * nehs + p) * rp + tid];
    const T be = T(1) / (a_over_b + static_cast<T>(s));
    be_s[tid] = be;
    logbe_s[tid] = log(be);
  }
  __syncthreads();

  const int gstep = kE2Threads / rp;
  const int k = tid % rp, j = tid / rp;
  const int g_end = min((blk + 1) * kE2Cols, np);
  double ck = 0.0, su = 0.0, se = 0.0, sl = 0.0, sd = 0.0;
  if (j < gstep) {
    const T be = be_s[k], log_be = logbe_s[k];
    const bool k_live = static_cast<T>(k) < r_live;
#pragma unroll 2
    for (int g = blk * kE2Cols + j; g < g_end; g += gstep) {
      const size_t off = ((size_t)b * np + g) * rp + k;
      const T sfx = swn[off];
      const T lfv = lw[off];
      const PostOut<T> o =
          gamma_post(sfx, lfv, a, be, log_be, a_over_b, fudge, log_fudge,
                     k_live && g < n, k, r, g < n);
      ew[off] = o.e;
      lwn[off] = o.ln;
      dw[off] = o.d;
      ck += static_cast<double>(o.e);
      su += static_cast<double>(o.u);
      se += static_cast<double>(o.e);
      sl += static_cast<double>(o.logl);
      sd += static_cast<double>(o.dt);
    }
  }
  // colSums(ew) of the block: rank k's gstep sums in thread order
  rsum_s[tid] = ck;
  __syncthreads();
  if (tid < rp) {
    double s = 0.0;
    for (int i = 0; i < gstep; ++i) s += rsum_s[i * rp + tid];
    csum_part[((size_t)b * nblk + blk) * rp + tid] = s;
  }
  double* out = wscal_part + ((size_t)b * nblk + blk) * 4;
  double v = block_sum(su, red);
  if (tid == 0) out[0] = v;
  v = block_sum(se, red);
  if (tid == 0) out[1] = v;
  v = block_sum(sl, red);
  if (tid == 0) out[2] = v;
  v = block_sum(sd, red);
  if (tid == 0) out[3] = v;
}

template <typename T>
cudaError_t launch_epi_w(const void* swn, const void* lw,
                         const double* ehs_part, int nehs, const double* sc,
                         int B, int np, int rp, int r, int n, void* ew,
                         void* lwn, void* dw, double* csum_part,
                         double* wscal_part, cudaStream_t stream) {
  const dim3 grid(ceil_div(np, kE2Cols), B);
  epi_w_kernel<T><<<grid, kE2Threads, 0, stream>>>(
      static_cast<const T*>(swn), static_cast<const T*>(lw), ehs_part, nehs,
      sc, np, rp, r, n, static_cast<T*>(ew), static_cast<T*>(lwn),
      static_cast<T*>(dw), csum_part, wscal_part);
  return cudaGetLastError();
}

// tcode: factor type 0 float, 1 double.  csum_part (B, ceil(np /
// kE2Cols), rp) and wscal_part (B, ceil(np / kE2Cols), 4): one partial
// a block, in the layout E3 and K4 read.
inline int epi_w_entry(int tcode, const void* swn, const void* lw,
                       const double* ehs_part, int nehs, const double* sc,
                       int B, int np, int rp, int r, int n, void* ew,
                       void* lwn, void* dw, double* csum_part,
                       double* wscal_part, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rp < 1 || rp > kMaxRp) return static_cast<int>(cudaErrorInvalidValue);
  if (tcode == 0)
    return static_cast<int>(launch_epi_w<float>(
        swn, lw, ehs_part, nehs, sc, B, np, rp, r, n, ew, lwn, dw,
        csum_part, wscal_part, s));
  if (tcode == 1)
    return static_cast<int>(launch_epi_w<double>(
        swn, lw, ehs_part, nehs, sc, B, np, rp, r, n, ew, lwn, dw,
        csum_part, wscal_part, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ccfindr
