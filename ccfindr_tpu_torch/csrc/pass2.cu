// The two-pass VB sweep on Hopper (backend='pallas2pass'): the
// sufficient statistics and the ELBO data term as two passes over X,
// in the JAX package's layouts with a leading lane axis B where it used
// vmap (X (np, mp) shared by every lane, read in place: its row stride
// ldx may exceed the true cell count; lw (B, n, r); lh (B, r, m)).
//
//   P1 ss_xpass    swn = (x/wth) lh^T and the per-gene-chunk partials of
//                  shn = lw^T (x/wth): replaces
//                  ccfindr_tpu/ops/pallas/vb_kernels.py:108
//                  _suffstats_kernel.  E1's gene-major walk (fused.cuh)
//                  with the x*log(wth) sum compiled out; E1s fused_sum
//                  (epi.cu) adds the partials in chunk order.
//   P2 elbo_xpass  -sum x (S/wth - log wth), S = (lw log lw) lh +
//                  lw (lh log lh), as one double partial a strip of
//                  kP2Band genes x kP2Chunk cells, which the lane's last
//                  block adds in strip order (reduce.cuh lane_tail_sum):
//                  replaces vb_kernels.py:185 _elbo_kernel (which kept a
//                  Kahan scalar in SMEM across its sequential grid).
//
// Division is exact IEEE (div_rn's bits), log the exact libdevice log;
// P1's products are FP32 (or FP64) FMAs, P2's float products split-TF32
// on the tensor cores (see its note) and its double ones FP64 FMAs; no
// atomic in any sum, so two launches are bit-identical.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused.cuh"
#include "reduce.cuh"

namespace ccfindr {

constexpr int kPMaxR = 128;
constexpr int kP2Band = 64;     // genes a block (the strip's height)
// cells a block (the strip's length): ops/kernels/vb_kernels.py P2_CHUNK.
// A constant, never derived from the batch, so a lane's partials (and
// with them its bits) do not depend on the lanes launched beside it.
constexpr int kP2Chunk = 1024;
constexpr int kP2Tile = 64;     // cells a step
constexpr int kP2Slab = 32;     // rank components staged a step
constexpr int kP2Stages = 2;    // staging buffers: steps in flight + 1
constexpr int kP2Threads = 256;
constexpr int kP2Ald = kP2Slab + 4;  // lw/lwl tile row stride: 4 mod 8
constexpr int kP2Hld = kP2Tile + 8;  // lh/lhl tile row stride: 8 mod 32
// float products on the tensor cores as split-TF32 (decided by
// tools/bench_pass2.py; PERF.md section 6): one kernel serves the path
constexpr bool kP2SplitTf32 = true;

// ---------------------------------------------------------------------
// P2 elbo_xpass
//
// Replaces: ccfindr_tpu/ops/pallas/vb_kernels.py:185 _elbo_kernel.
// Bound: the products -- wth = lw lh and S = lwl lh + lw lhl, 6 r flops
//   an element and lane (at 10x, 4,096 x 8,192, 3 lanes of r 16: 9.7
//   GFLOP, 0.145 ms on the FP32 pipes' 67 TFLOP/s; split-TF32 makes it
//   29 GFLOP of TF32, 0.059 ms at 495 TFLOP/s), then a division and a log
//   at each nonzero of X (~70 M at 10x), about as many instructions
//   again; X is read once (0.13 GB of float X at 10x), the factors
//   once a strip.
// What held the earlier tile design (0.93 ms at 10x): a block a 64 x 64
//   tile (24,576 blocks at 10x), each paying a fence and a ticket, and
//   the lane's last block adding 8,192 partials with one warp (+0.19
//   ms); factor tiles staged element by element with two barriers a
//   rank stage; the compiler's division; the three products on the FP32
//   pipes (~13 TFLOP/s, the rate of fused.cuh's walk).
// Design: a block owns a strip -- a band of kP2Band genes of one lane
//   across kP2Chunk cells -- and walks it in 64-cell steps.  The band's
//   lw and lwl are staged once (r <= 32) or a 32-wide rank slab a step
//   (r > 32, the accumulators kept across a cell tile's slabs); the lh
//   and lhl slabs and the X tile stream in with cp.async into a double
//   buffer (fused.cuh's stage_tile: 16-byte copies where rows are
//   aligned, elements elsewhere, zero outside the matrix), one barrier
//   a step.  One partial a block (at 10x 512 a lane, against 8,192),
//   added by the lane's last block (reduce.cuh lane_tail_sum).
//   Float (kP2SplitTf32): the products on the tensor cores, mma.sync
//   m16n8k8 in TF32 with each operand split as hi = tf32(v), lo =
//   tf32(v - hi) and three MMAs a product (lo hi + hi lo + hi hi, FP32
//   accumulators): wth with K = r, S with K = 2 r ([lwl | lw] times
//   [lh ; lhl]).  A warp owns 16 genes x 32 cells of a step (4 n-tiles,
//   16 accumulators a product a thread).  Double: 4 x 4 register tiles
//   of FP64 FMAs (genes ty + 16 p, cells 4 tx + q) from 16-byte shared
//   loads, as fused.cuh's walk.
//   The epilogue runs on the accumulators: S / wth by div_rn (the IEEE
//   division's bits) for the 16 elements, the division itself only for
//   those out of its range, in a loop outside the hot path; then x at
//   each element's (gene, cell) from the staged X tile and, where x is
//   not 0, -x (S / wth - log wth) with the exact libdevice log (a
//   non-positive wth is not replaced, as before), added in double in a
//   fixed order.  The lanes of a strip are neighbours in the grid, so X
//   comes from device memory about once for all of them.
// What bounds it now (tools/bench_pass2.py, 10x): issue -- the
//   epilogue's division and log (~0.18 ms), the staging (~0.19 ms alone)
//   and the splits and MMAs (~0.12 ms) add up rather than overlap; with
//   FP32 FMAs the products take ~0.06 ms more.
// ptxas -v (chip_smoke.py phase 13 prints it): float split-TF32, float
//   X, 80 registers (three blocks of 256 an SM), 0 bytes of spills; the
//   FP32-FMA walk 119; double 160-162, 0 spills.
// ---------------------------------------------------------------------

// P2's shared-memory plan of one launch (bytes): each of kP2Stages
// buffers holds an X tile and the lh/lhl slabs; the lw/lwl tiles have
// one buffer where the band's ranks fit one slab (staged once), one a
// stage where they do not.
struct P2Plan {
  int ks;        // rank components a slab (8, 16, 24 or 32)
  int nsl;       // slabs a cell tile
  int xld;       // X tile row stride (elements)
  int vec;       // 1 X, 2 lw/lwl, 4 lh/lhl: 16-byte rows, cp.async
  size_t h_off, a_off, x_buf, h_buf, a_buf, bytes;  // X at offset 0
};

inline P2Plan p2_plan(size_t st, size_t sx, int r) {
  P2Plan p{};
  const int rk8 = (r + 7) & ~7;
  p.ks = rk8 < kP2Slab ? rk8 : kP2Slab;
  p.nsl = ceil_div(rk8, p.ks);
  p.xld = kP2Tile + static_cast<int>(16 / sx);
  p.x_buf = align16(kP2Band * p.xld * sx);
  p.h_buf = align16(2 * static_cast<size_t>(p.ks) * kP2Hld * st);
  p.a_buf = align16(2 * static_cast<size_t>(kP2Band) * kP2Ald * st);
  p.h_off = kP2Stages * p.x_buf;
  p.a_off = p.h_off + kP2Stages * p.h_buf;
  p.bytes = p.a_off + (p.nsl == 1 ? 1 : kP2Stages) * p.a_buf;
  return p;
}

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v as TF32, rounded to the nearest 10-bit mantissa with ties away from
// zero: cvt.rna.tf32.f32's bits for finite v, in two integer operations
// (cvt in their place costs P2 6%: tools/bench_pass2.py)
__device__ __forceinline__ unsigned tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(v), lo = tf32(v - hi): v to about 21 bits as hi + lo
__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// d += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), TF32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The epilogue of a cell tile on a thread's 16 elements (wth[i][e],
// S in sv[i][e], x at xat(i, e)): S / wth by div_rn for all 16, the
// division itself only for those out of its range (a loop outside the
// hot path, as fused.cuh's walk does), then -x (S / wth - log wth)
// where x is not 0, added to acc in double in element order.
template <typename T, typename XF>
__device__ __forceinline__ void p2_epilogue(T (&wth)[4][4], T (&sv)[4][4],
                                            XF xat, double& acc) {
  unsigned slow = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool fast;
      const T q = div_rn(sv[i][e], wth[i][e], fast);
      if (fast)
        sv[i][e] = q;
      else
        slow |= 1u << (4 * i + e);
    }
  if (slow) {
#pragma unroll 1
    for (int k = 0; k < 16; ++k) {
      if (slow & (1u << k)) {
        T sk = T(0), wk = T(1);
#pragma unroll
        for (int f = 0; f < 16; ++f)
          if (f == k) sk = sv[f >> 2][f & 3], wk = wth[f >> 2][f & 3];
        const T q = sk / wk;
#pragma unroll
        for (int f = 0; f < 16; ++f)
          if (f == k) sv[f >> 2][f & 3] = q;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const T xv = xat(i, e);
      if (xv != T(0))
        acc -= static_cast<double>(xv * (sv[i][e] - log(wth[i][e])));
    }
}

template <typename T, typename XT, bool kMma>
__global__ void __launch_bounds__(kP2Threads, kMma ? 3 : sizeof(T) == 4 ? 2 : 1)
elbo_xpass_kernel(const XT* __restrict__ x, size_t ldx,
                  const T* __restrict__ lw, const T* __restrict__ lwl,
                  const T* __restrict__ lh, const T* __restrict__ lhl, int n,
                  int m, int r, int chunk, P2Plan plan,
                  double* __restrict__ part, unsigned* __restrict__ tickets,
                  double* __restrict__ out) {
  static_assert(!kMma || sizeof(T) == 4, "split-TF32 takes float factors");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double red[kP2Threads / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the lanes of a strip are neighbours in the grid: they read the same
  // X tiles, from L2 for all but the first
  const int b = blockIdx.x;
  const int c_begin = blockIdx.y * chunk, g0 = blockIdx.z * kP2Band;
  const int c_end = min(c_begin + chunk, m), gn = min(kP2Band, n - g0);
  const int ks = plan.ks, nsl = plan.nsl;
  const int nsteps = ceil_div(c_end - c_begin, kP2Tile) * nsl;
  const T* lw_b = lw + (size_t)b * n * r;
  const T* lwl_b = lwl + (size_t)b * n * r;
  const T* lh_b = lh + (size_t)b * r * m;
  const T* lhl_b = lhl + (size_t)b * r * m;
  auto x_s = [&](int buf) {
    return reinterpret_cast<XT*>(smem_raw + buf * plan.x_buf);
  };
  auto h_s = [&](int buf) {  // lh slab, then lhl slab
    return reinterpret_cast<T*>(smem_raw + plan.h_off + buf * plan.h_buf);
  };
  auto a_s = [&](int buf) {  // lw tile, then lwl tile
    return reinterpret_cast<T*>(smem_raw + plan.a_off +
                                (nsl == 1 ? 0 : buf) * plan.a_buf);
  };

  // the tiles of step s: the lh/lhl slab, the lw/lwl slab (every step
  // where the ranks take several slabs, else once), X at a cell tile's
  // last slab (its epilogue)
  auto issue = [&](int s, int buf) {
    const int sl = s % nsl, c0 = c_begin + (s / nsl) * kP2Tile;
    const int k0 = sl * ks, kn = min(ks, r - k0), cn = min(kP2Tile, c_end - c0);
    T* hs = h_s(buf);
    stage_tile<T>(hs, kP2Hld, lh_b + (size_t)k0 * m + c0, m, ks, kP2Tile,
                  kn, cn, plan.vec & 4);
    stage_tile<T>(hs + ks * kP2Hld, kP2Hld, lhl_b + (size_t)k0 * m + c0, m,
                  ks, kP2Tile, kn, cn, plan.vec & 4);
    if (nsl > 1 || s == 0) {
      T* as = a_s(buf);
      stage_tile<T>(as, kP2Ald, lw_b + (size_t)g0 * r + k0, r, kP2Band, ks,
                    gn, kn, plan.vec & 2);
      stage_tile<T>(as + kP2Band * kP2Ald, kP2Ald,
                    lwl_b + (size_t)g0 * r + k0, r, kP2Band, ks, gn, kn,
                    plan.vec & 2);
    }
    if (sl == nsl - 1)
      stage_tile<XT>(x_s(buf), plan.xld, x + (size_t)g0 * ldx + c0, ldx,
                     kP2Band, kP2Tile, gn, cn, plan.vec & 1);
  };

  // a thread's 16 elements of wth and S: kMma, warp (mt, nh) owns genes
  // 16 mt .. +15 x cells 32 nh .. +31 as four m16n8 tiles j (element
  // [j][e]: gene 16 mt + gid + 8 (e >> 1), cell 32 nh + 8 j + 2 tig +
  // (e & 1)); else genes ty + 16 p x cells 4 tx + q ([p][q])
  T wth[4][4], sv[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) wth[p][q] = sv[p][q] = T(0);
  const int gid = lane >> 2, tig = lane & 3, mt = warp & 3, nh = warp >> 2;
  const int tx = tid & 15, ty = tid >> 4;
  double acc = 0.0;

  // kP2Stages - 1 steps in flight: step s + kP2Stages - 1 is issued
  // into the buffer that step s - 1 read
  for (int i = 0; i < kP2Stages - 1; ++i) {
    if (i < nsteps) issue(i, i);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kP2Stages - 2>();  // step s's group has landed
    __syncthreads();  // for every thread; step s - 1's readers are done
    const int next = s + kP2Stages - 1;
    if (next < nsteps) issue(next, next % kP2Stages);
    cp_async_commit();
    const int buf = s % kP2Stages, sl = s % nsl;
    const int kn8 = min(ks, ((r + 7) & ~7) - sl * ks);
    const T* hs = h_s(buf);
    const T* hls = hs + ks * kP2Hld;
    const T* as = a_s(buf);
    const T* als = as + kP2Band * kP2Ald;
    if constexpr (kMma) {
      for (int kk = 0; kk < kn8; kk += 8) {
        unsigned whi[4], wlo[4], lhi[4], llo[4];
        const int ao = (16 * mt + gid) * kP2Ald + kk + tig;
        const int aoff[4] = {ao, ao + 8 * kP2Ald, ao + 4, ao + 8 * kP2Ald + 4};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split_tf32(as[aoff[i]], whi[i], wlo[i]);
          split_tf32(als[aoff[i]], lhi[i], llo[i]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int bo = (kk + tig) * kP2Hld + 32 * nh + 8 * j + gid;
          unsigned hhi0, hlo0, hhi1, hlo1, qhi0, qlo0, qhi1, qlo1;
          split_tf32(hs[bo], hhi0, hlo0);
          split_tf32(hs[bo + 4 * kP2Hld], hhi1, hlo1);
          split_tf32(hls[bo], qhi0, qlo0);
          split_tf32(hls[bo + 4 * kP2Hld], qhi1, qlo1);
          // the small products first
          mma_tf32(wth[j], wlo, hhi0, hhi1);
          mma_tf32(wth[j], whi, hlo0, hlo1);
          mma_tf32(wth[j], whi, hhi0, hhi1);
          mma_tf32(sv[j], llo, hhi0, hhi1);
          mma_tf32(sv[j], lhi, hlo0, hlo1);
          mma_tf32(sv[j], wlo, qhi0, qhi1);
          mma_tf32(sv[j], whi, qlo0, qlo1);
          mma_tf32(sv[j], lhi, hhi0, hhi1);
          mma_tf32(sv[j], whi, qhi0, qhi1);
        }
      }
    } else {
      for (int k = 0; k < kn8; k += 4) {
        T a[4][4], al[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          lds4(as + (ty + 16 * p) * kP2Ald + k, a[p]);
          lds4(als + (ty + 16 * p) * kP2Ald + k, al[p]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          T h[4], hl[4];
          lds4(hs + (k + kk) * kP2Hld + 4 * tx, h);
          lds4(hls + (k + kk) * kP2Hld + 4 * tx, hl);
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              wth[p][q] = fma(a[p][kk], h[q], wth[p][q]);
              sv[p][q] = fma(a[p][kk], hl[q], fma(al[p][kk], h[q], sv[p][q]));
            }
        }
      }
    }
    if (sl == nsl - 1) {  // the cell tile's epilogue, then fresh sums
      const XT* xs = x_s(buf);
      const int xld = plan.xld;
      if constexpr (kMma) {
        p2_epilogue(wth, sv, [&](int j, int e) {
          const int gl = 16 * mt + gid + 8 * (e >> 1);
          const int cl = 32 * nh + 8 * j + 2 * tig + (e & 1);
          return static_cast<T>(xs[gl * xld + cl]);
        }, acc);
      } else {
        p2_epilogue(wth, sv, [&](int p, int q) {
          return static_cast<T>(xs[(ty + 16 * p) * xld + 4 * tx + q]);
        }, acc);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) wth[p][q] = sv[p][q] = T(0);
    }
  }

  const double bs = block_sum(acc, red);
  const int nblk = gridDim.y * gridDim.z;
  if (tid == 0)
    part[(size_t)b * nblk + (size_t)blockIdx.z * gridDim.y + blockIdx.y] = bs;
  lane_tail_sum(part + (size_t)b * nblk, nblk, tickets + b, out + b);
}

// ---------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------
// P2 on strips of ``chunk`` cells (a multiple of kP2Tile; the C entry
// passes kP2Chunk); kMma: the float products as split-TF32
template <typename T, typename XT, bool kMma = kP2SplitTf32 && sizeof(T) == 4>
cudaError_t launch_elbo(const void* x, size_t ldx, const void* lw,
                        const void* lwl, const void* lh, const void* lhl,
                        int B, int n, int m, int r, int chunk, double* part,
                        unsigned* tickets, double* out, cudaStream_t stream) {
  if (chunk < kP2Tile || chunk % kP2Tile != 0) return cudaErrorInvalidValue;
  P2Plan plan = p2_plan(sizeof(T), sizeof(XT), r);
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  plan.vec = ((ldx * sizeof(XT)) % 16 == 0 && aligned(x) ? 1 : 0) |
             ((r * sizeof(T)) % 16 == 0 && aligned(lw) && aligned(lwl) ? 2
                                                                       : 0) |
             ((m * sizeof(T)) % 16 == 0 && aligned(lh) && aligned(lhl) ? 4
                                                                       : 0);
  const dim3 grid(B, ceil_div(m, chunk), ceil_div(n, kP2Band));
  auto kernel = elbo_xpass_kernel<T, XT, kMma>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kP2Threads, plan.bytes, stream>>>(
      static_cast<const XT*>(x), ldx, static_cast<const T*>(lw),
      static_cast<const T*>(lwl), static_cast<const T*>(lh),
      static_cast<const T*>(lhl), n, m, r, chunk, plan, part, tickets, out);
  return cudaGetLastError();
}

}  // namespace ccfindr

using namespace ccfindr;

// C interface, bound with ctypes by ccfindr_tpu_torch/ops/kernels/
// vb_kernels.py.  tcode: factor type 0 float, 1 double.  xcode: X type
// 0 int8, 1 int16, 2 float, 3 double.  ldx: X's row stride in elements.
// Each returns cudaGetLastError() after its launch.
extern "C" {

// swn (B, n, r) complete; shn_part (B, ceil(n / chunk), r, m).
int ss_xpass(int tcode, int xcode, const void* x, int64_t ldx,
             const void* lw, const void* lh, int B, int n, int m, int r,
             int chunk, void* swn, void* shn_part, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r < 1 || r > kPMaxR || chunk < 1 || ldx < m)
    return static_cast<int>(cudaErrorInvalidValue);
#define P1(T, XT)                                                           \
  return static_cast<int>(launch_fused_xpass<T, XT, true, false, false>(   \
      x, (size_t)ldx, lw, lh, B, n, m, r, chunk, swn, shn_part, nullptr, s))
  switch (tcode * 4 + xcode) {
    case 0: P1(float, int8_t);
    case 1: P1(float, int16_t);
    case 2: P1(float, float);
    case 3: P1(float, double);
    case 4: P1(double, int8_t);
    case 5: P1(double, int16_t);
    case 6: P1(double, float);
    case 7: P1(double, double);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef P1
}

// lwl / lhl: lw log lw and lh log lh (0 where the factor is 0), in the
// layouts of lw / lh; part (B, ceil(n / kP2Band) * ceil(m / kP2Chunk)),
// one a strip, gene band major; tickets (B) the lanes' counters, 0
// before and after; out (B) each lane's sum of its partials.
int elbo_xpass(int tcode, int xcode, const void* x, int64_t ldx,
               const void* lw, const void* lwl, const void* lh,
               const void* lhl, int B, int n, int m, int r, double* part,
               unsigned* tickets, double* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r < 1 || r > kPMaxR || ldx < m)
    return static_cast<int>(cudaErrorInvalidValue);
#define P2(T, XT)                                                             \
  return static_cast<int>(launch_elbo<T, XT>(x, (size_t)ldx, lw, lwl, lh,    \
                                             lhl, B, n, m, r, kP2Chunk, part, \
                                             tickets, out, s))
  switch (tcode * 4 + xcode) {
    case 0: P2(float, int8_t);
    case 1: P2(float, int16_t);
    case 2: P2(float, float);
    case 3: P2(float, double);
    case 4: P2(double, int8_t);
    case 5: P2(double, int16_t);
    case 6: P2(double, float);
    case 7: P2(double, double);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef P2
}

}  // extern "C"
