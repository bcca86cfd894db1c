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
//                  lw (lh log lh), as per-tile double partials:
//                  replaces vb_kernels.py:185 _elbo_kernel.  M3
//                  ml_xlog_sum (ml.cu) adds the partials in tile order
//                  (the TPU kernel kept a Kahan scalar in SMEM across its
//                  sequential grid).
//
// Division is exact IEEE, log the exact libdevice log, products FP32
// (or FP64) FMAs; no atomics, so two launches are bit-identical.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused.cuh"
#include "reduce.cuh"

namespace ccfindr {

constexpr int kPTile = 64;                 // P2 tile edge (genes, cells)
constexpr int kPLd = kPTile + 1;           // odd row stride
constexpr int kPK = 16;                    // rank components staged at once
constexpr int kPThreads = 256;             // 16 x 16, a 4 x 4 micro-tile each
constexpr int kPMaxR = 128;

// ---------------------------------------------------------------------
// P2 elbo_xpass
//
// Bound: the FP32 pipes -- wth and S are 3 FMAs a rank component, 6 r
//   flops an element and lane where x is not 0 (elsewhere t = 0); one
//   log a nonzero.  X is read once; the factors and their l log l are
//   read once a tile.
// Design: a block owns a 64 x 64 tile of one lane.  The tile's lw, lwl
//   rows and lh, lhl columns are staged 16 rank components at a time in
//   shared memory ([k][gene], [k][cell], odd stride); each thread keeps
//   wth and S of a 4 x 4 micro-tile (genes ty + 16 p, cells tx + 16 q)
//   in registers, 12 values read for 48 FMAs a component.  Then it adds
//   -x (S/wth - log wth) over its nonzeros in double, and the block
//   writes its sum as one partial in tile order.
// ---------------------------------------------------------------------
template <typename T, typename XT>
__global__ void __launch_bounds__(kPThreads)
elbo_xpass_kernel(const XT* __restrict__ x, size_t ldx,
                  const T* __restrict__ lw, const T* __restrict__ lwl,
                  const T* __restrict__ lh, const T* __restrict__ lhl, int n,
                  int m, int r, double* __restrict__ part) {
  __shared__ T lw_s[kPK][kPLd];
  __shared__ T lwl_s[kPK][kPLd];
  __shared__ T lh_s[kPK][kPLd];
  __shared__ T lhl_s[kPK][kPLd];
  __shared__ double red[kPThreads / 32];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * kPTile, g0 = blockIdx.y * kPTile;
  const int b = blockIdx.z;
  const size_t wo = (size_t)b * n * r, ho = (size_t)b * r * m;
  T wth[4][4], s[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) wth[p][q] = s[p][q] = T(0);

  for (int k0 = 0; k0 < r; k0 += kPK) {
    const int kn = min(kPK, r - k0);
    __syncthreads();  // readers of the previous stage are done
    for (int e = tid; e < kPK * kPTile; e += kPThreads) {
      const int i = e / kPK, kw = e % kPK;  // W: components fastest
      const bool okw = g0 + i < n && kw < kn;
      const size_t ow = wo + (size_t)(g0 + i) * r + k0 + kw;
      lw_s[kw][i] = okw ? lw[ow] : T(0);
      lwl_s[kw][i] = okw ? lwl[ow] : T(0);
      const int kh = e / kPTile, j = e % kPTile;  // H: cells fastest
      const bool okh = c0 + j < m && kh < kn;
      const size_t oh = ho + (size_t)(k0 + kh) * m + c0 + j;
      lh_s[kh][j] = okh ? lh[oh] : T(0);
      lhl_s[kh][j] = okh ? lhl[oh] : T(0);
    }
    __syncthreads();
    for (int k = 0; k < kn; ++k) {
      T a[4], al[4], h[4], hl[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = lw_s[k][ty + 16 * q];
        al[q] = lwl_s[k][ty + 16 * q];
        h[q] = lh_s[k][tx + 16 * q];
        hl[q] = lhl_s[k][tx + 16 * q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          wth[p][q] = fma(a[p], h[q], wth[p][q]);
          s[p][q] = fma(a[p], hl[q], fma(al[p], h[q], s[p][q]));
        }
    }
  }

  double acc = 0.0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int g = g0 + ty + 16 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tx + 16 * q;
      if (g < n && c < m) {
        const T xv = static_cast<T>(x[(size_t)g * ldx + c]);
        if (xv != T(0))
          acc -= static_cast<double>(
              xv * (s[p][q] / wth[p][q] - log(wth[p][q])));
      }
    }
  }
  const double bs = block_sum(acc, red);
  if (tid == 0)
    part[(size_t)b * gridDim.x * gridDim.y + (size_t)blockIdx.y * gridDim.x +
         blockIdx.x] = bs;
}

// ---------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------
template <typename T, typename XT>
cudaError_t launch_elbo(const void* x, size_t ldx, const void* lw,
                        const void* lwl, const void* lh, const void* lhl,
                        int B, int n, int m, int r, double* part,
                        cudaStream_t stream) {
  const dim3 grid(ceil_div(m, kPTile), ceil_div(n, kPTile), B);
  elbo_xpass_kernel<T, XT><<<grid, kPThreads, 0, stream>>>(
      static_cast<const XT*>(x), ldx, static_cast<const T*>(lw),
      static_cast<const T*>(lwl), static_cast<const T*>(lh),
      static_cast<const T*>(lhl), n, m, r, part);
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
// layouts of lw / lh; part (B, ceil(m / 64) * ceil(n / 64)), tile order.
int elbo_xpass(int tcode, int xcode, const void* x, int64_t ldx,
               const void* lw, const void* lwl, const void* lh,
               const void* lhl, int B, int n, int m, int r, double* part,
               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r < 1 || r > kPMaxR || ldx < m)
    return static_cast<int>(cudaErrorInvalidValue);
#define P2(T, XT)                                                             \
  return static_cast<int>(launch_elbo<T, XT>(x, (size_t)ldx, lw, lwl, lh, lhl, \
                                             B, n, m, r, part, s))
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
