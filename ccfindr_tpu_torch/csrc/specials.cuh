// Special functions for the VB sweep kernels (device code).
//
// Twins of ccfindr_tpu_torch/ops/vb.py (and of ccfindr_tpu/ops/vb.py):
// shift recurrences to a large argument plus Bernoulli asymptotic
// series, evaluated by Horner in the same order as the Python code.
// digamma_gammaln_both branches on the factor type exactly as the
// Python function branches on its dtype: float shifts to x >= 6 in 6
// steps with a three-term series, double to x >= 10 in 10 steps with
// the seven-term series.
#pragma once

#include <cuda_runtime.h>
#include <type_traits>

namespace ccfindr {

constexpr double kHalfLog2Pi = 0.9189385332046727417803297364056176;

template <typename T>
__device__ __forceinline__ T trigamma(T x) {
  const T shift = T(10);
  T acc = T(0);
  T xs = x;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const bool lt = xs < shift;
    acc = acc + (lt ? T(1) / (xs * xs) : T(0));
    xs = lt ? xs + T(1) : xs;
  }
  const T z = T(1) / (xs * xs);
  T s = T(-691.0 / 2730.0);
  s = s * z + T(5.0 / 66.0);
  s = s * z + T(-1.0 / 30.0);
  s = s * z + T(1.0 / 42.0);
  s = s * z + T(-1.0 / 30.0);
  s = s * z + T(1.0 / 6.0);
  return acc + T(1) / xs + T(0.5) * z + z / xs * s;
}

template <typename T>
__device__ __forceinline__ T digamma_approx(T x) {
  const T shift = T(10);
  T acc = T(0);
  T xs = x;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const bool lt = xs < shift;
    acc = acc + (lt ? T(1) / xs : T(0));
    xs = lt ? xs + T(1) : xs;
  }
  const T z = T(1) / (xs * xs);
  T s = T(1.0 / 12.0);
  s = s * z + T(-691.0 / 32760.0);
  s = s * z + T(1.0 / 132.0);
  s = s * z + T(-1.0 / 240.0);
  s = s * z + T(1.0 / 252.0);
  s = s * z + T(-1.0 / 120.0);
  s = s * z + T(1.0 / 12.0);
  return log(xs) - T(0.5) / xs - z * s - acc;
}

template <typename T>
__device__ __forceinline__ T gammaln_approx(T x) {
  const T shift = T(10);
  T prod = T(1);
  T xs = x;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const bool lt = xs < shift;
    prod = lt ? prod * xs : prod;
    xs = lt ? xs + T(1) : xs;
  }
  const T z = T(1) / (xs * xs);
  T s = T(1.0 / 156.0);
  s = s * z + T(-691.0 / 360360.0);
  s = s * z + T(1.0 / 1188.0);
  s = s * z + T(-1.0 / 1680.0);
  s = s * z + T(1.0 / 1260.0);
  s = s * z + T(-1.0 / 360.0);
  s = s * z + T(1.0 / 12.0);
  return (xs - T(0.5)) * log(xs) - xs + T(kHalfLog2Pi) + s / xs
         - log(prod);
}

// (psi(x), lgamma(x)) sharing one shift chain.
template <typename T>
__device__ __forceinline__ void digamma_gammaln_both(T x, T& psi,
                                                     T& lgam) {
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int steps = f32 ? 6 : 10;
  const T shift = f32 ? T(6) : T(10);
  T acc = T(0);
  T prod = T(1);
  T xs = x;
#pragma unroll
  for (int i = 0; i < steps; ++i) {
    const bool lt = xs < shift;
    acc = acc + (lt ? T(1) / xs : T(0));
    prod = prod * (lt ? xs : T(1));
    xs = lt ? xs + T(1) : xs;
  }
  const T z = T(1) / (xs * xs);
  const T logxs = log(xs);
  T ds, ls;
  if (f32) {
    ds = T(1.0 / 252.0);
    ds = ds * z + T(-1.0 / 120.0);
    ds = ds * z + T(1.0 / 12.0);
    ls = T(1.0 / 1260.0);
    ls = ls * z + T(-1.0 / 360.0);
    ls = ls * z + T(1.0 / 12.0);
  } else {
    ds = T(1.0 / 12.0);
    ds = ds * z + T(-691.0 / 32760.0);
    ds = ds * z + T(1.0 / 132.0);
    ds = ds * z + T(-1.0 / 240.0);
    ds = ds * z + T(1.0 / 252.0);
    ds = ds * z + T(-1.0 / 120.0);
    ds = ds * z + T(1.0 / 12.0);
    ls = T(1.0 / 156.0);
    ls = ls * z + T(-691.0 / 360360.0);
    ls = ls * z + T(1.0 / 1188.0);
    ls = ls * z + T(-1.0 / 1680.0);
    ls = ls * z + T(1.0 / 1260.0);
    ls = ls * z + T(-1.0 / 360.0);
    ls = ls * z + T(1.0 / 12.0);
  }
  psi = logxs - T(0.5) / xs - z * ds - acc;
  lgam = (xs - T(0.5)) * logxs - xs + T(kHalfLog2Pi) + ls / xs
         - log(prod);
}

}  // namespace ccfindr
