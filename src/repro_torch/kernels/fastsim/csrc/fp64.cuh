// Arithmetic shared by the Scenario API's simulation kernels
// (whole_trace.cu, chunk.cu): fp64 operations that nvcc never contracts
// into a fused multiply-add, Python's min/max on numbers that are never
// NaN, CPython's math.hypot and warp reductions. The numpy core
// (serving/fastsim.py) computes in IEEE doubles rounded after every
// operation; these keep the kernels bit for bit equal to it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro {
namespace fastsim {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dvd(double a, double b) {
  return __ddiv_rn(a, b);
}
// Python's min(a, b) and max(a, 0.0)
__device__ __forceinline__ double pmin(double a, double b) {
  return b < a ? b : a;
}
__device__ __forceinline__ double max0(double a) { return 0.0 > a ? 0.0 : a; }

// CPython's math.hypot for two finite non-negative numbers (vector_norm in
// Modules/mathmodule.c): scale by a power of two, add the exact squares as
// double-length values into a compensated sum, take the square root and
// apply one correction. The fused multiply-adds here give exact low parts
// of products, which is what CPython's double-length multiply computes.
// frexp's exponent e comes from mx's exponent bits, and the scale 2^-e and
// its inverse 2^e are built from bits: both are exact powers of two, so
// scaling by either (a multiply where CPython divides) rounds as the
// division does. A subnormal or extreme mx takes frexp and ldexp.
__device__ inline double py_hypot(double a, double b) {
  const double mx = a < b ? b : a;
  if (mx == 0.0) return mx;
  const int be =
      static_cast<int>((__double_as_longlong(mx) >> 52) & 0x7ff);
  double scale, inv = 0.0;
  if (be >= 1 && be <= 2044) {  // e = be - 1022
    scale = __longlong_as_double(static_cast<long long>(2045 - be) << 52);
    inv = __longlong_as_double(static_cast<long long>(be + 1) << 52);
  } else {
    int e;
    frexp(mx, &e);
    scale = ldexp(1.0, -e);
  }
  double csum = 1.0, f1 = 0.0, f2 = 0.0;
  const double xs[2] = {mul(a, scale), mul(b, scale)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const double ph = mul(xs[i], xs[i]);
    const double pl = __fma_rn(xs[i], xs[i], -ph);
    const double hi = add(csum, ph);
    f2 = add(f2, add(sub(csum, hi), ph));
    csum = hi;
    f1 = add(f1, pl);
  }
  double h = __dsqrt_rn(add(sub(csum, 1.0), add(f1, f2)));
  const double ph = mul(-h, h);
  const double pl = __fma_rn(-h, h, -ph);
  const double hi = add(csum, ph);
  f2 = add(f2, add(sub(csum, hi), ph));
  csum = hi;
  f1 = add(f1, pl);
  h = add(h, dvd(add(sub(csum, 1.0), add(f1, f2)), mul(2.0, h)));
  return inv != 0.0 ? mul(h, inv) : dvd(h, scale);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ long long warp_min(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long x = __shfl_xor_sync(kFull, v, o);
    v = x < v ? x : v;
  }
  return v;
}
__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = pmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

}  // namespace fastsim
}  // namespace repro
