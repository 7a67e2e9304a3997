// Arithmetic shared by the Scenario API's simulation kernels
// (whole_trace.cu, chunk.cu): fp64 operations that nvcc never contracts
// into a fused multiply-add, Python's min/max on numbers that are never
// NaN, CPython's math.hypot, warp reductions and a warp's sum in key
// order. The numpy core (serving/fastsim.py) computes in IEEE doubles
// rounded after every operation; these keep the kernels bit for bit equal
// to it.
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
__device__ inline double py_hypot(double a, double b) {
  const double mx = a < b ? b : a;
  if (mx == 0.0) return mx;
  int e;
  frexp(mx, &e);
  const double scale = ldexp(1.0, -e);
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
  return dvd(h, scale);
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
__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double x = __shfl_xor_sync(kFull, v, o);
    v = x > v ? x : v;
  }
  return v;
}

// The left-to-right sum of a warp's items in ascending key order, the
// numpy core's order for a float sum (warp-wide): item s of [0, m) has the
// unique key key(s), or a negative one to leave it out. Each lane ranks its
// items by counting the smaller keys and writes their values at their ranks
// in `scratch` (m entries, this warp's own); then every lane adds them up
// alike, so the dependent chain is the adds alone.
template <class Key, class Val>
__device__ double ordered_sum(int m, int lane, double* scratch, Key key,
                              Val val) {
  long long cnt = 0;
  for (int s = lane; s < m; s += 32) {
    const long long k = key(s);
    if (k < 0) continue;
    int r = 0;
    for (int t = 0; t < m; ++t) {
      const long long kt = key(t);
      r += kt >= 0 && kt < k;
    }
    scratch[r] = val(s);
    ++cnt;
  }
  cnt = warp_sum(cnt);
  __syncwarp();
  double sum = 0.0;
  for (long long r = 0; r < cnt; ++r) sum = add(sum, scratch[r]);
  __syncwarp();
  return sum;
}

}  // namespace fastsim
}  // namespace repro
