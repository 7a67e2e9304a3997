// Kernel B3: fused RMSNorm (+ residual add) for Hopper (sm_90a).
//
// Replaces the TPU kernel `rmsnorm_pallas` in
// src/repro/kernels/rmsnorm/rmsnorm.py (bodies `_rmsnorm_kernel` and
// `_rmsnorm_res_kernel`):
//     y = (x [+ r]) * rsqrt(mean((x [+ r])^2) + eps) * w
// computed in fp32 and cast to x's type. x, r and y share a type (fp32 or
// bf16); w may be either (decode normalises fp32 activations with bf16
// weights).
//
// What bounds it on the H100: device-memory bytes. It does ~4 flops per
// element, far below the ~295 flops per byte at which the card turns
// compute-bound, so its floor is (2 * rows * D [+ rows * D] + D) * bytes
// over 3.35 TB/s.
//
// Design: one block per row. Threads read the row with 16-byte vector loads
// (4 fp32 or 8 bf16 values; scalar loads when D or an address does not
// allow it), sum squares in fp32, reduce by warp shuffles and then across
// the block's warps in shared memory. The second pass reads the row again
// from L1/L2 (a row is at most a few tens of KB), so device memory sees each
// input byte once. Nothing is allocated; the launch goes on the caller's
// stream.
#include "common.cuh"
#include "launch.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;
using repro::warp_sum;

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using raw = float4;
  static constexpr int n = 4;
};
template <>
struct Vec16<__nv_bfloat16> {
  using raw = uint4;
  static constexpr int n = 8;
};

template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float* out) {
  if constexpr (N == 1) {
    out[0] = to_f32(*p);
  } else {
    using R = typename Vec16<T>::raw;
    R raw = *reinterpret_cast<const R*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32(e[j]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float* in) {
  if constexpr (N == 1) {
    *p = from_f32<T>(in[0]);
  } else {
    using R = typename Vec16<T>::raw;
    R raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) e[j] = from_f32<T>(in[j]);
    *reinterpret_cast<R*>(p) = raw;
  }
}

template <typename TX, typename TW, int N>
__global__ void rmsnorm_kernel(const TX* __restrict__ x,
                               const TX* __restrict__ r,
                               const TW* __restrict__ w, TX* __restrict__ y,
                               int d, float eps) {
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const TX* xr = x + base;
  const TX* rr = r ? r + base : nullptr;
  TX* yr = y + base;
  const int step = blockDim.x * N;

  float ss = 0.f;
  for (int i = threadIdx.x * N; i < d; i += step) {
    float v[N];
    load_n<TX, N>(xr + i, v);
    if (rr) {
      float u[N];
      load_n<TX, N>(rr + i, u);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] += u[j];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) ss += v[j] * v[j];
  }

  __shared__ float part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < n_warps ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float inv = rsqrtf(part[0] / static_cast<float>(d) + eps);

  for (int i = threadIdx.x * N; i < d; i += step) {
    float v[N];
    load_n<TX, N>(xr + i, v);
    if (rr) {
      float u[N];
      load_n<TX, N>(rr + i, u);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] += u[j];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = v[j] * inv * to_f32(w[i + j]);
    store_n<TX, N>(yr + i, v);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename TX, typename TW>
void launch(const void* x, const void* r, const void* w, void* y, int rows,
            int d, float eps, cudaStream_t stream) {
  constexpr int kVec = Vec16<TX>::n;
  const bool vec = d % kVec == 0 && aligned16(x) && aligned16(y) &&
                   (r == nullptr || aligned16(r));
  const int per_thread = vec ? kVec : 1;
  int threads = (d / per_thread + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const TX* xp = static_cast<const TX*>(x);
  const TX* rp = static_cast<const TX*>(r);
  const TW* wp = static_cast<const TW*>(w);
  TX* yp = static_cast<TX*>(y);
  if (vec)
    rmsnorm_kernel<TX, TW, kVec><<<rows, threads, 0, stream>>>(xp, rp, wp,
                                                               yp, d, eps);
  else
    rmsnorm_kernel<TX, TW, 1><<<rows, threads, 0, stream>>>(xp, rp, wp, yp,
                                                            d, eps);
}

}  // namespace

// x, r (may be null), y: (rows, d) contiguous, x's type; w: (d,).
extern "C" int rmsnorm_launch(const void* x, const void* r, const void* w,
                              void* y, int rows, int d, float eps,
                              int x_bf16, int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0 && d > 0) {
    if (x_bf16 && w_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(x, r, w, y, rows, d, eps, s);
    else if (x_bf16)
      launch<__nv_bfloat16, float>(x, r, w, y, rows, d, eps, s);
    else if (w_bf16)
      launch<float, __nv_bfloat16>(x, r, w, y, rows, d, eps, s);
    else
      launch<float, float>(x, r, w, y, rows, d, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}
