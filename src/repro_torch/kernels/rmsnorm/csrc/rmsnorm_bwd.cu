// Kernel B3's backward: the gradients of the fused RMSNorm (+ residual) for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel, and its
// gradient through the norm is XLA's autodiff of the jnp `rmsnorm_ref`
// (src/repro/kernels/rmsnorm/ref.py:10). With x' = x [+ r], rstd =
// rsqrt(mean(x'^2) + eps), g = dy * w:
//     dx = rstd g - x' rstd^3 sum(g x') / d,   dw = sum over rows of dy x' rstd
// in fp32; dx in x's type (the residual's gradient is dx itself, not
// written twice), dw in w's type (fp32 or bf16, either with either x).
//
// What bounds it on the H100: device-memory bytes. It reads x [, r], dy and
// w and writes dx and dw once, ~10 flops an element: 0.060 ms at 8192 x 4096
// bf16 over 3.35 TB/s.
//
// Two passes, deterministic (no atomics):
//   1. `rmsnorm_bwd_rows_kernel`: CTA c of C takes rows c, c + C, ...; a row
//      is read once with 16-byte vector loads (scalar where d or an address
//      does not allow it) into the threads' registers, both row sums (x'^2
//      and g x') are reduced in one pass of warp shuffles and one block
//      barrier, dx is written from the registers, and each thread keeps its
//      columns' partial sum of dy x' rstd in fp32 over the CTA's rows. The
//      CTA writes them to row c of a (C, d) fp32 scratch.
//   2. `rmsnorm_bwd_dw_kernel`: dw = the scratch summed by column, in w's
//      type. The wrapper picks C (`bwd_ctas` in ops.py), whose plain mirror
//      the CPU tests hold against the closed form.
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

// w's N values at i: a 16-byte load of a bf16 w covers 8, of an fp32 w 4.
template <typename TW, int N>
__device__ __forceinline__ void load_w(const TW* p, float* out, bool vec) {
  if (vec && N % Vec16<TW>::n == 0) {
#pragma unroll
    for (int j = 0; j < N; j += Vec16<TW>::n)
      load_n<TW, Vec16<TW>::n>(p + j, out + j);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32(p[j]);
  }
}

// N values a vector, IT vectors a thread: thread t's vectors start at
// (k * blockDim.x + t) * N, k < IT.
template <typename TX, typename TW, int N, int IT>
__global__ void __launch_bounds__(256)
    rmsnorm_bwd_rows_kernel(const TX* __restrict__ x,
                            const TX* __restrict__ r,
                            const TW* __restrict__ w,
                            const TX* __restrict__ dy, TX* __restrict__ dx,
                            float* __restrict__ part, int rows, int d,
                            float eps, int w_vec) {
  __shared__ float2 red[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  float acc[IT][N];
#pragma unroll
  for (int k = 0; k < IT; ++k)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[k][j] = 0.f;

  int parity = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const size_t base = static_cast<size_t>(row) * d;
    float xv[IT][N], gv[IT][N];  // x' and dy
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      const int i = (k * blockDim.x + threadIdx.x) * N;
      if (i < d) {
        load_n<TX, N>(x + base + i, xv[k]);
        if (r != nullptr) {
          float u[N];
          load_n<TX, N>(r + base + i, u);
#pragma unroll
          for (int j = 0; j < N; ++j) xv[k][j] += u[j];
        }
        load_n<TX, N>(dy + base + i, gv[k]);
        float wv[N];
        load_w<TW, N>(w + i, wv, w_vec);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          ss += xv[k][j] * xv[k][j];
          sg += gv[k][j] * wv[j] * xv[k][j];
        }
      }
    }
    float2 p = make_float2(warp_sum(ss), warp_sum(sg));
    if (lane == 0) red[parity][warp] = p;
    __syncthreads();
    p = make_float2(0.f, 0.f);
    for (int q = 0; q < n_warps; ++q) {
      p.x += red[parity][q].x;
      p.y += red[parity][q].y;
    }
    const float rstd = rsqrtf(p.x / static_cast<float>(d) + eps);
    const float c = rstd * rstd * rstd * p.y / static_cast<float>(d);
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      const int i = (k * blockDim.x + threadIdx.x) * N;
      if (i < d) {
        float wv[N], o[N];
        load_w<TW, N>(w + i, wv, w_vec);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          o[j] = rstd * gv[k][j] * wv[j] - xv[k][j] * c;
          acc[k][j] += gv[k][j] * xv[k][j] * rstd;
        }
        store_n<TX, N>(dx + base + i, o);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const int i = (k * blockDim.x + threadIdx.x) * N;
    if (i >= d) continue;
    float* p = part + static_cast<size_t>(blockIdx.x) * d + i;
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int j = 0; j < N; j += 4)
        *reinterpret_cast<float4*>(p + j) = make_float4(
            acc[k][j], acc[k][j + 1], acc[k][j + 2], acc[k][j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) p[j] = acc[k][j];
    }
  }
}

// dw[col] = sum over the C rows of the scratch: a block of 8 warps takes 32
// columns, warp q summing rows q, q + 8, ... .
template <typename TW>
__global__ void __launch_bounds__(256)
    rmsnorm_bwd_dw_kernel(const float* __restrict__ part,
                          TW* __restrict__ dw, int ctas, int d) {
  __shared__ float s[8][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (col < d)
    for (int c = warp; c < ctas; c += 8)
      v += part[static_cast<size_t>(c) * d + col];
  s[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) t += s[q][lane];
    dw[col] = from_f32<TW>(t);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename TX, typename TW, int N, int IT>
void launch_rows(const void* x, const void* r, const void* w, const void* dy,
                 void* dx, float* part, int rows, int d, int ctas, int threads,
                 float eps, int w_vec, cudaStream_t s) {
  rmsnorm_bwd_rows_kernel<TX, TW, N, IT><<<ctas, threads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(r),
      static_cast<const TW*>(w), static_cast<const TX*>(dy),
      static_cast<TX*>(dx), part, rows, d, eps, w_vec);
}

template <typename TX, typename TW, int N>
cudaError_t launch(const void* x, const void* r, const void* w,
                   const void* dy, void* dx, void* dw, float* part, int rows,
                   int d, int ctas, float eps, cudaStream_t s) {
  // IT vectors a thread: the fewest that keep the block within 256 threads
  const int vecs = (d + N - 1) / N;
  const int it = vecs <= 256 ? 1 : vecs <= 512 ? 2 : vecs <= 1024 ? 4 : 8;
  const int threads = ((vecs + it - 1) / it + 31) / 32 * 32;
  if (threads > 256) return cudaErrorInvalidValue;
  const int w_vec = d % Vec16<TW>::n == 0 && aligned16(w);
  if (it == 1)
    launch_rows<TX, TW, N, 1>(x, r, w, dy, dx, part, rows, d, ctas, threads,
                              eps, w_vec, s);
  else if (it == 2)
    launch_rows<TX, TW, N, 2>(x, r, w, dy, dx, part, rows, d, ctas, threads,
                              eps, w_vec, s);
  else if (it == 4)
    launch_rows<TX, TW, N, 4>(x, r, w, dy, dx, part, rows, d, ctas, threads,
                              eps, w_vec, s);
  else
    launch_rows<TX, TW, N, 8>(x, r, w, dy, dx, part, rows, d, ctas, threads,
                              eps, w_vec, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rmsnorm_bwd_dw_kernel<TW><<<(d + 31) / 32, 256, 0, s>>>(
      part, static_cast<TW*>(dw), ctas, d);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_x(const void* x, const void* r, const void* w,
                     const void* dy, void* dx, void* dw, float* part,
                     int rows, int d, int ctas, float eps, cudaStream_t s) {
  constexpr int kVec = Vec16<TX>::n;
  const bool vec = d % kVec == 0 && aligned16(x) && aligned16(dy) &&
                   aligned16(dx) && (r == nullptr || aligned16(r));
  return vec ? launch<TX, TW, kVec>(x, r, w, dy, dx, dw, part, rows, d, ctas,
                                    eps, s)
             : launch<TX, TW, 1>(x, r, w, dy, dx, dw, part, rows, d, ctas,
                                 eps, s);
}

}  // namespace

// x, r (may be null), dy, dx: (rows, d) contiguous, x's type; w, dw: (d,),
// w's type; part: (ctas, d) fp32 scratch, 1 <= ctas <= rows. d up to 2048
// vectors of 16 bytes (16384 bf16 or 8192 fp32 values).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* r,
                                  const void* w, const void* dy, void* dx,
                                  void* dw, void* part, int rows, int d,
                                  int ctas, float eps, int x_bf16, int w_bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (ctas < 1 || ctas > rows) return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(part);
  using bf16 = __nv_bfloat16;
  cudaError_t e;
  if (x_bf16 && w_bf16)
    e = launch_x<bf16, bf16>(x, r, w, dy, dx, dw, p, rows, d, ctas, eps, s);
  else if (x_bf16)
    e = launch_x<bf16, float>(x, r, w, dy, dx, dw, p, rows, d, ctas, eps, s);
  else if (w_bf16)
    e = launch_x<float, bf16>(x, r, w, dy, dx, dw, p, rows, d, ctas, eps, s);
  else
    e = launch_x<float, float>(x, r, w, dy, dx, dw, p, rows, d, ctas, eps, s);
  return static_cast<int>(e);
}
