// Kernel B2: GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas` in
// src/repro/kernels/flash_attention/flash_attention.py (body
// `_flash_kernel`), and also covers what that kernel could not take: a
// runtime `q_offset` and per-sequence `kv_len`, so the engine's chunked
// prefill runs here too (the JAX engine used the jnp reference for it).
//
//   q: (B, Sq, Hq, D), k/v: (B, Skv, Hkv, D), out: (B, Sq, Hq, D), one type
//   (fp32 or bf16), Hq % Hkv == 0, D in {64, 128}, or 112 in bf16 (the
//   head of zamba2-7b's shared attention block). Query row i sits at
//   position q_offset + i; with `causal` it sees keys at positions <= its
//   own; keys at or past kv_len[b] (when given) are masked. A sequence
//   with kv_len[b] == 0 sees no key and gets the plain version's answer,
//   the mean of V over all Skv keys.
//
// What bounds it on the H100: operations. Causal prefill at Sq = 1024 does
// ~2*Sq*Sq*D flops per head against ~4*Sq*D*bytes of traffic, at or above
// the card's balance point. bf16 inputs (the prefill path) therefore go to
// the tensor cores: `mma.sync` m16n8k16 with fp32 accumulation (the wgmma/
// TMA pipeline that reaches the card's full rate is later work). fp32
// inputs (the chunked prefill, which runs in fp32 as in the reference)
// have no fp32 tensor-core product without TF32 rounding, so they take
// plain fp32 FMAs on the CUDA cores.
//
// Both kernels: one CTA per (64-row q block, q head, batch), walking 64-key
// K/V tiles of the q head's KV head (h / group, so K/V are never repeated
// in memory), stopping at the causal diagonal and at kv_len, so dead tiles
// are never loaded; the running softmax (max m, normaliser l_run) is fp32.
//   - bf16 (tensor cores): 4 warps, 16 q rows each. Q, K and V tiles sit
//     in shared memory as bf16 with rows padded by 8 elements, so the
//     32-bit fragment loads and the ldmatrix.trans reads of V are free of
//     bank conflicts. The Q fragments stay in registers; S = Q K^T and
//     O += P V run as mma.sync with P re-packed from the S accumulators to
//     bf16 (as the reference casts p to v's type before p @ v).
//   - fp32 (CUDA cores): 256 threads, each owning a 4x4 block of the 64x64
//     score tile and a 4 x D/16 slice of the output; rows are padded by 4
//     floats for conflict-free 16-byte loads, and P reuses the K tile.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <int D>
constexpr int smem_bytes_f32() {
  return (kBQ + 2 * kBK) * (D + 4) * static_cast<int>(sizeof(float));
}

template <int D>
constexpr int smem_bytes_bf16() {
  return (kBQ + 2 * kBK) * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A query row that sees no key (kv_len[b] <= 0): the plain versions
// softmax Skv logits of -1e30 each, which is uniform, so every row of the
// block is the mean of V over all Skv keys (C7).
template <typename T>
__device__ void mean_v_rows(const T* vp, size_t kv_row, int Skv, int D,
                            T* op, size_t q_row, int q0, int Sq) {
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < Skv; ++k) s += repro::to_f32(vp[k * kv_row + d]);
    const T m = repro::from_f32<T>(Skv > 0 ? s / Skv : 0.f);
    for (int r = q0; r < min(q0 + kBQ, Sq); ++r) op[r * q_row + d] = m;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         const int* __restrict__ kv_len, int Sq, int Skv,
                         int Hq, int Hkv, int q_offset, int causal,
                         float scale) {
  constexpr int LD = D + 4;     // padded row of the Q/K/V tiles
  constexpr int LDP = kBQ + 4;  // padded row of P (stored key-major)
  constexpr int NG = D / 64;    // 4-wide column groups per thread in P.V
  static_assert(kBK * LDP <= kBK * LD, "P must fit in the K tile");
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sK;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t q_row = static_cast<size_t>(Hq) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const float* qp = q + static_cast<size_t>(b) * Sq * q_row + h * D;
  const float* kp = k + static_cast<size_t>(b) * Skv * kv_row + hk * D;
  const float* vp = v + static_cast<size_t>(b) * Skv * kv_row + hk * D;
  float* op = o + static_cast<size_t>(b) * Sq * q_row + h * D;
  if (kv_len != nullptr && kv_len[b] <= 0) {
    mean_v_rows(vp, kv_row, Skv, D, op, q_row, q0, Sq);
    return;
  }

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, qr = q0 + r;
    sQ[r * LD + c] = qr < Sq ? qp[qr * q_row + c] : 0.f;
  }

  // keys this q block can see: [0, kv_hi)
  int kv_hi = Skv;
  if (kv_len != nullptr) kv_hi = min(kv_hi, kv_len[b]);
  if (causal) kv_hi = min(kv_hi, q_offset + min(q0 + kBQ, Sq));

  float m[4], l_run[4], acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's P and V are no longer read
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D, kr = k0 + r;
      const bool live = kr < kv_hi;
      sK[r * LD + c] = live ? kp[kr * kv_row + c] : 0.f;
      sV[r * LD + c] = live ? vp[kr * kv_row + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty * 4 + i) * LD + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * LD + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < kv_hi && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(rmax));
      float alpha = 1.f, psum = 0.f;
      if (m_new == -INFINITY) {  // no live key for this row yet
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      } else {
        alpha = expf(m[i] - m_new);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          psum += s[i][j];
        }
      }
      l_run[i] = l_run[i] * alpha + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading K before P lands there
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(tx + 16 * j) * LDP + ty * 4 + i] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(&sP[kk * LDP + ty * 4]);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&sV[kk * LD + g * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g * 4 + 0] += pr[i] * v4.x;
          acc[i][g * 4 + 1] += pr[i] * v4.y;
          acc[i][g * 4 + 2] += pr[i] * v4.z;
          acc[i][g * 4 + 3] += pr[i] * v4.w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= Sq) continue;
    const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        op[qr * q_row + g * 64 + tx * 4 + e] = acc[i][g * 4 + e] * inv;
  }
}

// ---- bf16 tensor-core kernel ----------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps x 16 q rows

// D += A (16x16, row) * B (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows x D bf16 tile from global rows `stride` apart into shared rows of LDS
// elements; rows >= n_live are zeros
template <int D, int LDS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int n_live) {
  constexpr int kVecs = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kBK * kVecs; i += kMmaThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n_live) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          const int* __restrict__ kv_len, int Sq, int Skv,
                          int Hq, int Hkv, int q_offset, int causal,
                          float scale) {
  constexpr int LDS = D + 8;  // padded bf16 row of the Q/K/V tiles
  constexpr int KS = D / 16;  // k-steps of S = Q K^T
  constexpr int DT = D / 8;   // n-tiles of O
  extern __shared__ uint4 smem_u4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_u4);
  bf16* sK = sQ + kBQ * LDS;
  bf16* sV = sK + kBK * LDS;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_row = static_cast<size_t>(Hq) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const bf16* qp = q + (static_cast<size_t>(b) * Sq + q0) * q_row + h * D;
  const bf16* kp = k + static_cast<size_t>(b) * Skv * kv_row + hk * D;
  const bf16* vp = v + static_cast<size_t>(b) * Skv * kv_row + hk * D;
  bf16* op = o + static_cast<size_t>(b) * Sq * q_row + h * D;
  if (kv_len != nullptr && kv_len[b] <= 0) {
    mean_v_rows(vp, kv_row, Skv, D, op, q_row, q0, Sq);
    return;
  }

  load_tile<D, LDS>(sQ, qp, q_row, Sq - q0);
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* base = sQ + r0 * LDS + ks * 16 + 2 * t;
    qf[ks][0] = ld32(base);
    qf[ks][1] = ld32(base + 8 * LDS);
    qf[ks][2] = ld32(base + 8);
    qf[ks][3] = ld32(base + 8 * LDS + 8);
  }

  int kv_hi = Skv;
  if (kv_len != nullptr) kv_hi = min(kv_hi, kv_len[b]);
  if (causal) kv_hi = min(kv_hi, q_offset + min(q0 + kBQ, Sq));

  float m[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int k0 = 0; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile<D, LDS>(sK, kp + k0 * kv_row, kv_row, kv_hi - k0);
    load_tile<D, LDS>(sV, vp + k0 * kv_row, kv_row, kv_hi - k0);
    __syncthreads();

    float s[kBK / 8][4];  // S fragments: 8 n-tiles of 8 keys
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const bf16* kb = sK + (nt * 8 + g) * LDS + ks * 16 + 2 * t;
        mma_bf16(s[nt], qf[ks], ld32(kb), ld32(kb + 8));
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows r0 (e = 0, 1) and r0 + 8 (2, 3)
      const int qpos = q_offset + q0 + r0 + 8 * r;
      float rmax = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = k0 + nt * 8 + 2 * t + c;
          const bool ok = kpos < kv_hi && (!causal || kpos <= qpos);
          float& x = s[nt][2 * r + c];
          x = ok ? x * scale : -INFINITY;
          rmax = fmaxf(rmax, x);
        }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      const float m_new = fmaxf(m[r], rmax);
      float alpha = 1.f, psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[nt][2 * r + c];
          x = m_new == -INFINITY ? 0.f : expf(x - m_new);
          psum += x;
        }
      if (m_new != -INFINITY) alpha = expf(m[r] - m_new);
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_run[r] = l_run[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // V^T fragments for two 8-wide d tiles per ldmatrix.x4.trans: lanes
      // 0-15 address keys kk*16 + 0..15 at d tile dt, lanes 16-31 at dt + 1
      const int key = kk * 16 + (lane & 15);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        const bf16* vb = sV + key * LDS + (dt + (lane >> 4)) * 8;
        const unsigned addr =
            static_cast<unsigned>(__cvta_generic_to_shared(vb));
        uint32_t r0v, r1v, r2v, r3v;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(r0v), "=r"(r1v), "=r"(r2v), "=r"(r3v)
            : "r"(addr));
        mma_bf16(acc[dt], pa, r0v, r1v);
        mma_bf16(acc[dt + 1], pa, r2v, r3v);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = q0 + r0 + 8 * r;
    if (qr >= Sq) continue;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(op + qr * q_row + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[dt][2 * r] * inv,
                                acc[dt][2 * r + 1] * inv);
  }
}

// ---- launch -----------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *configured = e == cudaSuccess;
  return e;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const int* kv_len, int B, int Sq, int Skv, int Hq,
                       int Hkv, int q_offset, int causal, float scale,
                       cudaStream_t stream) {
  static bool configured = false;
  cudaError_t e = allow_smem(flash_fwd_f32_kernel<D>, smem_bytes_f32<D>(),
                             &configured);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem_bytes_f32<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), kv_len, Sq, Skv,
      Hq, Hkv, q_offset, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        const int* kv_len, int B, int Sq, int Skv, int Hq,
                        int Hkv, int q_offset, int causal, float scale,
                        cudaStream_t stream) {
  static bool configured = false;
  cudaError_t e = allow_smem(flash_fwd_bf16_kernel<D>, smem_bytes_bf16<D>(),
                             &configured);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_bf16_kernel<D>
      <<<grid, kMmaThreads, smem_bytes_bf16<D>(), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(o), kv_len, Sq, Skv,
          Hq, Hkv, q_offset, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// kv_len: (B,) int32 on the device, or null. bf16 tensors must be 16-byte
// aligned (whole-row vector loads).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const void* kv_len, int B, int Sq,
                                      int Skv, int Hq, int Hkv, int D,
                                      int q_offset, int causal, float scale,
                                      int bf16_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kl = static_cast<const int*>(kv_len);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  if (Hkv <= 0 || Hq % Hkv != 0 ||
      (D != 64 && D != 128 && !(bf16_in && D == 112)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (bf16_in)
    e = D == 64    ? launch_bf16<64>(q, k, v, o, kl, B, Sq, Skv, Hq, Hkv,
                                     q_offset, causal, scale, s)
        : D == 112 ? launch_bf16<112>(q, k, v, o, kl, B, Sq, Skv, Hq, Hkv,
                                      q_offset, causal, scale, s)
                   : launch_bf16<128>(q, k, v, o, kl, B, Sq, Skv, Hq, Hkv,
                                      q_offset, causal, scale, s);
  else
    e = D == 64 ? launch_f32<64>(q, k, v, o, kl, B, Sq, Skv, Hq, Hkv,
                                 q_offset, causal, scale, s)
                : launch_f32<128>(q, k, v, o, kl, B, Sq, Skv, Hq, Hkv,
                                  q_offset, causal, scale, s);
  return static_cast<int>(e);
}
