// Kernel B1: paged decode attention (flash-decoding over a page pool) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention_pallas` in
// src/repro/kernels/decode_attention/decode_attention.py (body
// `_decode_kernel`).
//
//   q: (B, Hq, D); k/v pages: (n_pages, page, Hkv, D), q's type (the
//   engine's pool is fp32; bf16 is accepted too); block_table:
//   (B, max_pages) int32; lengths: (B,) int32; out: (B, Hq, D); D in
//   {64, 128}; G = Hq / Hkv <= 8. For each sequence b and query head h,
//   softmax(q.k / sqrt(D)) . v over positions [0, lengths[b]) of the pages
//   block_table[b, :]. Entries past the length are never read (the engine
//   points them at its null page 0), except for a sequence of length 0,
//   which gets the plain version's answer: the mean of V over every page
//   of its row of the block table.
//
// What bounds it on the H100: device-memory bytes. Each live K/V element
// is used by the G query heads of its group, ~2*G flops per element read,
// far below the balance point. The floor is (bytes of the live tokens' K/V
// + q + out) / 3.35 TB/s.
//
// Design: one 256-thread CTA per (kv head, sequence); the G query heads of
// the GQA group share every K/V read. The CTA walks the sequence in tiles
// of 64 positions, looking each position's page up in block_table[b, :]
// itself and masking the ragged tail. The 8 warps split a tile's positions
// (8 each) and the lanes split D, so a K or V row is one coalesced read of
// D contiguous values, and each warp issues its 8 rows' loads before using
// them: that keeps ~32 KB per CTA in flight, which is what a memory-bound
// kernel needs. Scores go through shared memory to one warp per query row
// for the fp32 online softmax (max m, normaliser l_run); each warp keeps
// its own fp32 partial P.V for its positions in registers, rescaled with
// the shared running max, and the 8 partials are summed at the end. One CTA
// per (b, kv head) leaves SMs idle at batch 1; splitting the walk across
// CTAs is later work.
#include "common.cuh"
#include "launch.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;
using repro::warp_max;
using repro::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                  // positions per step
constexpr int kPerWarp = kTile / kWarps;   // positions per warp per step
constexpr int kMaxG = 8;                   // query heads per kv head

template <int BYTES>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = unsigned int; };

// N consecutive elements starting at p (aligned to N * sizeof(T)) as fp32
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float* out) {
  using R = typename Raw<N * sizeof(T)>::type;
  const R raw = *reinterpret_cast<const R*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool, T* __restrict__ out,
                        const int* __restrict__ block_table,
                        const int* __restrict__ lengths, int Hq, int Hkv,
                        int page, int max_pages, float scale) {
  constexpr int VPT = D / 32;              // elements of a row per lane
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ float sS[kMaxG][kTile];       // scores, then probabilities
  __shared__ float sM[kMaxG], sL[kMaxG], sAlpha[kMaxG];
  __shared__ float sRed[kWarps][D];

  const size_t q_base = (static_cast<size_t>(b) * Hq + hk * G) * D;
  float qr[kMaxG][VPT], acc[kMaxG][VPT];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) load_row<T, VPT>(q + q_base + g * D + lane * VPT, qr[g]);
#pragma unroll
    for (int e = 0; e < VPT; ++e) acc[g][e] = 0.f;
  }
  if (threadIdx.x < kMaxG) {
    sM[threadIdx.x] = -INFINITY;
    sL[threadIdx.x] = 0.f;
  }

  int len = lengths[b];
  len = len < max_pages * page ? len : max_pages * page;
  const int* bt = block_table + static_cast<size_t>(b) * max_pages;
  const size_t tok_stride = static_cast<size_t>(Hkv) * D;
  const size_t head_off = static_cast<size_t>(hk) * D + lane * VPT;
  if (len <= 0) {
    // no visible position (C7): the plain version softmaxes the
    // max_pages * page gathered logits, all -1e30, to uniform weights, so
    // each query head of the group gets the mean of the gathered V rows
    const int n_pos = max_pages * page;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float s = 0.f;
      for (int p = 0; p < n_pos; ++p)
        s += to_f32(vpool[(static_cast<size_t>(bt[p / page]) * page +
                           p % page) * tok_stride + hk * D + d]);
      const T m = from_f32<T>(s / n_pos);
      for (int g = 0; g < G; ++g) out[q_base + g * D + d] = m;
    }
    return;
  }

  for (int t0 = 0; t0 < len; t0 += kTile) {
    // rows this warp owns in the tile: positions t0 + warp + kWarps * i
    size_t row[kPerWarp];
    bool live[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int pos = t0 + warp + kWarps * i;
      live[i] = pos < len;
      const int p = live[i] ? pos : 0;
      row[i] = (static_cast<size_t>(bt[p / page]) * page + p % page) *
                   tok_stride + head_off;
    }

    float kv[kPerWarp][VPT];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i)
      if (live[i]) load_row<T, VPT>(kpool + row[i], kv[i]);
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VPT; ++e) dot += qr[g][e] * kv[i][e];
        dot = warp_sum(dot);
        if (lane == 0)
          sS[g][warp + kWarps * i] = live[i] ? dot * scale : -INFINITY;
      }
    }
    __syncthreads();

    // one warp per query row: running max, probabilities, normaliser
    if (warp < G) {
      const int g = warp;
      const float s0 = sS[g][lane], s1 = sS[g][lane + 32];
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      sS[g][lane] = p0;
      sS[g][lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sAlpha[g] = alpha;
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPerWarp; ++i)
      if (live[i]) load_row<T, VPT>(vpool + row[i], kv[i]);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float alpha = sAlpha[g];
#pragma unroll
      for (int e = 0; e < VPT; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        if (!live[i]) continue;
        const float p = sS[g][warp + kWarps * i];
#pragma unroll
        for (int e = 0; e < VPT; ++e) acc[g][e] += p * kv[i][e];
      }
    }
    __syncthreads();  // sS and sAlpha are rewritten by the next tile
  }

  // sum the warps' partial P.V rows and normalise
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < VPT; ++e) sRed[warp][lane * VPT + e] = acc[g][e];
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += sRed[w][d];
      const float l_run = sL[g];
      out[q_base + g * D + d] = from_f32<T>(l_run > 0.f ? s / l_run : 0.f);
    }
    __syncthreads();
  }
}

template <typename T, int D>
void launch(const void* q, const void* k_pages, const void* v_pages,
            void* out, const int* bt, const int* ln, int B, int Hq, int Hkv,
            int page, int max_pages, float scale, cudaStream_t s) {
  paged_decode_kernel<T, D><<<dim3(Hkv, B), kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), bt, ln, Hq, Hkv,
      page, max_pages, scale);
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, void* out,
                                   const void* block_table,
                                   const void* lengths, int B, int Hq,
                                   int Hkv, int D, int page, int max_pages,
                                   float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || page <= 0 ||
      max_pages <= 0 || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* bt = static_cast<const int*>(block_table);
  const int* ln = static_cast<const int*>(lengths);
  using bf = __nv_bfloat16;
  if (bf16 && D == 64)
    launch<bf, 64>(q, k_pages, v_pages, out, bt, ln, B, Hq, Hkv, page,
                   max_pages, scale, s);
  else if (bf16)
    launch<bf, 128>(q, k_pages, v_pages, out, bt, ln, B, Hq, Hkv, page,
                    max_pages, scale, s);
  else if (D == 64)
    launch<float, 64>(q, k_pages, v_pages, out, bt, ln, B, Hq, Hkv, page,
                      max_pages, scale, s);
  else
    launch<float, 128>(q, k_pages, v_pages, out, bt, ln, B, Hq, Hkv, page,
                       max_pages, scale, s);
  return static_cast<int>(cudaGetLastError());
}
