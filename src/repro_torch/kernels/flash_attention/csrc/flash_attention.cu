// Kernel B2: GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas` in
// src/repro/kernels/flash_attention/flash_attention.py:76 (body
// `_flash_kernel`), and also covers what that kernel could not take: a
// runtime `q_offset` and per-sequence `kv_len`, so the engine's chunked
// prefill runs here too (the JAX engine used the jnp reference for it).
//
// Under autograd the forward also writes each query row's logsumexp, which
// the backward (flash_attention_bwd.cu) reads instead of recomputing it:
//   lse: (B, Hq, Sq) fp32, in natural-log units of the scaled scores,
//   lse[b, h, i] = log(sum over the keys row i sees of exp(scale q_i.k_j)),
//   and +inf for a row that sees no key (kv_len[b] == 0), so that the
//   backward's exp(scale q.k - lse) is 0 on every key of such a row.
// Without the pointer (inference) nothing is written and nothing changes.
//
//   q: (B, Sq, Hq, D), k/v: (B, Skv, Hkv, D), out: (B, Sq, Hq, D), one type
//   (fp32 or bf16), Hq % Hkv == 0, D in {64, 128}, or 112 in bf16 (the
//   head of zamba2-7b's shared attention block). Query row i sits at
//   position q_offset + i; with `causal` it sees keys at positions <= its
//   own; keys at or past kv_len[b] (when given) are masked. A sequence
//   with kv_len[b] == 0 sees no key and gets the plain version's answer,
//   the mean of V over all Skv keys (C7).
//
// What bounds it on the H100: bytes. Causal bf16 prefill at the 1024
// bucket (llama2-7b, 32 heads of 128) reads q, k, v once and writes o:
// 33.6 MB, 0.010 ms at 3.35 TB/s, against 8.6 GFLOP of products, 0.0087
// ms at 989 TFLOP/s. The two are close, so the kernel has to keep the
// tensor cores fed while the tiles stream in, and spend few instructions
// around them.
//
// bf16 (every prefill bucket; the tensor cores), warp-specialised and
// persistent:
//   - A tile is 64 * NC q rows of one (head, batch): NC consumer
//     warpgroups of 64 rows each and one producer warpgroup a CTA. The
//     wrapper picks NC = 2 (one CTA an SM) when that still gives a tile
//     for every SM, else NC = 1 (two CTAs an SM). One CTA for every slot
//     the card can hold resident; tiles are ordered heaviest first (the
//     causal diagonal makes the last q tile the longest) and dealt to the
//     CTAs in snake order, which evens out their work.
//   - The producer (one thread) loads each tile's Q and K/V tiles of 64
//     keys into a ring of STAGES stages with TMA (cp.async.bulk.tensor on
//     4-d tensor maps (D, H, S, B) built per call on the host), 128-byte
//     swizzled in 64-column panels. Each load completes on an mbarrier;
//     consumers hand a stage (and the Q tile) back through a second set,
//     so the next tile's Q and K/V load while the last products and the
//     store of this one run. D = 112 is two panels: TMA zero-fills columns
//     112-127 of the second, the products never read them. K/V tiles past
//     the causal diagonal and kv_len are never loaded.
//   - Each consumer warpgroup computes S = Q K^T with wgmma (Q and K read
//     from shared memory through descriptors, fp32 accumulators), keeps
//     the online softmax in fp32 registers with exp2 (ex2.approx.ftz) and
//     a log2(e)-folded scale (within the bf16 tolerance of the plain
//     version), masks only the tiles that cross the diagonal or kv_len,
//     re-packs P to bf16 in registers (as the reference casts p to v's
//     type) and adds P V with wgmma, P from registers and V read MN-major
//     from shared memory (no transpose). S of tile i and P V of tile i - 1
//     are issued together, so tile i's softmax overlaps that product, and
//     the two warpgroups of a CTA issue their products in turns (named
//     barriers), so one's softmax overlaps the other's products.
//     setmaxnreg hands the producer's registers to the consumers.
//   - O is normalised into a swizzled shared-memory tile and written by
//     TMA stores, clipped at Sq and D.
// fp32 (the engine's chunked prefill, in fp32 as in the reference; no fp32
// tensor-core product without TF32 rounding): one CTA of 256 threads per
// (64-row q block, q head, batch) walking 64-key tiles, each thread owning
// a 4x4 block of the score tile and a 4 x D/16 slice of the output, plain
// fp32 FMAs on the CUDA cores, tiles padded by 4 floats.
#include <cuda.h>

#include "common.cuh"
#include "launch.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// A query row that sees no key (kv_len[b] <= 0): the plain versions
// softmax Skv logits of -1e30 each, which is uniform, so every row of the
// block is the mean of V over all Skv keys (C7). Its logsumexp (when `lp`,
// the row's head in `lse`, is given) is the +inf that marks such a row.
template <typename T>
__device__ void mean_v_rows(const T* vp, size_t kv_row, int Skv, int D,
                            T* op, size_t q_row, float* lp, int r0, int r1,
                            int tid, int n_threads) {
  for (int d = tid; d < D; d += n_threads) {
    float s = 0.f;
    for (int k = 0; k < Skv; ++k) s += repro::to_f32(vp[k * kv_row + d]);
    const T m = repro::from_f32<T>(Skv > 0 ? s / Skv : 0.f);
    for (int r = r0; r < r1; ++r) op[r * q_row + d] = m;
  }
  if (lp != nullptr)
    for (int r = r0 + tid; r < r1; r += n_threads) lp[r] = INFINITY;
}

// ---- fp32 kernel (CUDA cores) -------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <int D>
constexpr int smem_bytes_f32() {
  return (kBQ + 2 * kBK) * (D + 4) * static_cast<int>(sizeof(float));
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse,
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
  float* lp = lse != nullptr ? lse + (static_cast<size_t>(b) * Hq + h) * Sq
                             : nullptr;
  if (kv_len != nullptr && kv_len[b] <= 0) {
    mean_v_rows(vp, kv_row, Skv, D, op, q_row, lp, q0, min(q0 + kBQ, Sq),
                threadIdx.x, blockDim.x);
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
    if (lp != nullptr && tx == 0)
      lp[qr] = l_run[i] > 0.f ? m[i] + logf(l_run[i]) : INFINITY;
  }
}

// ---- bf16 kernel (TMA ring + wgmma) -------------------------------------

namespace sm90 = repro::sm90;

constexpr int kPanelCols = 64;  // bf16 columns of one 128-byte swizzled row

template <bool B>
struct Bool {
  static constexpr bool value = B;
};

template <int D, int NC>
struct TcConfig {
  static constexpr int BQ = 64 * NC;             // q rows of a CTA
  static constexpr int BK = 64;                  // keys of a K/V tile
  static constexpr int NP = (D + kPanelCols - 1) / kPanelCols;  // panels
  static constexpr int KS = D / 16;              // k-steps of S = Q K^T
  static constexpr int STAGES = NC == 2 ? 3 : 2;  // K/V ring depth
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int Q_ELEMS = BQ * NP * kPanelCols;
  static constexpr int KV_ELEMS = BK * NP * kPanelCols;  // one K or V tile
  static constexpr int Q_BYTES = Q_ELEMS * 2;
  static constexpr int KV_BYTES = KV_ELEMS * 2;
  // full and empty Q, full K, full V, empty K/V
  static constexpr int N_BARS = 2 + 3 * STAGES;
  // Q and O tiles, the K/V ring, the barriers, and 1024 bytes of slack to
  // align the swizzle atoms
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES +
                              N_BARS * 8;
  // registers a thread: the launch grants 65536 / THREADS (168 at NC = 2,
  // 128 at NC = 1 with two CTAs an SM); the producer gives most of its
  // share to the consumers
  static constexpr uint32_t PRODUCER_REGS = 24;
  static constexpr uint32_t CONSUMER_REGS = NC == 2 ? 240 : 232;
  static constexpr int MIN_BLOCKS = NC == 2 ? 1 : 2;
};

// 2^x on the special-function unit, subnormal results flushed to zero (a
// probability below 2^-126 is 0 in bf16 all the same).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Issue S = Q K^T for one warpgroup's 64 rows and one K tile (not
// committed): both operands K-major, KS k-steps of 16 columns, four to a
// 64-column panel.
template <typename C>
__device__ __forceinline__ void issue_s(float (&sc)[C::BK / 2],
                                        const bf16* sQw, const bf16* kt) {
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) {
    const int p = ks / 4, c = (ks % 4) * 16;
    sm90::wgmma_ss<C::BK>(
        sc, sm90::desc_sw128(sQw + p * C::BQ * kPanelCols + c, 16, 1024),
        sm90::desc_sw128(kt + p * C::BK * kPanelCols + c, 16, 1024), ks > 0);
  }
}

// Issue O += P V (not committed): V (keys x D) is MN-major, 16 keys a
// k-step (2048 bytes), its 64-column panels BK * 128 bytes apart.
template <typename C, int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[C::BK / 16][4],
                                         const bf16* vt) {
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
    sm90::wgmma_rs<D>(
        acc, pa[kk],
        sm90::desc_sw128(vt + kk * 16 * kPanelCols, C::BK * 128, 1024));
}

// Online softmax of one S tile in place: sc[4j + 2r + e] is row r0 + 8r,
// key k0 + 8j + 2t + e, and row r0 + 8r sees keys below lim[r] (kv_len
// and, if causal, its position). With MASK (tiles that cross a limit),
// keys past lim are masked by a select on every element, not a branch: a
// branch while a product runs makes ptxas serialise the products. Updates
// the row max m (log2 units) and this thread's share of the row sum;
// returns the factors O's rows are rescaled by.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0,
                                             const int (&lim)[2], int t,
                                             float scale_log2) {
  if (MASK) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int kpos = k0 + 8 * j + 2 * t + (x & 1);
        sc[4 * j + x] = kpos < lim[x >> 1] ? sc[4 * j + x] : -INFINITY;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale_log2);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = fast_exp2(m[r] - m_use);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * r + e];
        x = fast_exp2(fmaf(x, scale_log2, -m_use));
        psum += x;
      }
    l[r] = l[r] * alpha[r] + psum;
    m[r] = m_new;
  }
}

// P as bf16 A fragments of wgmma, one per 16 keys.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// Tile L of n_tiles, heaviest first: all (head, batch) pairs at the last
// q tile, then at the one before it, and so on. CTA c of G takes tile c of
// each round of G tiles in even rounds and tile G - 1 - c in odd ones, so
// the CTA with the heaviest tile of one round gets the lightest of the
// next.
__device__ __forceinline__ int snake(int round) {
  return round * gridDim.x +
         ((round & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

struct Tile {
  int h, b, q0;
};

__device__ __forceinline__ Tile tile_at(int L, int n_qt, int Hq, int B,
                                        int BQ) {
  const int hb = L % (Hq * B);
  return {hb % Hq, hb / Hq, (n_qt - 1 - L / (Hq * B)) * BQ};
}

template <int D, int NC>
__global__ void __launch_bounds__(TcConfig<D, NC>::THREADS,
                                  TcConfig<D, NC>::MIN_BLOCKS)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_o,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse,
                          const int* __restrict__ kv_len, int B, int Sq,
                          int Skv, int Hq, int Hkv, int q_offset, int causal,
                          float scale_log2) {
  using C = TcConfig<D, NC>;
  constexpr int ST = C::STAGES, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(base);
  uint8_t* sO = base + C::Q_BYTES;
  bf16* sK = sQ + 2 * C::Q_ELEMS;
  bf16* sV = sK + ST * C::KV_ELEMS;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + ST * C::KV_ELEMS);
  uint64_t* empty_q = full_q + 1;
  uint64_t* full_k = empty_q + 1;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty = full_v + ST;

  const int n_qt = (Sq + C::BQ - 1) / C::BQ;
  const int n_tiles = n_qt * Hq * B;
  const int group = Hq / Hkv;
  const size_t q_row = static_cast<size_t>(Hq) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  // keys the q rows [q0, q0 + rows) of batch b can see: [0, kv_hi)
  auto keys = [&](int b, int q0, int rows) {
    const int kvl = kv_len != nullptr ? kv_len[b] : Skv;
    const int kv_lim = min(Skv, kvl);
    return causal ? min(kv_lim, q_offset + min(q0 + rows, Sq)) : kv_lim;
  };

  if (threadIdx.x == 0) {
    sm90::mbar_init(full_q, 1);
    sm90::mbar_init(empty_q, NC * 4);  // one arrival a consumer warp
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty[s], NC * 4);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // The CTA walks its tiles in snake order. Both roles count the
  // Q tiles (nq) and K/V tiles (it) they have passed, which give every
  // barrier's stage and phase. A tile whose sequence sees no key (kv_len
  // 0) loads nothing: its consumers write the mean of V (C7).
  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ---- producer warpgroup: one thread issues every TMA load ----------
    sm90::regs_dealloc<C::PRODUCER_REGS>();
    if (threadIdx.x == NC * 128) {
      sm90::prefetch_tmap(&tm_q);
      sm90::prefetch_tmap(&tm_k);
      sm90::prefetch_tmap(&tm_v);
      int it = 0, nq = 0;
      for (int round = 0; round * gridDim.x < n_tiles; ++round) {
        const int L = snake(round);
        if (L >= n_tiles) continue;
        const Tile tl = tile_at(L, n_qt, Hq, B, C::BQ);
        if (kv_len != nullptr && kv_len[tl.b] <= 0) continue;
        const int n_kv = (keys(tl.b, tl.q0, C::BQ) + BK - 1) / BK;
        // the previous Q tile is free once both warpgroups' S are done
        if (nq > 0) sm90::mbar_wait(empty_q, (nq - 1) & 1);
        sm90::mbar_expect_tx(full_q, C::Q_BYTES);
        for (int p = 0; p < C::NP; ++p)
          sm90::tma_load_4d(sQ + p * C::BQ * kPanelCols, &tm_q, full_q,
                            p * kPanelCols, tl.h, tl.q0, tl.b);
        ++nq;
        const int hk = tl.h / group;
        for (int i = 0; i < n_kv; ++i, ++it) {
          const int s = it % ST;
          // stage s last held K/V tile it - ST: wait until it is handed back
          if (it >= ST) sm90::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          sm90::mbar_expect_tx(&full_k[s], C::KV_BYTES);
          for (int p = 0; p < C::NP; ++p)
            sm90::tma_load_4d(sK + s * C::KV_ELEMS + p * BK * kPanelCols,
                              &tm_k, &full_k[s], p * kPanelCols, hk, i * BK,
                              tl.b);
          sm90::mbar_expect_tx(&full_v[s], C::KV_BYTES);
          for (int p = 0; p < C::NP; ++p)
            sm90::tma_load_4d(sV + s * C::KV_ELEMS + p * BK * kPanelCols,
                              &tm_v, &full_v[s], p * kPanelCols, hk, i * BK,
                              tl.b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: q rows q0 + 64 wg .. + 63 of each tile --
    sm90::regs_alloc<C::CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int t = lane % 4;
    const int wr = (tid / 32) * 16 + lane / 4;  // rows wr, wr + 8 of the 64
    const bf16* sQw = sQ + wg * 64 * kPanelCols;
    uint8_t* sOw = sO + wg * 64 * 128;
    // With two consumer warpgroups, each one's products go in turns with
    // the other's (named barriers 3 and 4), so one's softmax runs while the
    // other's products hold the tensor cores. Both take n_kv + 1 turns in
    // every tile, so the turns alternate across tiles too: warpgroup 1
    // opens once, and warpgroup 0 takes the last hand-over at the end.
    constexpr bool kTurns = NC == 2;
    auto turn_begin = [&] {
      if (kTurns) sm90::named_bar_sync(3 + wg, 256);
    };
    auto turn_end = [&] {
      if (kTurns) sm90::named_bar_arrive(3 + (wg ^ 1), 256);
    };

    if (kTurns && wg == 1) sm90::named_bar_arrive(3, 256);
    int it = 0, nq = 0;
    for (int round = 0; round * gridDim.x < n_tiles; ++round) {
      const int L = snake(round);
      if (L >= n_tiles) continue;
      const Tile tl = tile_at(L, n_qt, Hq, B, C::BQ);
      const int wq0 = tl.q0 + wg * 64;  // this warpgroup's first row
      float* lp = lse != nullptr
                      ? lse + (static_cast<size_t>(tl.b) * Hq + tl.h) * Sq
                      : nullptr;
      if (kv_len != nullptr && kv_len[tl.b] <= 0) {
        const int hk = tl.h / group;
        mean_v_rows(v + static_cast<size_t>(tl.b) * Skv * kv_row + hk * D,
                    kv_row, Skv, D,
                    o + static_cast<size_t>(tl.b) * Sq * q_row + tl.h * D,
                    q_row, lp, wq0, min(wq0 + 64, Sq), tid, 128);
        continue;
      }
      const int kv_lim = min(Skv, kv_len != nullptr ? kv_len[tl.b] : Skv);
      const int n_kv = (keys(tl.b, tl.q0, C::BQ) + BK - 1) / BK;
      const int n_wg = (keys(tl.b, wq0, 64) + BK - 1) / BK;  // <= n_kv
      // keys each of this thread's rows can see; tiles [0, n_plain) lie
      // below every row's limit and need no mask
      const int r0 = wq0 + wr;
      const int lim[2] = {causal ? min(kv_lim, q_offset + r0 + 1) : kv_lim,
                          causal ? min(kv_lim, q_offset + r0 + 9) : kv_lim};
      const int n_plain = min(
          n_wg, (causal ? min(kv_lim, q_offset + wq0 + 1) : kv_lim) / BK);

      float acc[D / 2];  // O, 64 x D over the warpgroup
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, alpha[2];
      float sc[BK / 2];         // S of the newest tile, 64 x BK
      uint32_t pa[BK / 16][4];  // P of the tile before it, bf16

      // Tile 0's S and softmax; then each step issues S of K/V tile i and
      // P V of tile i - 1 together, so tile i's softmax overlaps that
      // product.
      sm90::mbar_wait(full_q, nq & 1);
      sm90::mbar_wait(&full_k[it % ST], (it / ST) & 1);
      turn_begin();
      sm90::wgmma_fence();
      issue_s<C>(sc, sQw, sK + (it % ST) * C::KV_ELEMS);
      sm90::wgmma_commit();
      turn_end();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      softmax_tile<BK, true>(sc, m, l_run, alpha, 0, lim, t, scale_log2);
      pack_p<BK>(sc, pa);
      auto step = [&](int i, auto masked) {
        const int s = (it + i) % ST, sp = (it + i - 1) % ST;
        // both waits before the products: no branch while they run
        sm90::mbar_wait(&full_k[s], ((it + i) / ST) & 1);
        sm90::mbar_wait(&full_v[sp], ((it + i - 1) / ST) & 1);
        turn_begin();
        sm90::wgmma_fence();
        issue_s<C>(sc, sQw, sK + s * C::KV_ELEMS);
        sm90::wgmma_commit();
        issue_pv<C, D>(acc, pa, sV + sp * C::KV_ELEMS);
        sm90::wgmma_commit();
        turn_end();
        sm90::wgmma_wait<1>();  // S of tile i is in; P V may still run
        sm90::fence_regs(sc);
        softmax_tile<BK, decltype(masked)::value>(sc, m, l_run, alpha,
                                                  i * BK, lim, t, scale_log2);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[sp]);  // tile i - 1 is done
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 0] *= alpha[0];
          acc[4 * j + 1] *= alpha[0];
          acc[4 * j + 2] *= alpha[1];
          acc[4 * j + 3] *= alpha[1];
        }
        pack_p<BK>(sc, pa);
      };
      int i = 1;
      for (; i < n_plain; ++i) step(i, Bool<false>{});
      for (; i < n_wg; ++i) step(i, Bool<true>{});
      // every S of this warpgroup is done: its rows of Q may be replaced
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty_q);
      {
        const int sp = (it + n_wg - 1) % ST;
        sm90::mbar_wait(&full_v[sp], ((it + n_wg - 1) / ST) & 1);
        turn_begin();
        sm90::wgmma_fence();
        issue_pv<C, D>(acc, pa, sV + sp * C::KV_ELEMS);
        sm90::wgmma_commit();
        turn_end();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[sp]);
      }
      // K/V tiles past this warpgroup's rows (the other warpgroup reads
      // them): hand them back once they have landed, keeping the turns
      for (int j = n_wg; j < n_kv; ++j) {
        const int s = (it + j) % ST;
        sm90::mbar_wait(&full_k[s], ((it + j) / ST) & 1);
        sm90::mbar_wait(&full_v[s], ((it + j) / ST) & 1);
        turn_begin();
        turn_end();
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
      }
      it += n_kv;
      ++nq;

      // O, normalised, into this warpgroup's 64 rows of sO, swizzled as TMA
      // writes Q so that a warp's 4-byte writes hit 32 distinct banks (once
      // the previous tile's store has read them); then one TMA store a
      // panel, clipped at Sq (and at D = 112)
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = l > 0.f ? 1.f / l : 0.f;
        // the row's logsumexp: m is in log2 units of the scaled scores
        const int row = wq0 + wr + 8 * r;
        if (lp != nullptr && t == 0 && row < Sq)
          lp[row] = l > 0.f ? (m[r] + log2f(l)) * 0.6931471805599453f
                            : INFINITY;
      }
      if (tid == 0) sm90::tma_store_wait_read();
      sm90::named_bar_sync(1 + wg, 128);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = wr + 8 * r;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(sOw + (j / 8) * C::BQ * 128 +
                                       rr * 128 +
                                       (((j % 8) ^ (rr & 7)) << 4) + 4 * t) =
              pack_bf16(acc[4 * j + 2 * r] * inv[r],
                        acc[4 * j + 2 * r + 1] * inv[r]);
      }
      sm90::fence_async_shared();
      sm90::named_bar_sync(1 + wg, 128);
      if (tid == 0 && wq0 < Sq) {
        for (int p = 0; p < C::NP; ++p)
          sm90::tma_store_4d(&tm_o, sOw + p * C::BQ * 128, p * kPanelCols,
                             tl.h, wq0, tl.b);
        sm90::tma_store_commit();
      }
    }
    if (kTurns && wg == 0) sm90::named_bar_sync(3, 256);
    if (tid == 0) sm90::tma_store_wait_read();  // sO outlives its readers
  }
}

// ---- launch -----------------------------------------------------------------

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, const int* kv_len, int B, int Sq, int Skv,
                       int Hq, int Hkv, int q_offset, int causal, float scale,
                       cudaStream_t stream) {
  static bool configured = false;
  cudaError_t e = sm90::allow_smem(flash_fwd_f32_kernel<D>,
                                   smem_bytes_f32<D>(), &configured);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem_bytes_f32<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, kv_len, Sq,
      Skv, Hq, Hkv, q_offset, causal, scale);
  return cudaGetLastError();
}

template <int D, int NC>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, const int* kv_len, int B, int Sq,
                        int Skv, int Hq, int Hkv, int q_offset, int causal,
                        float scale, cudaStream_t stream) {
  using C = TcConfig<D, NC>;
  static bool configured = false;
  cudaError_t e =
      sm90::allow_smem(flash_fwd_bf16_kernel<D, NC>, C::SMEM, &configured);
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv, to;
  if ((e = sm90::tensor_map(&tq, q, B, Sq, Hq, D, C::BQ)) != cudaSuccess ||
      (e = sm90::tensor_map(&to, o, B, Sq, Hq, D, 64)) != cudaSuccess ||
      (e = sm90::tensor_map(&tk, k, B, Skv, Hkv, D, C::BK)) !=
          cudaSuccess ||
      (e = sm90::tensor_map(&tv, v, B, Skv, Hkv, D, C::BK)) != cudaSuccess)
    return e;
  // one CTA for every slot the card can hold resident, each walking tiles
  static int slots = 0;
  if (slots == 0) {
    int dev, sms, per_sm;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, flash_fwd_bf16_kernel<D, NC>, C::THREADS, C::SMEM)) !=
            cudaSuccess)
      return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    slots = sms * per_sm;
  }
  const int n_tiles = (Sq + C::BQ - 1) / C::BQ * Hq * B;
  flash_fwd_bf16_kernel<D, NC>
      <<<min(n_tiles, slots), C::THREADS, C::SMEM, stream>>>(
          tq, tk, tv, to, static_cast<const bf16*>(v), static_cast<bf16*>(o),
          lse, kv_len, B, Sq, Skv, Hq, Hkv, q_offset, causal,
          scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16_tile(int block_q, const void* q, const void* k,
                             const void* v, void* o, float* lse,
                             const int* kv_len, int B, int Sq, int Skv,
                             int Hq, int Hkv, int q_offset, int causal,
                             float scale, cudaStream_t stream) {
  return block_q == 128
             ? launch_bf16<D, 2>(q, k, v, o, lse, kv_len, B, Sq, Skv, Hq,
                                 Hkv, q_offset, causal, scale, stream)
             : launch_bf16<D, 1>(q, k, v, o, lse, kv_len, B, Sq, Skv, Hq,
                                 Hkv, q_offset, causal, scale, stream);
}

}  // namespace

// kv_len: (B,) int32 on the device, or null; lse: (B, Hq, Sq) fp32, or
// null. Tensors must be 16-byte aligned. block_q (64 or 128) is the bf16
// kernel's q tile, chosen by the wrapper; the fp32 kernel always takes 64
// rows. bf16 needs Skv >= 1 (a tensor map has no empty dimension).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      const void* kv_len, int B, int Sq,
                                      int Skv, int Hq, int Hkv, int D,
                                      int q_offset, int causal, float scale,
                                      int block_q, int bf16_in,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kl = static_cast<const int*>(kv_len);
  float* lp = static_cast<float*>(lse);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  if (Hkv <= 0 || Hq % Hkv != 0 ||
      (D != 64 && D != 128 && !(bf16_in && D == 112)) ||
      (bf16_in && (Skv <= 0 || (block_q != 64 && block_q != 128))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (bf16_in)
    e = D == 64    ? launch_bf16_tile<64>(block_q, q, k, v, o, lp, kl, B, Sq,
                                          Skv, Hq, Hkv, q_offset, causal,
                                          scale, s)
        : D == 112 ? launch_bf16_tile<112>(block_q, q, k, v, o, lp, kl, B,
                                           Sq, Skv, Hq, Hkv, q_offset,
                                           causal, scale, s)
                   : launch_bf16_tile<128>(block_q, q, k, v, o, lp, kl, B,
                                           Sq, Skv, Hq, Hkv, q_offset,
                                           causal, scale, s);
  else
    e = D == 64 ? launch_f32<64>(q, k, v, o, lp, kl, B, Sq, Skv, Hq, Hkv,
                                 q_offset, causal, scale, s)
                : launch_f32<128>(q, k, v, o, lp, kl, B, Sq, Skv, Hq, Hkv,
                                  q_offset, causal, scale, s);
  return static_cast<int>(e);
}
