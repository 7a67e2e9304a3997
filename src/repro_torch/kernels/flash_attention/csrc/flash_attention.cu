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
// What bounds the bf16 route on the H100: bytes. Causal bf16 prefill at the 1024
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
// fp32 (the engine's chunked prefill, in fp32 as in the reference), on the
// tensor cores at fp32 accuracy: each fp32 operand of S = Q K^T and of
// O = P V is split into a tf32 hi part and a tf32 remainder, and each
// product is taken as hi.hi + hi.lo + lo.hi with fp32 accumulation, three
// `mma.sync.m16n8k8` tf32 products where the plain version has one fp32
// product (`mma.sync`, not `wgmma`: wgmma takes tf32 B operands K-major
// only, and V lies D-major). What bounds it: at the chunked path's (Sq
// 256, Skv 768, q_offset 512), 32/32 heads of 128, it moves 33.6 MB (0.010
// ms at 3.35 TB/s) and does 2.69 GFLOP of products, 0.040 ms as fp32 FMAs
// at 67 TFLOP/s and 0.016 ms as three tf32 products at 495: the three tf32
// products bound it. The design (flash_fwd_f32_kernel below): a CTA of
// 256 threads a 64-row q tile, its two groups of four warps taking the
// 32-key tiles in turns through their own 16-byte `cp.async` rings of
// three stages, so two tiles load while one is multiplied; Q in shared
// memory; softmax in fp32 with expf; the groups' partial rows merged by
// their max and sum through shared memory at the end.
#include <cuda.h>

#include "common.cuh"
#include "launch.cuh"
#include "mma_sync.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = repro::sm90;

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

// ---- fp32 kernel (tensor cores, split tf32) -----------------------------

constexpr int kF32WarpsQ = 4;               // warps along q, 16 rows each
constexpr int kF32BQ = 16 * kF32WarpsQ;     // q rows of a CTA
constexpr int kF32BK = 32;                  // keys of a K/V tile
constexpr int kF32Groups = 2;               // key groups of a CTA
constexpr int kF32GroupThreads = 32 * kF32WarpsQ;
constexpr int kF32Threads = kF32Groups * kF32GroupThreads;
constexpr int kF32Stages = 3;               // K/V ring depth of a group

template <int D>
struct F32Config {
  static constexpr int Q_FLOATS = kF32BQ * D;      // the Q tile
  static constexpr int STAGE = 2 * kF32BK * D;     // a K and a V tile
  static constexpr int SMEM =
      (Q_FLOATS + kF32Groups * kF32Stages * STAGE) *
      static_cast<int>(sizeof(float));
  // what a lane of key group 1 hands to its twin in group 0: O, m, l
  static constexpr int XCH = D / 2 + 4;
  static_assert(kF32WarpsQ * XCH * 32 <= kF32Groups * kF32Stages * STAGE,
                "the hand-over must fit in the ring");
};

// Tiles are unpadded rows of D floats, their 16-byte chunks swizzled so
// that the fragment loads hit 32 distinct banks: chunk c of row r lies at
// chunk c ^ ((r & 1) << 2) of a Q or K tile (a quarter-warp reads rows g
// = 0, 1 at chunks 4p + t) and at c ^ (r & 6) of a V tile (rows 2t, chunks
// 8m + g).
__device__ __forceinline__ int swz_qk(int r, int c) {
  return c ^ ((r & 1) << 2);
}
__device__ __forceinline__ int swz_v(int r, int c) { return c ^ (r & 6); }

// acc_hi += a_hi b_hi; acc_lo += a_hi b_lo + a_lo b_hi: one fp32 product
// as three tf32 products, the small ones apart so that the three chains
// of an output tile overlap
__device__ __forceinline__ void mma3(float (&acc_hi)[4], float (&acc_lo)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  repro::mma_tf32(acc_lo, al, bh0, bh1);
  repro::mma_tf32(acc_lo, ah, bl0, bl1);
  repro::mma_tf32(acc_hi, ah, bh0, bh1);
}

// One CTA of 256 threads a (64-row q tile, q head, batch, key split),
// heaviest tile first. With kv_splits > 1 (the wrapper's choice when the
// q tiles alone leave SMs idle) split s of a q tile takes the s-th run of
// its 32-key tiles and writes its rows normalised, with their logsumexps,
// to `part`, and flash_fwd_f32_merge_kernel merges the splits. The Q tile
// lands in shared memory by cp.async; the CTA's two key groups of four
// warps (16 q rows a warp) take its K/V tiles in turns (group 0 the even
// ones), each through its own 3-stage cp.async ring and named barrier. At
// the end group 1 hands its O, row max and row sums to group 0 through
// shared memory, which merges them (the rows' logsumexps) and stores O.
//
// Fragments (mma_tf32; g = lane / 4, t = lane % 4). The reduction index
// of each product is permuted, which any product allows when both
// operands agree: S = Q K^T takes columns 16p + 4t + {0, 1} in k-step 2p
// and + {2, 3} in 2p + 1, so Q and K come in as float4s; P V takes key
// 2t as k-index t and 2t + 1 as t + 4, so S's accumulator is P's A
// fragment as it lies. The output columns of P V are permuted too: 8-wide
// tile 4m + c, index g, is column 32m + 4g + c, so a float4 of V feeds
// four tiles and a thread's O sits at columns 32m + 8t .. + 7 of its rows.
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse,
                         const int* __restrict__ kv_len,
                         float* __restrict__ part, int B, int Sq, int Skv,
                         int Hq, int Hkv, int q_offset, int causal,
                         float scale, int kv_splits) {
  using C = F32Config<D>;
  constexpr int NT = D / 8;        // 8-column tiles of O
  constexpr int KT = kF32BK / 8;   // 8-key tiles of S
  constexpr int CHUNKS = D / 4;    // 16-byte pieces of a K or V row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int n_qt = (Sq + kF32BQ - 1) / kF32BQ;
  const int split = blockIdx.x % kv_splits, tile = blockIdx.x / kv_splits;
  const int hb = tile % (Hq * B);
  const int h = hb % Hq, b = hb / Hq;
  const int q0 = (n_qt - 1 - tile / (Hq * B)) * kF32BQ;
  const int hk = h / (Hq / Hkv);
  const size_t q_row = static_cast<size_t>(Hq) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const float* qp = q + static_cast<size_t>(b) * Sq * q_row + h * D;
  const float* kp = k + static_cast<size_t>(b) * Skv * kv_row + hk * D;
  const float* vp = v + static_cast<size_t>(b) * Skv * kv_row + hk * D;
  float* op = o + static_cast<size_t>(b) * Sq * q_row + h * D;
  float* lp = lse != nullptr ? lse + (static_cast<size_t>(b) * Hq + h) * Sq
                             : nullptr;
  if (kv_len != nullptr && kv_len[b] <= 0) {  // the merge leaves these rows
    if (split == 0)
      mean_v_rows(vp, kv_row, Skv, D, op, q_row, lp, q0,
                  min(q0 + kF32BQ, Sq), threadIdx.x, blockDim.x);
    return;
  }
  // keys this q tile can see: [0, kv_hi), as n_tiles K/V tiles; this
  // split's: tiles [t_lo, t_lo + n_split_tiles)
  const int kv_lim = kv_len != nullptr ? min(Skv, kv_len[b]) : Skv;
  const int kv_hi =
      causal ? min(kv_lim, q_offset + min(q0 + kF32BQ, Sq)) : kv_lim;
  const int n_tiles = (kv_hi + kF32BK - 1) / kF32BK;
  const int per_split = (n_tiles + kv_splits - 1) / kv_splits;
  const int t_lo = split * per_split;
  const int n_split_tiles = max(0, min(n_tiles, t_lo + per_split) - t_lo);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / kF32WarpsQ, wq = warp % kF32WarpsQ;
  const int g = lane / 4, t = lane % 4;
  const int gtid = threadIdx.x % kF32GroupThreads;
  const int n_mine = (n_split_tiles - grp + kF32Groups - 1) / kF32Groups;
  float* sq = smem;
  float* ring = smem + C::Q_FLOATS + grp * kF32Stages * C::STAGE;

  // this group's j-th tile (key tile t_lo + grp + 2j) into stage j %
  // kF32Stages; keys at or past kv_hi arrive as zeros
  auto load = [&](int j) {
    float* sk = ring + (j % kF32Stages) * C::STAGE;
    float* sv = sk + kF32BK * D;
    const int k0 = (t_lo + grp + kF32Groups * j) * kF32BK;
    for (int i = gtid; i < kF32BK * CHUNKS; i += kF32GroupThreads) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool live = k0 + r < kv_hi;
      const size_t off = live ? (k0 + r) * kv_row + 4 * c : 0;
      repro::cp_async16(sk + r * D + 4 * swz_qk(r, c), kp + off,
                        live ? 16 : 0);
      repro::cp_async16(sv + r * D + 4 * swz_v(r, c), vp + off,
                        live ? 16 : 0);
    }
  };

  // the Q tile (rows past Sq as zeros), then each group's first tiles;
  // every thread waits for its own Q copies, the barrier for the others'
  for (int i = threadIdx.x; i < kF32BQ * CHUNKS; i += kF32Threads) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool live = q0 + r < Sq;
    repro::cp_async16(sq + r * D + 4 * swz_qk(r, c),
                      qp + (live ? (q0 + r) * q_row + 4 * c : 0),
                      live ? 16 : 0);
  }
  repro::cp_async_commit();
#pragma unroll
  for (int j = 0; j < kF32Stages - 1; ++j) {
    if (j < n_mine) load(j);
    repro::cp_async_commit();
  }
  repro::cp_async_wait<kF32Stages - 1>();
  __syncthreads();
  // this warp's rows of Q: row0 = wq * 16 + g and row0 + 8 of the tile
  const int row0 = q0 + wq * 16 + g;
  const float* sq0 = sq + (wq * 16 + g) * D;
  const float* sq1 = sq0 + 8 * D;

  // keys each of this thread's rows sees; tiles that end at or below the
  // limit of the warp's first row need no mask
  const int lim[2] = {causal ? min(kv_lim, q_offset + row0 + 1) : kv_lim,
                      causal ? min(kv_lim, q_offset + row0 + 9) : kv_lim};
  const int plain_end =
      causal ? min(kv_lim, q_offset + q0 + wq * 16 + 1) : kv_lim;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_mine; ++j) {
    // tile j has landed for every thread of the group, and every warp is
    // done with tile j - 1, whose stage now takes tile j + 2
    repro::cp_async_wait<kF32Stages - 2>();
    sm90::named_bar_sync(1 + grp, kF32GroupThreads);
    if (j + kF32Stages - 1 < n_mine) load(j + kF32Stages - 1);
    repro::cp_async_commit();
    const float* sk = ring + (j % kF32Stages) * C::STAGE;
    const float* sv = sk + kF32BK * D;
    const int k0 = (t_lo + grp + kF32Groups * j) * kF32BK;

    // S = Q K^T for 16 rows and 32 keys
    float sh[KT][4], sl[KT][4];
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sh[n][e] = sl[n][e] = 0.f;
#pragma unroll
    for (int p = 0; p < D / 16; ++p) {
      // columns 16p + 4t .. + 3 of rows row0 and row0 + 8, and of key 8n + g
      const int cq = 4 * swz_qk(g, 4 * p + t);
      const float4 qa = *reinterpret_cast<const float4*>(sq0 + cq);
      const float4 qb = *reinterpret_cast<const float4*>(sq1 + cq);
      uint32_t ah[2][4], al[2][4];
      repro::split_tf32(qa.x, ah[0][0], al[0][0]);
      repro::split_tf32(qb.x, ah[0][1], al[0][1]);
      repro::split_tf32(qa.y, ah[0][2], al[0][2]);
      repro::split_tf32(qb.y, ah[0][3], al[0][3]);
      repro::split_tf32(qa.z, ah[1][0], al[1][0]);
      repro::split_tf32(qb.z, ah[1][1], al[1][1]);
      repro::split_tf32(qa.w, ah[1][2], al[1][2]);
      repro::split_tf32(qb.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int n = 0; n < KT; ++n) {
        const float4 kv4 = *reinterpret_cast<const float4*>(
            sk + (8 * n + g) * D + cq);
        uint32_t bh[4], bl[4];
        repro::split_tf32(kv4.x, bh[0], bl[0]);
        repro::split_tf32(kv4.y, bh[1], bl[1]);
        repro::split_tf32(kv4.z, bh[2], bl[2]);
        repro::split_tf32(kv4.w, bh[3], bl[3]);
        mma3(sh[n], sl[n], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
        mma3(sh[n], sl[n], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
      }
    }

    // online softmax in fp32 (expf); sh[n][e] is row row0 + 8 (e >> 1),
    // key k0 + 8n + 2t + (e & 1). l_run is this thread's share of the row
    // sum; the quad's shares are added at the end.
    const bool masked = k0 + kF32BK > plain_end;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (sh[n][e] + sl[n][e]) * scale;
        if (masked && k0 + 8 * n + 2 * t + (e & 1) >= lim[e >> 1])
          x = -INFINITY;
        sh[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // no live key yet
      alpha[r] = expf(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sh[n][e] = expf(sh[n][e] - m_use[e >> 1]);
        l_run[e >> 1] += sh[n][e];
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: k-step kk takes keys 8kk + 2t (index t) and 8kk + 2t + 1
    // (index t + 4), straight from S's accumulator
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ah[4], al[4];
      repro::split_tf32(sh[kk][0], ah[0], al[0]);
      repro::split_tf32(sh[kk][2], ah[1], al[1]);
      repro::split_tf32(sh[kk][1], ah[2], al[2]);
      repro::split_tf32(sh[kk][3], ah[3], al[3]);
      // rows 8kk + 2t and + 1, chunk 8mm + g of each (both swizzled by 2t)
      const float* v0 = sv + (8 * kk + 2 * t) * D + 4 * (g ^ (2 * t));
#pragma unroll
      for (int mm = 0; mm < D / 32; ++mm) {
        const float4 x0 = *reinterpret_cast<const float4*>(v0 + 32 * mm);
        const float4 x1 = *reinterpret_cast<const float4*>(v0 + D + 32 * mm);
        const float b0[4] = {x0.x, x0.y, x0.z, x0.w};
        const float b1[4] = {x1.x, x1.y, x1.z, x1.w};
        uint32_t bh0[4], bl0[4], bh1[4], bl1[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          repro::split_tf32(b0[c], bh0[c], bl0[c]);
          repro::split_tf32(b1[c], bh1[c], bl1[c]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          repro::mma_tf32(acc[4 * mm + c], al, bh0[c], bh1[c]);
          repro::mma_tf32(acc[4 * mm + c], ah, bl0[c], bl1[c]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
          repro::mma_tf32(acc[4 * mm + c], ah, bh0[c], bh1[c]);
      }
    }
  }

  // group 1 hands its O, row max and row sums to group 0, lane by lane
  repro::cp_async_wait<0>();
  __syncthreads();  // both groups are done with their rings
  float* xw = smem + C::Q_FLOATS + wq * C::XCH * 32 + lane;
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xw[(4 * n + e) * 32] = acc[n][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xw[(D / 2 + r) * 32] = m_run[r];
      xw[(D / 2 + 2 + r) * 32] = l_run[r];
    }
  }
  __syncthreads();
  if (grp == 1) return;
  // rows go to O, or with key splits to this split's rows of `part`:
  // (kv_splits, B, Hq, Sq, D) normalised rows, then (kv_splits, B, Hq, Sq)
  // logsumexps, -inf for a row that sees no key of the split
  const size_t rows = static_cast<size_t>(B) * Hq * Sq;
  const size_t head_row = (static_cast<size_t>(b) * Hq + h) * Sq;
  float* out = kv_splits == 1 ? op : part + (split * rows + head_row) * D;
  const size_t out_row = kv_splits == 1 ? q_row : D;
  float* lout = kv_splits == 1
                    ? lp
                    : part + kv_splits * rows * D + split * rows + head_row;
  const float no_key = kv_splits == 1 ? INFINITY : -INFINITY;
  float f0[2], f1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = xw[(D / 2 + r) * 32], l1 = xw[(D / 2 + 2 + r) * 32];
    const float m = fmaxf(m_run[r], m1);
    const float a0 = m == -INFINITY ? 0.f : expf(m_run[r] - m);
    const float a1 = m == -INFINITY ? 0.f : expf(m1 - m);
    float l = a0 * l_run[r] + a1 * l1;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    f0[r] = a0 * inv;
    f1[r] = a1 * inv;
    const int row = row0 + 8 * r;
    if (lout != nullptr && t == 0 && row < Sq)
      lout[row] = l > 0.f ? m + logf(l) : no_key;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = acc[n][e] * f0[e >> 1] + xw[(4 * n + e) * 32] * f1[e >> 1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    float* orow = out + row * out_row + 8 * t;
#pragma unroll
    for (int mm = 0; mm < D / 32; ++mm) {
      *reinterpret_cast<float4*>(orow + 32 * mm) =
          make_float4(acc[4 * mm][2 * r], acc[4 * mm + 1][2 * r],
                      acc[4 * mm + 2][2 * r], acc[4 * mm + 3][2 * r]);
      *reinterpret_cast<float4*>(orow + 32 * mm + 4) = make_float4(
          acc[4 * mm][2 * r + 1], acc[4 * mm + 1][2 * r + 1],
          acc[4 * mm + 2][2 * r + 1], acc[4 * mm + 3][2 * r + 1]);
    }
  }
}

// The key splits' rows merged, one warp a (batch, head, row): O = sum_s w_s
// O_s / sum_s w_s and lse = max + log(sum_s w_s), w_s = exp(lse_s - max),
// lse_s the split's logsumexp (-inf where the row sees none of its keys).
// Rows of a sequence that sees no key were written by its first split.
template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_f32_merge_kernel(const float* __restrict__ part,
                               const int* __restrict__ kv_len,
                               float* __restrict__ o, float* __restrict__ lse,
                               int B, int Sq, int Hq, int kv_splits) {
  const int w = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t rows = static_cast<size_t>(B) * Hq * Sq;
  if (static_cast<size_t>(w) >= rows) return;
  const int row = w % Sq, bh = w / Sq, h = bh % Hq, b = bh / Hq;
  if (kv_len != nullptr && kv_len[b] <= 0) return;
  const float* lse_part = part + kv_splits * rows * D;
  float mx = -INFINITY;
  for (int s = 0; s < kv_splits; ++s)
    mx = fmaxf(mx, lse_part[s * rows + w]);
  const bool on = 4 * lane < D;  // this lane's columns 4 lane .. + 3
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float tot = 0.f;
  for (int s = 0; s < kv_splits; ++s) {
    const float ls = lse_part[s * rows + w];
    const float wt = ls == -INFINITY ? 0.f : expf(ls - mx);
    tot += wt;
    if (on) {
      const float4 x = *reinterpret_cast<const float4*>(
          part + (s * rows + w) * D + 4 * lane);
      acc.x += wt * x.x;
      acc.y += wt * x.y;
      acc.z += wt * x.z;
      acc.w += wt * x.w;
    }
  }
  const float inv = tot > 0.f ? 1.f / tot : 0.f;
  if (on)
    *reinterpret_cast<float4*>(
        o + ((static_cast<size_t>(b) * Sq + row) * Hq + h) * D + 4 * lane) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  if (lse != nullptr && lane == 0)
    lse[w] = tot > 0.f ? mx + logf(tot) : INFINITY;
}

// ---- bf16 kernel (TMA ring + wgmma) -------------------------------------

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
                       float* lse, const int* kv_len, float* part, int B,
                       int Sq, int Skv, int Hq, int Hkv, int q_offset,
                       int causal, float scale, int kv_splits,
                       cudaStream_t stream) {
  using C = F32Config<D>;
  static bool configured = false;
  cudaError_t e =
      sm90::allow_smem(flash_fwd_f32_kernel<D>, C::SMEM, &configured);
  if (e != cudaSuccess) return e;
  const int n_ctas = (Sq + kF32BQ - 1) / kF32BQ * Hq * B * kv_splits;
  flash_fwd_f32_kernel<D><<<n_ctas, kF32Threads, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, kv_len,
      part, B, Sq, Skv, Hq, Hkv, q_offset, causal, scale, kv_splits);
  if (kv_splits == 1 || (e = cudaGetLastError()) != cudaSuccess) return e;
  const long long rows = static_cast<long long>(B) * Hq * Sq;
  flash_fwd_f32_merge_kernel<D><<<(rows + 7) / 8, 256, 0, stream>>>(
      part, kv_len, static_cast<float*>(o), lse, B, Sq, Hq, kv_splits);
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
// kernel's q tile, kv_splits (>= 1) the fp32 kernel's key splits, each
// chosen by the wrapper; the fp32 kernel always takes 64 rows, and with
// kv_splits > 1 `part` holds kv_splits * B * Hq * Sq * (D + 1) floats of
// scratch. bf16 needs Skv >= 1 (a tensor map has no empty dimension).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      const void* kv_len, void* part, int B,
                                      int Sq, int Skv, int Hq, int Hkv, int D,
                                      int q_offset, int causal, float scale,
                                      int block_q, int kv_splits, int bf16_in,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kl = static_cast<const int*>(kv_len);
  float* lp = static_cast<float*>(lse);
  float* pp = static_cast<float*>(part);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  if (Hkv <= 0 || Hq % Hkv != 0 ||
      (D != 64 && D != 128 && !(bf16_in && D == 112)) ||
      (bf16_in && (Skv <= 0 || (block_q != 64 && block_q != 128))) ||
      (!bf16_in && (kv_splits < 1 || (kv_splits > 1 && pp == nullptr))))
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
    e = D == 64 ? launch_f32<64>(q, k, v, o, lp, kl, pp, B, Sq, Skv, Hq, Hkv,
                                 q_offset, causal, scale, kv_splits, s)
                : launch_f32<128>(q, k, v, o, lp, kl, pp, B, Sq, Skv, Hq,
                                  Hkv, q_offset, causal, scale, kv_splits, s);
  return static_cast<int>(e);
}
