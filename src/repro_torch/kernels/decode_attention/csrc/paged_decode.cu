// Kernel B1: paged decode attention for Hopper (sm_90a), as a split-KV
// walk (flash-decoding) fed by asynchronous copies.
//
// Replaces the TPU kernel `paged_decode_attention_pallas` in
// src/repro/kernels/decode_attention/decode_attention.py (body
// `_decode_kernel`).
//
//   q: (B, Hq, D); k/v pages: (n_pages, page, Hkv, D), q's type (the
//   engine's pool is fp32; bf16 is accepted too); block_table:
//   (B, max_pages) int32; lengths: (B,) int32; out: (B, Hq, D); D in
//   {64, 128}; G = Hq / Hkv <= 8. For each sequence b and query head h,
//   softmax(q.k * scale) . v over positions [0, lengths[b]) of the pages
//   block_table[b, :]. Entries past the length are never read (the engine
//   points them at its null page 0), except for a sequence of length 0,
//   which gets the plain version's answer: the mean of V over every
//   position of its row of the block table (every score equal).
//
// What bounds it on the H100: device-memory bytes. Each live K/V element
// is used by the G query heads of its group, ~2*G flops per element read,
// far below the balance point. The floor is (bytes of the live tokens' K/V
// + q + out) / 3.35 TB/s. Reaching it takes the whole card streaming: at
// the engine's decode shapes (8 slots of which 1-3 are live, 32 kv heads)
// one CTA per (sequence, kv head) leaves most SMs idle while a few walk a
// thousand positions alone.
//
// Design: two kernels a call, 128 threads a CTA in the first.
// - Splits. `paged_decode_kernel_split` has one CTA per (split, kv head,
//   sequence); a split is a fixed run of `split_pages` pages, chosen by
//   ops.split_plan from the shapes alone: 64 positions, doubled while the
//   grid would pass 2048 CTAs (128 at the engine's 8 slots x 32 kv heads x
//   64 pages of 16), so the splits of a ragged batch with one long sequence
//   still spread over every SM. A split that starts at or past lengths[b]
//   exits at once, so the host never reads the lengths. The split's
//   block-table entries are read once into shared memory, beside the
//   length.
// - Copies. Each of the 4 warps walks its own steps of 4 positions (warp w
//   takes steps w, w + 4, ...); within a warp each lane owns one 16-byte
//   chunk of a K row and of a V row per pass (lanes split D, 32, 16 or 8
//   lanes a row, and the rows of a step). K and V of a step are fetched
//   together by `cp.async.cg` 16-byte copies into a 3-stage ring in shared
//   memory, two steps ahead of the one being computed. A lane copies
//   exactly the chunks it reads, so the ring is private to the thread:
//   `cp.async.wait_group` alone orders it, with no barrier in the walk.
//   cp.async rather than TMA: the engine passes another layer's pool (a new
//   base address) on every call, and a TMA tensor map would have to be
//   encoded on the host for each (B2's wrapper pays four such encodes a
//   call); a 16-byte copy needs only the address, and neighbouring lanes
//   read a head's row (256-512 bytes) whole.
// - Softmax. Scores are summed across a row's lanes by shuffles; each warp
//   keeps an fp32 online softmax (running max m, normaliser l) and its P.V
//   partial for the group's G query rows in registers, arrays sized by the
//   template's G (1, 2, 4 or 8 rows). The 4 warps' states are merged
//   through shared memory into the split's partial (m, l, o) per query
//   head: o / l straight into `out` when the sequence has one live split,
//   else the partial into an fp32 workspace.
// - Merge. `paged_decode_kernel_merge`, one CTA per (query head, sequence),
//   merges the live splits' partials as `merge_partials` does (max of m,
//   exp-weighted sums of l and o) and writes o / l in q's type; a sequence
//   of one live split is left as written. It loads the first 16 splits'
//   partials beside the length, so at the engine's shapes it waits on
//   memory once rather than once per step of a chain. Both kernels are
//   launched as programmatic dependents of the kernel before them (Hopper's
//   `griddepcontrol`): a grid is staged while the one before drains and
//   waits at its top for that grid's writes, so neither launch leaves the
//   card idle between kernels.
// A length-0 row (C7) walks every position of its row with every score 0
// (K is not read): the merge then gives the mean of V.
#include <limits.h>

#include "common.cuh"
#include "launch.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;
using repro::warp_max;
using repro::warp_sum;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStep = 4;            // positions of a warp's step
constexpr int kStages = 3;          // the ring, in steps
constexpr int kMaxG = 8;            // query heads per kv head
constexpr int kMaxSplitPages = 64;  // block-table entries of a split
constexpr int kMaxSplits = 256;     // splits of a sequence
constexpr int kMergeChunk = 16;     // partials a merging thread loads early

// How a warp's lanes cover a step: each lane one 16-byte chunk of a row
// per pass, `kLanesPerRow` lanes a row, `kRowsPerPass` rows a pass.
template <typename T, int D>
struct Geo {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLanesPerRow = D / kVec;
  static constexpr int kRowsPerPass = 32 / kLanesPerRow;
  static constexpr int kPasses = kStep / kRowsPerPass;
  // a thread's ring: per stage, K then V, one chunk a pass
  static constexpr size_t kRingBytes =
      size_t(kStages) * 2 * kPasses * 16 * kThreads;
  static_assert(kLanesPerRow <= 32 && kPasses >= 1, "D, type");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `kPending` committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// the N = 16 / sizeof(T) values of a 16-byte chunk as fp32
template <typename T, int N>
__device__ __forceinline__ void unpack(const uint4 raw, float* out) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
}

// positions a sequence's walk covers: its length, or every position of
// its block-table row for a length of 0 or less
__device__ __forceinline__ int walked(int len, int cap) {
  return len <= 0 ? cap : min(len, cap);
}

// A warp's step i (of `mine`), positions start + kWarps * kStep * i +
// [0, 4): this lane's K and V chunks into the step's ring slot by cp.async
// (zeros past p1), as one commit group, empty past the warp's last step.
template <typename T, int D>
__device__ __forceinline__ void issue_step(uint4* ring, const T* kpool,
                                           const T* vpool, const int* sPage,
                                           int i, int mine, int start, int p1,
                                           int pg0, int page,
                                           size_t tok_stride, size_t col,
                                           bool uniform) {
  using Ge = Geo<T, D>;
  constexpr int RPP = Ge::kRowsPerPass, NP = Ge::kPasses;
  if (i < mine) {
    const int lane = threadIdx.x & 31;
    const int base = start + kWarps * kStep * i + lane / Ge::kLanesPerRow;
    uint4* dst = ring + ((i % kStages) * 2) * NP * kThreads + threadIdx.x;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int pos = base + k * RPP;
      const bool ok = pos < p1;
      size_t off = 0;
      if (ok)
        off = (static_cast<size_t>(sPage[pos / page - pg0]) * page +
               pos % page) * tok_stride + col;
      if (!uniform) cp_async16(dst + k * kThreads, kpool + off, ok ? 16 : 0);
      cp_async16(dst + (NP + k) * kThreads, vpool + off, ok ? 16 : 0);
    }
  }
  cp_async_commit();
}

// Split `split` (of `live`) of kv head hk of sequence b, for the group's
// G <= GM query heads: o / l into `out` when it is the sequence's only
// live split, else its partial (o, m, l) into the workspace. The
// block-table entries are already in sPage. Every branch is uniform over
// the CTA.
template <typename T, int D, int GM>
__device__ __forceinline__ void walk_split(
    const T* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, T* __restrict__ out,
    float* __restrict__ part, uint4* ring, const int* sPage, int split,
    int hk, int b, int live, int len, int B, int G, int Hq, int Hkv,
    int page, int max_pages, int split_pages, int n_splits, float scale) {
  using Ge = Geo<T, D>;
  constexpr int V = Ge::kVec, LPR = Ge::kLanesPerRow;
  constexpr int RPP = Ge::kRowsPerPass, NP = Ge::kPasses;
  const bool uniform = len <= 0;  // no visible position: every score 0
  const int span = split_pages * page;
  const int p0 = split * span;
  const int p1 = min(p0 + span, walked(len, max_pages * page));
  const int pg0 = split * split_pages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rr = lane / LPR, c = lane % LPR;
  const size_t tok_stride = static_cast<size_t>(Hkv) * D;
  const size_t col = static_cast<size_t>(hk) * D + c * V;
  const size_t head0 = static_cast<size_t>(b) * Hq + hk * G;
  float qr[GM][V], acc[GM][V], m_run[GM], l_run[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int e = 0; e < V; ++e) qr[g][e] = acc[g][e] = 0.f;
    if (g < G && !uniform)
      unpack<T, V>(
          *reinterpret_cast<const uint4*>(q + (head0 + g) * D + c * V),
          qr[g]);
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
  }

  // this warp's steps: positions p0 + (warp + kWarps * i) * kStep + [0, 4)
  const int n_steps = (p1 - p0 + kStep - 1) / kStep;
  const int mine = n_steps > warp ? (n_steps - warp + kWarps - 1) / kWarps
                                  : 0;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    issue_step<T, D>(ring, kpool, vpool, sPage, i, mine, p0 + warp * kStep,
                     p1, pg0, page, tok_stride, col, uniform);

  for (int i = 0; i < mine; ++i) {
    issue_step<T, D>(ring, kpool, vpool, sPage, i + kStages - 1, mine,
                     p0 + warp * kStep, p1, pg0, page, tok_stride, col,
                     uniform);
    cp_async_wait<kStages - 1>();  // step i has landed
    const uint4* slot = ring + ((i % kStages) * 2) * NP * kThreads + tid;
    const int base = p0 + (warp + kWarps * i) * kStep;
    float s[GM][NP], vv[NP][V];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const bool ok = base + k * RPP + rr < p1;
      if (!uniform) {
        float kf[V];
        unpack<T, V>(slot[k * kThreads], kf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) dot += qr[g][e] * kf[e];
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          s[g][k] = ok ? dot * scale : -INFINITY;
        }
      } else {
#pragma unroll
        for (int g = 0; g < GM; ++g) s[g][k] = ok ? 0.f : -INFINITY;
      }
      unpack<T, V>(slot[(NP + k) * kThreads], vv[k]);
    }
    // online softmax over the step's 4 positions; the step's first
    // position is live, so the new max is finite
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = s[g][0];
#pragma unroll
      for (int k = 1; k < NP; ++k) mx = fmaxf(mx, s[g][k]);
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[g], mx);
      const float alpha = expf(m_run[g] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const float p = expf(s[g][k] - m_new);
        sum += p;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] += p * vv[k][e];
      }
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run[g] = l_run[g] * alpha + sum;
      m_run[g] = m_new;
    }
  }
  cp_async_wait<0>();

  // the warp's P.V rows summed over its row groups (lanes c of rr = 0)
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < V; ++e)
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  __syncthreads();  // every copy has landed; the ring is reused below
  float* sO = reinterpret_cast<float*>(ring);  // [kWarps][GM][D]
  float* sML = sO + kWarps * GM * D;           // [kWarps][GM][2]
  if (rr == 0)
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < V; ++e)
        sO[(warp * GM + g) * D + c * V + e] = acc[g][e];
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      sML[(warp * GM + g) * 2] = m_run[g];
      sML[(warp * GM + g) * 2 + 1] = l_run[g];
    }
  __syncthreads();

  // the split's partial (warp 0 always had a step, so m is finite): o / l
  // at once for a sequence of one live split, else into the workspace
  const size_t n_rows = static_cast<size_t>(B) * Hq * n_splits;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, sML[(w * GM + g) * 2]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(sML[(w * GM + g) * 2] - m);
      o += a * sO[(w * GM + g) * D + d];
      l += a * sML[(w * GM + g) * 2 + 1];
    }
    if (live == 1) {
      out[(head0 + g) * D + d] = from_f32<T>(o / l);
      continue;
    }
    const size_t row = (head0 + g) * n_splits + split;
    part[row * D + d] = o;
    if (d == 0) {
      part[n_rows * D + row * 2] = m;
      part[n_rows * D + row * 2 + 1] = l;
    }
  }
}

// Let this grid start while the previous kernel in the stream drains, and
// wait here until that kernel has finished and its writes are visible
// (programmatic dependent launch; a no-op without a previous kernel).
__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// one CTA per (split, kv head, sequence); a split at or past the
// sequence's length exits at once. The launch bounds' minimum of one CTA
// an SM leaves ptxas free to use the registers it needs: without it two
// instantiations (G = 2) were held at 72 registers with a 4-byte spill.
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads, 1)
    paged_decode_kernel_split(const T* __restrict__ q,
                              const T* __restrict__ kpool,
                              const T* __restrict__ vpool,
                              T* __restrict__ out,
                              const int* __restrict__ block_table,
                              const int* __restrict__ lengths,
                              float* __restrict__ part, int Hq, int Hkv,
                              int page, int max_pages, int split_pages,
                              float scale) {
  extern __shared__ uint4 ring[];
  __shared__ int sPage[kMaxSplitPages];
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  wait_for_previous_grid();
  // the split's block-table entries load beside the length
  const int pg0 = split * split_pages;
  for (int i = threadIdx.x; i < split_pages; i += kThreads)
    sPage[i] = pg0 + i < max_pages
                   ? block_table[static_cast<size_t>(b) * max_pages + pg0 + i]
                   : 0;
  const int len = lengths[b];
  const int span = split_pages * page;
  const int eff = walked(len, max_pages * page);
  if (split * span >= eff) return;
  __syncthreads();  // sPage
  walk_split<T, D, GM>(q, kpool, vpool, out, part, ring, sPage, split, hk, b,
                       (eff + span - 1) / span, len, gridDim.z, Hq / Hkv, Hq,
                       Hkv, page, max_pages, split_pages, gridDim.x, scale);
}

// one CTA of D threads per (query head, sequence) of more than one live
// split: their partials merged as `merge_partials` does (warp 0 finds the
// max of m, each split's weight and the merged l; thread d sums o)
template <typename T>
__global__ void paged_decode_kernel_merge(const float* __restrict__ part,
                                          const int* __restrict__ lengths,
                                          T* __restrict__ out, int Hq, int D,
                                          int cap, int span, int n_splits) {
  __shared__ float sA[kMaxSplits];  // the live splits' weights
  __shared__ float sL;              // the merged normaliser
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int lane = d & 31;
  wait_for_previous_grid();
  const size_t row0 = (static_cast<size_t>(b) * Hq + h) * n_splits;
  const size_t n_rows = static_cast<size_t>(gridDim.y) * Hq * n_splits;
  const float* po = part + row0 * D + d;
  const float2* ml = reinterpret_cast<const float2*>(part + n_rows * D) +
                     row0;
  // loads that do not wait for the length: o of the first kMergeChunk
  // splits, and (m, l) of the first 32 (entries past the live splits are
  // never used)
  float v[kMergeChunk];
#pragma unroll
  for (int k = 0; k < kMergeChunk; ++k)
    v[k] = po[static_cast<size_t>(min(k, n_splits - 1)) * D];
  const float2 e0 = ml[min(lane, n_splits - 1)];
  const int live = (walked(lengths[b], cap) + span - 1) / span;
  if (live == 1) return;  // the split kernel wrote o / l
  if (d < 32) {  // warp 0: the max of m, the weights, l
    float m = lane < live ? e0.x : -INFINITY;
    for (int s = lane + 32; s < live; s += 32) m = fmaxf(m, ml[s].x);
    m = warp_max(m);
    float l = 0.f;
    if (lane < live) {
      const float a = expf(e0.x - m);
      sA[lane] = a;
      l = a * e0.y;
    }
    for (int s = lane + 32; s < live; s += 32) {
      const float2 e = ml[s];
      const float a = expf(e.x - m);
      sA[s] = a;
      l += a * e.y;
    }
    l = warp_sum(l);
    if (lane == 0) sL = l;
  }
  __syncthreads();
  float o = 0.f;
#pragma unroll
  for (int k = 0; k < kMergeChunk; ++k)
    if (k < live) o += sA[k] * v[k];
  for (int s = kMergeChunk; s < live; ++s)
    o += sA[s] * po[static_cast<size_t>(s) * D];
  out[(static_cast<size_t>(b) * Hq + h) * D + d] = from_f32<T>(o / sL);
}

// launch `kernel` on `s` as a programmatic dependent of the kernel before
template <typename... P, typename... A>
cudaError_t launch_after_previous(void (*kernel)(P...), dim3 grid,
                                  int threads, size_t smem, cudaStream_t s,
                                  A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<P>(args)...);
}

// launch<T, D, GM>'s type, one per instantiation
using Launch = cudaError_t (*)(const void*, const void*, const void*, void*,
                               const int*, const int*, float*, int, int, int,
                               int, int, int, float, cudaStream_t);

template <typename T, int D, int GM>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   void* out, const int* bt, const int* ln, float* part,
                   int B, int Hq, int Hkv, int page, int max_pages,
                   int split_pages, float scale, cudaStream_t s) {
  // the ring, then (reusing it) the warps' states
  size_t smem = Geo<T, D>::kRingBytes;
  const size_t warps_bytes = size_t(kWarps) * GM * (D + 2) * 4;
  if (warps_bytes > smem) smem = warps_bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel_split<T, D, GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int n_splits = (max_pages + split_pages - 1) / split_pages;
  cudaError_t e = launch_after_previous(
      paged_decode_kernel_split<T, D, GM>, dim3(n_splits, Hkv, B), kThreads,
      smem, s, static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), bt, ln, part,
      Hq, Hkv, page, max_pages, split_pages, scale);
  if (e != cudaSuccess || n_splits == 1) return e;
  return launch_after_previous(paged_decode_kernel_merge<T>, dim3(Hq, B), D,
                               0, s, part, ln, static_cast<T*>(out), Hq, D,
                               max_pages * page, split_pages * page,
                               n_splits);
}

// the instantiation for the group: arrays of 1, 2, 4 or 8 rows
template <typename T, int D>
cudaError_t launch_group(const void* q, const void* k_pages,
                         const void* v_pages, void* out, const int* bt,
                         const int* ln, float* part, int B, int Hq, int Hkv,
                         int page, int max_pages, int split_pages,
                         float scale, cudaStream_t s) {
  const int G = Hq / Hkv;
  const Launch run = G == 1   ? launch<T, D, 1>
                     : G == 2 ? launch<T, D, 2>
                     : G <= 4 ? launch<T, D, 4>
                              : launch<T, D, kMaxG>;
  return run(q, k_pages, v_pages, out, bt, ln, part, B, Hq, Hkv, page,
             max_pages, split_pages, scale, s);
}

}  // namespace

// `part`: B * Hq * splits * (D + 2) floats of workspace, splits =
// ceil(max_pages / split_pages) <= 256 (the splits' o, then their (m, l));
// entries of sequences with one live split, and of splits past a
// sequence's length, are neither written nor read.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, void* out,
                                   const void* block_table,
                                   const void* lengths, void* part, int B,
                                   int Hq, int Hkv, int D, int page,
                                   int max_pages, int split_pages,
                                   float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (B < 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || Hq % Hkv != 0 ||
      Hq / Hkv > kMaxG || Hq > INT_MAX / 2 || page <= 0 || max_pages <= 0 ||
      split_pages <= 0 || split_pages > kMaxSplitPages ||
      (max_pages + split_pages - 1LL) / split_pages > kMaxSplits ||
      static_cast<long long>(max_pages) * page > INT_MAX ||
      (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* bt = static_cast<const int*>(block_table);
  const int* ln = static_cast<const int*>(lengths);
  float* pf = static_cast<float*>(part);
  using bf = __nv_bfloat16;
  const Launch run =
      bf16 ? (D == 64 ? launch_group<bf, 64> : launch_group<bf, 128>)
           : (D == 64 ? launch_group<float, 64> : launch_group<float, 128>);
  return static_cast<int>(run(q, k_pages, v_pages, out, bt, ln, pf, B, Hq,
                              Hkv, page, max_pages, split_pages, scale, s));
}
