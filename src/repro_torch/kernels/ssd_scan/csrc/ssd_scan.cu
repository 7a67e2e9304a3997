// Kernel B4: Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan_pallas` in
// src/repro/kernels/ssd_scan/ssd_scan.py (body `_ssd_kernel`).
//
//   x: (B, S, H, P) and Bm, Cm: (B, S, G, N), one type (fp32 or bf16);
//   dt: (B, S, H), A, D: (H,), init: (B, H, P, N) or null, all fp32.
//   y: (B, S, H, P) in x's type; fin: (B, H, P, N) fp32. Head h reads
//   group h / (H / G); P <= 64 and N <= 128, both multiples of 16.
//
// For each chunk of Q positions (the last may be ragged), with
// cum = cumsum(dt * A) restarting at the chunk's start:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . E^T + D x_i
//   E'    = E exp(cum_last) + sum_j x_j^T (B_j exp(cum_last - cum_j) dt_j)
// with E the state entering the chunk: `ssd_chunked_ref`'s block
// decomposition, and for a ragged chunk the recurrence's own result
// (positions past S act as dt = 0, x = 0).
//
// Three passes, so that only the (P, N) carry is serial:
//   1. `ssd_scan_kernel_states`, one CTA per (chunk, head, batch): the
//      chunk's cumsum of dt * A (summed in double by one warp, rounded to
//      fp32, written to a scratch the other passes read, so all three see
//      one set of decays) and the chunk's own state
//      sum_j (x_j exp(cum_last - cum_j) dt_j)^T B_j, into an fp32 scratch.
//   2. `ssd_scan_kernel_carry`, per (batch, head) and 512 state entries a
//      CTA: walks the chunks (the loads of eight chunks in flight at once)
//      and writes the state entering each chunk to a second scratch (for
//      bf16 inputs already split into bf16 hi and lo tiles, once, rather
//      than by every warp that reads it) and the final state.
//   3. `ssd_scan_kernel_output`, one CTA per (64-row query tile, chunk,
//      head, batch), heaviest tiles first: y_inter from the entering
//      state, then for each key tile at or below the query tile the
//      masked, decayed scores C B^T times x, then D x.
// At the mamba2-1.3b prefill shape (B=4, S=2048, H=64, Q=256) that is
// 2,048 + 8,192 CTAs in place of 256 serial walks; at batch 1 the card
// still fills. Key tiles (and pass 1's tiles) arrive by 16-byte
// `cp.async` of strided rows, zero-filled past S, two stages deep, so the
// next tile loads while this one is multiplied.
//
// What bounds it on the H100. Per (batch, chunk, head) the products cost
// ~(Q^2 (N + P) + 4 Q P N) flops against ~Q (2P + 2N) input values, far
// above the card's balance; but counted at the tensor cores' rate the
// least time is the bytes (x, y, B, C and the entering-state scratch,
// ~0.09 ms at the mamba2 shape against ~0.05 ms of bf16 operations). The
// kernel sits well above both: what holds it is the shared-memory and L2
// traffic of feeding mma.sync from 64-row tiles (each CTA of pass 3 reads
// B, x and the entering state again from L2) and the exps of the masked
// decay; wgmma and sharing B across heads are the next levers.
// - bf16 inputs (the model paths): every product runs on the tensor cores
//   as `mma.sync.m16n8k16` bf16 with fp32 accumulation, operands from
//   padded shared tiles through `ldmatrix` (`.trans` where the natural
//   layout is K-major); pass 3 keeps its 16 rows of C in registers for
//   all its products and turns the score accumulators into the next
//   product's A fragments without shared memory, as flash attention does.
//   C B^T has two bf16 operands: its products are exact. The other three
//   products have one fp32 operand (the decayed x_j, the entering state,
//   the masked scores); it is split as hi = bf16(v), lo = bf16(v - hi)
//   and each product takes two passes, hi and lo, against the exact bf16
//   operand. hi + lo keeps ~16 significant bits of v (a relative error
//   under 2^-16, where one bf16 rounding leaves 2^-8); the fp32
//   accumulation adds its own. A single bf16 pass puts the final state
//   outside 1e-3 of the fp32 oracle; the split keeps it within ~1e-5 at
//   the models' shapes (`ssd_split_ref` in ops.py emulates this rounding
//   on the CPU). The decays of the masked scores and of y_inter use the
//   hardware's ex2 on cumsums pre-scaled by log2(e) (y is held at 2e-2).
//   C B^T is computed per head, not once per group: at the bf16 rate it
//   costs ~17 GFLOP (~17 us) at the mamba2 shape, less than writing and
//   re-reading a Q x Q scratch per (batch, chunk, group) would.
// - fp32 inputs (the tests' and the reduced models' case, held at 2e-5):
//   the same passes, the products as fp32 FMAs from shared tiles (one
//   stage, the score tile through shared memory), each thread holding the
//   mma.sync fragment layout so that one epilogue serves both; decays by
//   expf.
#include "common.cuh"
#include "fma_gemm.cuh"
#include "launch.cuh"
#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::gemm;
using repro::ldsm_x4;
using repro::ldsm_x4_t;
using repro::mma_bf16;
using repro::split2;
using repro::store2;
using repro::to_f32;

constexpr int kThreads = 128;     // four warps, 16 rows each
constexpr int kT = 64;            // rows of a tile
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kCarry = kThreads * 4;  // state entries a carry CTA walks

template <typename T>
constexpr int ld_of(int cols) {  // padded row: ldmatrix / FMA reads of
  return cols + (sizeof(T) == 2 ? 8 : 4);  // eight rows hit eight banks
}

// kT rows of `cols` values, `stride` elements apart in global memory;
// rows at or past `live` are zeros
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          size_t stride, int cols,
                                          int live) {
  repro::load_tile<kT, kThreads>(dst, ld, src, stride, cols, live);
}

// ---- products ---------------------------------------------------------
// The mma.sync accumulator and fragment layout of mma_sync.cuh, kept by
// the fp32 FMA products too, so that one epilogue serves both.

// exp(a - b). The bf16 path takes a and b pre-scaled by log2(e) and the
// hardware's ex2 (its y is held at 2e-2); the fp32 path, held at 2e-5,
// takes expf.
template <bool kFast>
__device__ __forceinline__ float decay(float a, float b) {
  if constexpr (kFast) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(a - b));
    return r;
  } else {
    return expf(a - b);
  }
}

// shared-memory layout of the two tiled passes, in elements of T
template <typename T>
struct Layout {
  static constexpr bool kTwo = sizeof(T) == 2;  // bf16: tensor cores
  static constexpr int ldP = ld_of<T>(kMaxP);
  static constexpr int ldN = ld_of<T>(kMaxN);
  static constexpr int ldK = ld_of<T>(kT);      // a score tile's row
  static constexpr int kP = kT * ldP, kN = kT * ldN, kK = kT * ldK;
  // a stage: x rows [j][p], then B rows [j][n]
  static constexpr int kStage = kP + kN;
  // pass 1: two stages
  static constexpr int states = 2 * kStage;
  // pass 3: C [i][n] and the entering state [p][n] (bf16 hi and lo
  // tiles, or one fp32 tile), then the key tiles: for bf16 two stages
  // over the same memory (C goes to registers first); for fp32 C stays,
  // one stage and the score tile
  static constexpr int kEsz = kTwo ? 2 * kN : kN;
  static constexpr int kStages = kTwo ? 2 : 1;
  static constexpr int kKeys = kTwo ? 0 : kN;
  static constexpr int output =
      kTwo ? (kN + kEsz > 2 * kStage ? kN + kEsz : 2 * kStage)
           : kN + (kEsz > kStage + kK ? kEsz : kStage + kK);
  static constexpr size_t output_bytes =
      output * sizeof(T) + (1 + 2 * kStages) * kT * sizeof(float);
};

// ---- pass 1: cumsums and chunk states -----------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel_states(const T* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ A,
                           const T* __restrict__ Bm, float* __restrict__ st,
                           float* __restrict__ cum, int S, int H, int P,
                           int G, int N, int Q) {
  using Lo = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  float* sDt = reinterpret_cast<float*>(base + Lo::states);
  float* sCum = sDt + Q;
  float* sF = sCum + Q;                         // [stage][kT]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3, r8 = lane & 7, mi = lane >> 3;
  const int c0 = c * Q, L = min(Q, S - c0);
  const float a_h = A[h];
  const size_t x_row = static_cast<size_t>(H) * P;
  const size_t bc_row = static_cast<size_t>(G) * N;
  const T* xb = x + (static_cast<size_t>(b) * S + c0) * x_row + h * P;
  const T* Bb = Bm + (static_cast<size_t>(b) * S + c0) * bc_row + g * N;
  const float* dtb = dt + (static_cast<size_t>(b) * S + c0) * H + h;
  const size_t bhc = (static_cast<size_t>(b) * H + h) * nc + c;

  for (int i = tid; i < Q; i += kThreads)
    sDt[i] = i < L ? dtb[static_cast<size_t>(i) * H] : 0.f;
  __syncthreads();
  if (warp == 0) {
    // inclusive cumsum of the fp32 products dt * A, summed in double:
    // each lane a contiguous run, then a warp scan of the runs
    const int per = (Q + 31) / 32;
    const int k0 = min(lane * per, Q), k1 = min(k0 + per, Q);
    double run = 0.0;
    for (int k = k0; k < k1; ++k) run += static_cast<double>(sDt[k] * a_h);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, run, o);
      if (lane >= o) run += v;
    }
    double base_sum = __shfl_up_sync(0xffffffffu, run, 1);
    if (lane == 0) base_sum = 0.0;
    for (int k = k0; k < k1; ++k) {
      base_sum += static_cast<double>(sDt[k] * a_h);
      sCum[k] = static_cast<float>(base_sum);
    }
  }
  __syncthreads();
  for (int i = tid; i < Q; i += kThreads) cum[bhc * Q + i] = sCum[i];
  const float cum_last = sCum[L - 1];

  // key tile j0 into `stage`: x and B rows, and each row's factor
  // exp(cum_last - cum_j) dt_j
  auto fetch = [&](int j0, int stage) {
    T* sx = base + stage * Lo::kStage;
    load_tile(sx, Lo::ldP, xb + j0 * x_row, x_row, P, L - j0);
    load_tile(sx + Lo::kP, Lo::ldN, Bb + j0 * bc_row, bc_row, N, L - j0);
    cp_async_commit();
    if (tid < kT) {
      const int j = j0 + tid;
      sF[stage * kT + tid] =
          j < L ? expf(cum_last - sCum[j]) * sDt[j] : 0.f;
    }
  };
  const int p0 = 16 * warp;
  float acc[kMaxN / 8][4] = {};
  fetch(0, 0);
  int stage = 0;
  for (int j0 = 0;; j0 += kT) {
    const bool more = j0 + kT < L;
    if (more) {
      fetch(j0 + kT, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sx = base + stage * Lo::kStage;
    const T* sb = sx + Lo::kP;
    const float* f = sF + stage * kT;
    // state (P x N) += (x_j f_j)^T B_j: A = x stored [j][p], each k
    // scaled by f; B = B_j stored [j][n]
    if (p0 < P) {
      if constexpr (Lo::kTwo) {
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) {
          uint32_t ax[4], ah[4], al[4];
          ldsm_x4_t(ax, sx + (16 * kk + r8 + (mi >> 1) * 8) * Lo::ldP + p0 +
                            (mi & 1) * 8);
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // a[q]: k = 16 kk + 2t (+8 for q > 1)
            const int k = 16 * kk + 2 * t + 8 * (q >> 1);
            const __nv_bfloat162 v =
                *reinterpret_cast<const __nv_bfloat162*>(&ax[q]);
            split2(__low2float(v) * f[k], __high2float(v) * f[k + 1], ah[q],
                   al[q]);
          }
#pragma unroll
          for (int np = 0; np < kMaxN / 16; ++np) {
            if (16 * np < N) {
              uint32_t bf[4];
              ldsm_x4_t(bf, sb + (16 * kk + r8 + (mi & 1) * 8) * Lo::ldN +
                                16 * np + (mi >> 1) * 8);
              mma_bf16(acc[2 * np], ah, bf[0], bf[1]);
              mma_bf16(acc[2 * np], al, bf[0], bf[1]);
              mma_bf16(acc[2 * np + 1], ah, bf[2], bf[3]);
              mma_bf16(acc[2 * np + 1], al, bf[2], bf[3]);
            }
          }
        }
      } else {
        gemm<true, true>(acc, sx, Lo::ldP, sb, Lo::ldN, p0, kT, N, f);
      }
    }
    if (!more) break;
    __syncthreads();  // every warp is done with this stage
    stage ^= 1;
  }
  if (p0 < P) {
    float* out = st + bhc * P * N;
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      const int n = 8 * nt + 2 * t;
      if (n < N) {
        *reinterpret_cast<float2*>(out + (p0 + gq) * N + n) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(out + (p0 + gq + 8) * N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }
}

// ---- pass 2: the carry across chunks ------------------------------------
// The state entering chunk c goes to `entry`'s slot c: fp32, or for bf16
// inputs split once here as the output pass's tensor cores take it, a bf16
// hi tile then a bf16 lo tile in the slot's bytes.
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel_carry(const float* __restrict__ st,
                          const float* __restrict__ cum,
                          const float* __restrict__ init,
                          float* __restrict__ entry,
                          float* __restrict__ fin, bool split, int S, int H,
                          int PN, int Q, int nc) {
  constexpr int kAhead = 8;  // chunks whose loads are in flight together
  const int i = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i >= PN) return;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  float4 prev = init != nullptr
                    ? *reinterpret_cast<const float4*>(init + bh * PN + i)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 own[kAhead];
    float decay[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 + k;
      if (c < nc) {
        own[k] = *reinterpret_cast<const float4*>(st + (bh * nc + c) * PN + i);
        decay[k] = expf(cum[(bh * nc + c) * Q + min(Q, S - c * Q) - 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 + k;
      if (c < nc) {
        float* slot = entry + (bh * nc + c) * PN;
        if (split) {
          uint32_t hi[2], lo[2];
          split2(prev.x, prev.y, hi[0], lo[0]);
          split2(prev.z, prev.w, hi[1], lo[1]);
          bf16* half = reinterpret_cast<bf16*>(slot);
          *reinterpret_cast<uint2*>(half + i) = make_uint2(hi[0], hi[1]);
          *reinterpret_cast<uint2*>(half + PN + i) = make_uint2(lo[0], lo[1]);
        } else {
          *reinterpret_cast<float4*>(slot + i) = prev;
        }
        prev = make_float4(prev.x * decay[k] + own[k].x,
                           prev.y * decay[k] + own[k].y,
                           prev.z * decay[k] + own[k].z,
                           prev.w * decay[k] + own[k].w);
      }
    }
  }
  *reinterpret_cast<float4*>(fin + bh * PN + i) = prev;
}

// ---- pass 3: outputs ------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel_output(const T* __restrict__ x,
                           const float* __restrict__ dt,
                           const T* __restrict__ Bm,
                           const T* __restrict__ Cm,
                           const float* __restrict__ Dv,
                           const float* __restrict__ entry,
                           const float* __restrict__ cum, bool has_init,
                           T* __restrict__ y, int S, int H, int P, int G,
                           int N, int Q) {
  using Lo = Layout<T>;
  constexpr bool kTwo = Lo::kTwo;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  const T* sC = base;
  T* sE = base + Lo::kN;                 // [p][n]; for bf16 hi, then lo
  float* sCumQ = reinterpret_cast<float*>(base + Lo::output);
  float* sCumK = sCumQ + kT;                   // [stage][kT]
  float* sDtK = sCumK + Lo::kStages * kT;

  const int h = blockIdx.x, c = blockIdx.y;
  const int n_qt = (Q + kT - 1) / kT, B = gridDim.z / n_qt;
  const int b = blockIdx.z % B, qt = n_qt - 1 - blockIdx.z / B;
  const int nc = gridDim.y, g = h / (H / G);
  const int c0 = c * Q, L = min(Q, S - c0), i0 = qt * kT;
  if (i0 >= L) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3, m0 = 16 * warp;
  const int r8 = lane & 7, mi = lane >> 3;      // ldmatrix row, matrix
  const size_t x_row = static_cast<size_t>(H) * P;
  const size_t bc_row = static_cast<size_t>(G) * N;
  const T* xb = x + (static_cast<size_t>(b) * S + c0) * x_row + h * P;
  T* yb = y + (static_cast<size_t>(b) * S + c0) * x_row + h * P;
  const T* Bb = Bm + (static_cast<size_t>(b) * S + c0) * bc_row + g * N;
  const T* Cb = Cm + (static_cast<size_t>(b) * S + c0) * bc_row + g * N;
  const float* dtb = dt + (static_cast<size_t>(b) * S + c0) * H + h;
  const size_t bhc = (static_cast<size_t>(b) * H + h) * nc + c;
  const float* cumc = cum + bhc * Q;

  const bool has_state = c > 0 || has_init;
  load_tile(base, Lo::ldN, Cb + i0 * bc_row, bc_row, N, L - i0);
  if (has_state) {
    const T* e = reinterpret_cast<const T*>(entry + bhc * P * N);
    load_tile(sE, Lo::ldN, e, N, N, P);
    if constexpr (kTwo) load_tile(sE + Lo::kN, Lo::ldN, e + P * N, N, N, P);
  }
  cp_async_commit();
  // cumsums as decay<kTwo> takes them
  const float cum_scale = kTwo ? 1.44269504088896341f : 1.f;
  if (tid < kT) sCumQ[tid] = i0 + tid < L ? cumc[i0 + tid] * cum_scale : 0.f;
  float acc[kMaxP / 8][4] = {};
  cp_async_wait<0>();
  __syncthreads();
  // bf16: this warp's 16 rows of C as A fragments, for every product
  uint32_t cf[kMaxN / 16][4];
  if constexpr (kTwo) {
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks)
      if (16 * ks < N)
        ldsm_x4(cf[ks], sC + (m0 + r8 + (mi & 1) * 8) * Lo::ldN + 16 * ks +
                            (mi >> 1) * 8);
  }
  if (has_state) {
    // y_inter = exp(cum_i) C_i E^T: A = C [i][n], B = E stored [p][n]
    if constexpr (kTwo) {
#pragma unroll
      for (int ks = 0; ks < kMaxN / 16; ++ks) {
#pragma unroll
        for (int np = 0; np < kMaxP / 16; ++np) {
          if (16 * ks < N && 16 * np < P) {
            // B(k = n, p) = E[p][n]
            const int o = (16 * np + r8 + (mi >> 1) * 8) * Lo::ldN +
                          16 * ks + (mi & 1) * 8;
            uint32_t bh[4], bl[4];
            ldsm_x4(bh, sE + o);
            ldsm_x4(bl, sE + Lo::kN + o);
            mma_bf16(acc[2 * np], cf[ks], bh[0], bh[1]);
            mma_bf16(acc[2 * np], cf[ks], bl[0], bl[1]);
            mma_bf16(acc[2 * np + 1], cf[ks], bh[2], bh[3]);
            mma_bf16(acc[2 * np + 1], cf[ks], bl[2], bl[3]);
          }
        }
      }
    } else {
      gemm<false, false>(acc, sC, Lo::ldN, sE, Lo::ldN, m0, N, P);
    }
    const float e0 = decay<kTwo>(sCumQ[m0 + gq], 0.f);
    const float e1 = decay<kTwo>(sCumQ[m0 + gq + 8], 0.f);
#pragma unroll
    for (int nt = 0; nt < kMaxP / 8; ++nt) {
      acc[nt][0] *= e0;
      acc[nt][1] *= e0;
      acc[nt][2] *= e1;
      acc[nt][3] *= e1;
    }
  }
  __syncthreads();  // the entering state (and, for bf16, C) is read

  // key tile j0 into `stage`: B and x rows by cp.async, cum and dt
  auto fetch = [&](int j0, int stage) {
    T* sB = base + Lo::kKeys + stage * Lo::kStage;
    load_tile(sB, Lo::ldN, Bb + j0 * bc_row, bc_row, N, L - j0);
    load_tile(sB + Lo::kN, Lo::ldP, xb + j0 * x_row, x_row, P, L - j0);
    cp_async_commit();
    if (tid < kT) {
      const bool live = j0 + tid < L;
      sCumK[stage * kT + tid] = live ? cumc[j0 + tid] * cum_scale : 0.f;
      sDtK[stage * kT + tid] =
          live ? dtb[static_cast<size_t>(j0 + tid) * H] : 0.f;
    }
  };
  fetch(0, 0);
  int stage = 0;
  for (int j0 = 0;; j0 += kT) {
    const bool more = j0 + kT <= i0;
    if (Lo::kStages == 2 && more) {
      fetch(j0 + kT, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sB = base + Lo::kKeys + stage * Lo::kStage;
    const T* sX = sB + Lo::kN;
    const float* cumK = sCumK + stage * kT;
    const float* dtK = sDtK + stage * kT;
    // on the diagonal tile this warp's rows see only the keys below m0 + 16
    const int n_keys = j0 == i0 ? m0 + 16 : kT;
    // scores C_i B_j^T (exact products): A = C [i][n], B = B_j [j][n]
    float s[kT / 8][4] = {};
    if constexpr (kTwo) {
#pragma unroll
      for (int ks = 0; ks < kMaxN / 16; ++ks) {
#pragma unroll
        for (int np = 0; np < kT / 16; ++np) {
          if (16 * ks < N && 16 * np < n_keys) {
            uint32_t bf[4];
            ldsm_x4(bf, sB + (16 * np + r8 + (mi >> 1) * 8) * Lo::ldN +
                            16 * ks + (mi & 1) * 8);
            mma_bf16(s[2 * np], cf[ks], bf[0], bf[1]);
            mma_bf16(s[2 * np + 1], cf[ks], bf[2], bf[3]);
          }
        }
      }
    } else {
      gemm<false, false>(s, sC, Lo::ldN, sB, Lo::ldN, m0, N, n_keys);
    }
    // decayed, and masked where the tile crosses the diagonal or S
    const bool full = j0 < i0 && i0 + kT <= L;
    const float cq[2] = {sCumQ[m0 + gq], sCumQ[m0 + gq + 8]};
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
      const int j = 8 * nt + 2 * t;
      const float2 ck = *reinterpret_cast<const float2*>(cumK + j);
      const float2 dk = *reinterpret_cast<const float2*>(dtK + j);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int il = i0 + m0 + gq + 8 * (q >> 1), jl = j0 + j + (q & 1);
        const float w = decay<kTwo>(cq[q >> 1], q & 1 ? ck.y : ck.x) *
                        (q & 1 ? dk.y : dk.x);
        s[nt][q] = full || (jl <= il && il < L) ? s[nt][q] * w : 0.f;
      }
    }
    // y_intra += S x_j: A = S [i][j] (split), B = x_j stored [j][p]
    if constexpr (kTwo) {
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        if (16 * kk < n_keys) {
          uint32_t ah[4], al[4];
          split2(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
          split2(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
          split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
          split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
          for (int np = 0; np < kMaxP / 16; ++np) {
            if (16 * np < P) {
              uint32_t bf[4];
              ldsm_x4_t(bf, sX + (16 * kk + r8 + (mi & 1) * 8) * Lo::ldP +
                                16 * np + (mi >> 1) * 8);
              mma_bf16(acc[2 * np], ah, bf[0], bf[1]);
              mma_bf16(acc[2 * np], al, bf[0], bf[1]);
              mma_bf16(acc[2 * np + 1], ah, bf[2], bf[3]);
              mma_bf16(acc[2 * np + 1], al, bf[2], bf[3]);
            }
          }
        }
      }
    } else {
      // through this warp's own 16 rows of the score tile
      float* sS = reinterpret_cast<float*>(base + Lo::kN + Lo::kStage);
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt) {
        const int o = (m0 + gq) * Lo::ldK + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(sS + o) = make_float2(s[nt][0], s[nt][1]);
        *reinterpret_cast<float2*>(sS + o + 8 * Lo::ldK) =
            make_float2(s[nt][2], s[nt][3]);
      }
      __syncwarp();
      gemm<false, true>(acc, sS, Lo::ldK, reinterpret_cast<const float*>(sX),
                        Lo::ldP, m0, n_keys, P);
    }
    if (!more) break;
    __syncthreads();  // every warp is done with this stage
    if (Lo::kStages == 1) fetch(j0 + kT, 0);
    stage ^= Lo::kStages - 1;
  }

  // the last key tile holds this query tile's own x rows
  const T* sX = base + Lo::kKeys + stage * Lo::kStage + Lo::kN;
  const float d_h = Dv[h];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + gq + 8 * half;
    if (i0 + r >= L) continue;
#pragma unroll
    for (int nt = 0; nt < kMaxP / 8; ++nt) {
      const int p = 8 * nt + 2 * t;
      if (p < P)
        store2<T>(yb + static_cast<size_t>(i0 + r) * x_row + p,
                  acc[nt][2 * half] + d_h * to_f32(sX[r * Lo::ldP + p]),
                  acc[nt][2 * half + 1] +
                      d_h * to_f32(sX[r * Lo::ldP + p + 1]));
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D,
                   const float* init, void* y, float* fin, float* st,
                   float* entry, float* cum, int B, int S, int H, int P,
                   int G, int N, int Q, cudaStream_t stream) {
  using Lo = Layout<T>;
  const int nc = (S + Q - 1) / Q, n_qt = (Q + kT - 1) / kT;
  const size_t b_states = Lo::states * sizeof(T) + (2 * Q + 2 * kT) * 4;
  const size_t b_output = Lo::output_bytes;
  static size_t configured = 0;  // largest pass-1 size allowed so far
  if (b_states > configured) {
    cudaError_t e = allow_smem(ssd_scan_kernel_states<T>, b_states);
    if (e == cudaSuccess)
      e = allow_smem(ssd_scan_kernel_output<T>, b_output);
    if (e != cudaSuccess) return e;
    configured = b_states;
  }
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(Bm);
  ssd_scan_kernel_states<T><<<dim3(nc, H, B), kThreads, b_states, stream>>>(
      xt, dt, A, Bt, st, cum, S, H, P, G, N, Q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int PN = P * N;
  ssd_scan_kernel_carry<<<dim3((PN + kCarry - 1) / kCarry, H, B), kThreads,
                          0, stream>>>(st, cum, init, entry, fin, Lo::kTwo, S,
                                       H, PN, Q, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_scan_kernel_output<T>
      <<<dim3(H, nc, n_qt * B), kThreads, b_output, stream>>>(
          xt, dt, Bt, static_cast<const T*>(Cm), D, entry, cum,
          init != nullptr, static_cast<T*>(y), S, H, P, G, N, Q);
  return cudaGetLastError();
}

}  // namespace

// init may be null (a zero state). All tensors contiguous on the device;
// x, Bm, Cm, init and the scratch 16-byte aligned. st and entry: each
// B*H*ceil(S/Q)*P*N floats, cum: B*H*ceil(S/Q)*Q floats, all written
// before they are read.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               const void* init, void* y, void* fin,
                               void* st, void* entry, void* cum, int B, int S,
                               int H, int P, int G, int N, int Q, int bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S <= 0 || Q <= 0 || Q > 4096 || G <= 0 ||
      H % G != 0 || P <= 0 || P > kMaxP || N <= 0 || N > kMaxN ||
      P % 16 != 0 || N % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* initf = static_cast<const float*>(init);
  float* finf = static_cast<float*>(fin);
  float* stf = static_cast<float*>(st);
  float* entf = static_cast<float*>(entry);
  float* cumf = static_cast<float*>(cum);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, Df, initf, y, finf,
                                   stf, entf, cumf, B, S, H, P, G, N, Q, s)
           : launch<float>(x, dtf, Af, Bm, Cm, Df, initf, y, finf, stf,
                           entf, cumf, B, S, H, P, G, N, Q, s);
  return static_cast<int>(e);
}
