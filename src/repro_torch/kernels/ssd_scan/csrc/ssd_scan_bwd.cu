// Kernel B4's backward: the gradients of the Mamba-2 SSD chunked scan, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel, and its
// gradient through the scan is XLA's autodiff of the jnp `ssd_chunked_ref`
// (src/repro/kernels/ssd_scan/ref.py). It runs as the backward of the
// forward kernel (ssd_scan.cu) under autograd, and takes the forward's
// scratch: the chunk cumsums of dt * A, and the state entering each chunk
// (for bf16 inputs stored as bf16 hi and lo tiles).
//
//   x, dy: (B, S, H, P) and Bm, Cm: (B, S, G, N), one type (fp32 or bf16);
//   dt: (B, S, H), A, D: (H,), dfin: (B, H, P, N) or null, all fp32.
//   dx (B, S, H, P), dBm, dCm (B, S, G, N) in x's type; ddt (B, S, H), dA,
//   dD (H,), dinit (B, H, P, N) fp32.
//
// With cum the chunk-local cumsum of dt * A, cum_L its value at the chunk's
// end, E the state entering the chunk and G the gradient of the state
// leaving it, S_ij = (C_i . B_j) exp(cum_i - cum_j) and M_ij = (dy_i . x_j)
// dt_j exp(cum_i - cum_j) for j <= i (0 above), R_ij = S_ij (dy_i . x_j),
// t_j = exp(cum_L - cum_j), v_j = t_j x_j^T G B_j (`ssd_scan_bwd` in
// ops.py derives it):
//   G_prev = exp(cum_L) G + sum_i exp(cum_i) dy_i^T C_i  (reverse carry)
//   dx_j   = dt_j (sum_i S_ij dy_i + t_j G B_j) + D dy_j
//   dB_j   = sum_i M_ij C_i + t_j dt_j G^T x_j
//   dC_i   = sum_j M_ij B_j + exp(cum_i) E^T dy_i
//   ddt_j  = sum_i R_ij + v_j + A da_j
//   dcum_i = sum_j R_ij dt_j - dt_i (sum_k R_ki + v_i)
//            + C_i . (exp(cum_i) E^T dy_i)   [+ sum_j dt_j v_j
//            + exp(cum_L) <E, G> at the chunk's last position]
// and da the reverse cumsum of dcum within the chunk; dA = sum dt da,
// dD = sum x . dy. A ragged last chunk's missing positions act as dt = 0,
// x = 0, dy = 0, as in the forward.
//
// Six passes, the forward's three-pass shape turned round:
//   1. `states`, one CTA per (chunk, head, batch): each chunk's
//      sum_i exp(cum_i) dy_i^T C_i, a (P, N) product like the forward's own
//      state, into the fp32 scratch `own`.
//   2. `carry`, per (batch, head) and 512 state entries a CTA, as the
//      forward's carry: the reverse carry over the chunks, last to first
//      (the loads of four chunks in flight at once); it writes G, the
//      gradient of the state leaving each chunk (for bf16 inputs split once
//      here into bf16 hi and lo tiles, as the forward stores E), dinit, and
//      the CTA's part of each chunk's exp(cum_L) <E, G>.
//   3. `dc`, one CTA per (64-row query tile, chunk, slice of heads, batch),
//      heaviest tiles first: dC_i summed over the slice's heads (into the
//      fp32 scratch `dBCh`) and each row's part of dcum, head by head.
//   4. `dbx`, one CTA per (64-row key tile, chunk, slice of heads, batch):
//      dx_j of each head, dB_j summed over the slice's heads, sum_i R_ij +
//      v_j, dt_j v_j and x_j . dy_j. Passes 3 and 4 each compute the score
//      tiles C B^T and dy x^T of their pairs of tiles, as flash attention's
//      backward splits dq from dk and dv.
//   5. `decay`, one CTA per (chunk, head, batch): dcum, its reverse cumsum
//      (one warp, in double), ddt, and the chunk's parts of dA and dD.
//   6. `reduce`: dB and dC summed over each group's slices and cast to the
//      input type; its last CTA sums dA and dD.
// Nothing is added by atomics: every output is the same, bit for bit, from
// call to call.
//
// bf16 inputs (the training paths; passes 1, 3 and 4 are the `_tc`
// kernels): every product runs on the tensor cores as the forward's do,
// `mma.sync.m16n8k16` bf16 with fp32 accumulation (mma_sync.cuh), operands
// as bf16 shared tiles through `ldmatrix`, key (pass 3) or query (pass 4)
// tiles loaded by `cp.async` two stages deep. C B^T and dy x^T have two
// bf16 operands: one exact pass each. The other products have one fp32
// operand, taken as bf16 hi = bf16(v) and lo = bf16(v - hi) in two passes
// against the exact bf16 operand: the decayed dy of pass 1 (split in
// registers), E and G (read as the hi and lo tiles passes 2 of the forward
// and of this kernel wrote), and the masked, decayed score tiles M, S^T and
// M^T, which go from the accumulators into the next product's A fragments
// without touching shared memory. `ssd_scan_bwd(..., split=True)` in ops.py
// repeats this rounding on the CPU. The decays of the score tiles use the
// hardware's ex2 on cumsums pre-scaled by log2(e). A CTA of passes 3 and 4
// takes its heads (a slice of one group's, `Dims::hs` of them) one after
// another, keeping the group's shared C (pass 3) or B (pass 4) tile and the
// dC or dB sum in place, so that the per-head scratch `dBCh` holds H / hs
// partial sums a position and not H. Shared memory: ~79 KB a CTA (the
// slice's C or B tile, a head's dy or x tile, and two stages of the other
// side's tiles, over which E or G is read first), two CTAs an SM.
//
// fp32 inputs (the reduced models' and the tests' path, held at 1e-4):
// passes 1, 3 and 4 are fp32 FMAs from padded shared tiles (fma_gemm.cuh),
// one head a CTA, the score tiles through shared memory.
//
// What bounds it on the H100: at the training shape (B = 2, S = 4096,
// H = 64, P = 64, N = 128, Q = 256) the least work is ~164 GFLOP of bf16
// products (both passes of every split product, C B^T once a group, dy x^T
// once a head), 0.166 ms at the tensor cores' rate, above the ~0.2 GB that
// must move. The kernel recomputes C B^T and dy x^T in passes 3 and 4 and
// C B^T per head, and feeds mma.sync from 64-row tiles; where its time goes
// is in PERF.md.
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
using repro::split_frag;
using repro::store2;
using repro::warp_sum;

constexpr int kThreads = 128;   // four warps, 16 rows each
constexpr int kT = 64;          // rows of a tile
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
// fp32 path: padded fp32 rows, so that the FMA reads of eight rows hit
// eight banks
constexpr int kLdP = kMaxP + 4;
constexpr int kLdN = kMaxN + 4;
constexpr int kLdK = kT + 4;
constexpr int kTileP = kT * kLdP, kTileN = kT * kLdN, kTileK = kT * kLdK;
// bf16 path: padded bf16 rows, so that ldmatrix's eight rows hit eight
// 16-byte bank groups
constexpr int kHP = kMaxP + 8;
constexpr int kHN = kMaxN + 8;
constexpr int kHTileP = kT * kHP, kHTileN = kT * kHN;
constexpr int kHStage = kHTileN + kHTileP;   // a C or B tile and a dy or x
constexpr int kCarry = kThreads * 4;         // state entries a carry CTA
constexpr float kLog2e = 1.44269504088896341f;

// four consecutive fp32 values
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// 2^v, the hardware's ex2 (the bf16 path's decays, on cumsums pre-scaled
// by log2(e), as the forward's)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// fp32: `rows` rows of `cols` values, `stride` elements apart, into fp32
// rows of `ld`; rows at or past `live` are zeros
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, size_t stride,
                                          int cols, int live,
                                          int rows = kT) {
  const int per_row = cols / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 4;
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        r < live ? load4(src + r * stride + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// bf16: kT rows by cp.async into rows of `ld`, zeros at or past `live`
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          size_t stride, int cols,
                                          int live) {
  repro::load_tile<kT, kThreads>(dst, ld, src, stride, cols, live);
}

// kT values `stride` apart (cum, dt), zeros at or past `live`
__device__ __forceinline__ void load_col(float* dst, const float* src,
                                         size_t stride, int live) {
  if (threadIdx.x < kT)
    dst[threadIdx.x] = threadIdx.x < live ? src[threadIdx.x * stride] : 0.f;
}

// the sum over the CTA's threads, returned to every thread; `red` holds
// one float a warp
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // an earlier call's readers are done with `red`
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// the sum of a row's values over the four threads of a quad
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

struct Dims {
  int S, H, P, G, N, Q, nc;
  int hs;   // heads a CTA of passes 3 and 4 takes (1 for fp32)
  __host__ __device__ size_t x_row() const {
    return static_cast<size_t>(H) * P;
  }
  __host__ __device__ size_t bc_row() const {
    return static_cast<size_t>(G) * N;
  }
  __host__ __device__ int slices() const { return H / hs; }
};

// ---- fp32, pass 1: sum_i exp(cum_i) dy_i^T C_i per chunk ------------------
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_states(const float* __restrict__ dy,
                          const float* __restrict__ Cm,
                          const float* __restrict__ cum,
                          float* __restrict__ own, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* sDy = smem;                 // [i][p]
  float* sC = sDy + kTileP;          // [i][n]
  float* sF = sC + kTileN;           // exp(cum_i)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (d.H / d.G), warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int c0 = c * d.Q, L = min(d.Q, d.S - c0), p0 = 16 * warp;
  const size_t pos0 = static_cast<size_t>(b) * d.S + c0;
  const float* dyb = dy + pos0 * d.x_row() + h * d.P;
  const float* Cb = Cm + pos0 * d.bc_row() + g * d.N;
  const size_t bhc = (static_cast<size_t>(b) * d.H + h) * d.nc + c;
  float acc[kMaxN / 8][4] = {};
  for (int i0 = 0; i0 < L; i0 += kT) {
    load_rows(sDy, kLdP, dyb + i0 * d.x_row(), d.x_row(), d.P, L - i0);
    load_rows(sC, kLdN, Cb + i0 * d.bc_row(), d.bc_row(), d.N, L - i0);
    if (threadIdx.x < kT)
      sF[threadIdx.x] = i0 + threadIdx.x < L
                            ? expf(cum[bhc * d.Q + i0 + threadIdx.x]) : 0.f;
    __syncthreads();
    // (P x N) += (dy_i f_i)^T C_i: A = dy stored [i][p], B = C stored [i][n]
    if (p0 < d.P)
      gemm<true, true>(acc, sDy, kLdP, sC, kLdN, p0, kT, d.N, sF);
    __syncthreads();
  }
  if (p0 < d.P) {
    float* out = own + bhc * d.P * d.N;
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      const int n = 8 * nt + 2 * t;
      if (n < d.N) {
        *reinterpret_cast<float2*>(out + (p0 + gq) * d.N + n) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(out + (p0 + gq + 8) * d.N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }
}


// ---- bf16, pass 1: sum_i exp(cum_i) dy_i^T C_i per chunk -----------------
// A = dy stored [i][p], each k scaled by exp(cum_i) and split; B = C stored
// [i][n]: the forward's chunk-state product with dy for x and C for B.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_states_tc(const bf16* __restrict__ dy,
                             const bf16* __restrict__ Cm,
                             const float* __restrict__ cum,
                             float* __restrict__ own, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* base = reinterpret_cast<bf16*>(smem_raw);   // [stage]: dy, then C
  float* sF = reinterpret_cast<float*>(base + 2 * kHStage);  // [stage][kT]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (d.H / d.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3, r8 = lane & 7, mi = lane >> 3;
  const int c0 = c * d.Q, L = min(d.Q, d.S - c0), p0 = 16 * warp;
  const size_t xr = d.x_row(), bcr = d.bc_row();
  const bf16* dyb = dy + (static_cast<size_t>(b) * d.S + c0) * xr + h * d.P;
  const bf16* Cb = Cm + (static_cast<size_t>(b) * d.S + c0) * bcr + g * d.N;
  const size_t bhc = (static_cast<size_t>(b) * d.H + h) * d.nc + c;
  const float* cumc = cum + bhc * d.Q;

  auto fetch = [&](int i0, int stage) {
    bf16* s = base + stage * kHStage;
    load_tile(s, kHP, dyb + i0 * xr, xr, d.P, L - i0);
    load_tile(s + kHTileP, kHN, Cb + i0 * bcr, bcr, d.N, L - i0);
    cp_async_commit();
    if (tid < kT)
      sF[stage * kT + tid] = i0 + tid < L ? expf(cumc[i0 + tid]) : 0.f;
  };
  float acc[kMaxN / 8][4] = {};
  fetch(0, 0);
  int stage = 0;
  for (int i0 = 0;; i0 += kT) {
    const bool more = i0 + kT < L;
    if (more) {
      fetch(i0 + kT, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sdy = base + stage * kHStage;
    const bf16* sc = sdy + kHTileP;
    const float* f = sF + stage * kT;
    if (p0 < d.P) {
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        uint32_t ay[4], ah[4], al[4];
        ldsm_x4_t(ay, sdy + (16 * kk + r8 + (mi >> 1) * 8) * kHP + p0 +
                          (mi & 1) * 8);
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // a[q]: k = 16 kk + 2t (+8 for q > 1)
          const int k = 16 * kk + 2 * t + 8 * (q >> 1);
          const float2 v =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  &ay[q]));
          split2(v.x * f[k], v.y * f[k + 1], ah[q], al[q]);
        }
#pragma unroll
        for (int np = 0; np < kMaxN / 16; ++np) {
          if (16 * np < d.N) {
            uint32_t bf[4];
            ldsm_x4_t(bf, sc + (16 * kk + r8 + (mi & 1) * 8) * kHN +
                              16 * np + (mi >> 1) * 8);
            mma_bf16(acc[2 * np], ah, bf[0], bf[1]);
            mma_bf16(acc[2 * np], al, bf[0], bf[1]);
            mma_bf16(acc[2 * np + 1], ah, bf[2], bf[3]);
            mma_bf16(acc[2 * np + 1], al, bf[2], bf[3]);
          }
        }
      }
    }
    if (!more) break;
    __syncthreads();  // every warp is done with this stage
    stage ^= 1;
  }
  if (p0 < d.P) {
    float* out = own + bhc * d.P * d.N;
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      const int n = 8 * nt + 2 * t;
      if (n < d.N) {
        *reinterpret_cast<float2*>(out + (p0 + gq) * d.N + n) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(out + (p0 + gq + 8) * d.N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }
}

// ---- pass 2: the reverse carry -------------------------------------------
// Each thread holds four entries of the state's gradient G. Chunk c's slot
// of `own` holds its sum_i exp(cum_i) dy_i^T C_i; its slot of `gst`
// receives G leaving chunk c (for bf16 inputs a bf16 hi tile then a bf16
// lo tile in the slot's bytes, as `entry`), and `carry_part` the CTA's part
// of exp(cum_L) <E, G>.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_carry(const float* __restrict__ own,
                         float* __restrict__ gst,
                         const float* __restrict__ entry,
                         const float* __restrict__ cum,
                         const float* __restrict__ dfin,
                         float* __restrict__ dinit,
                         float* __restrict__ carry_part, bool split,
                         Dims d) {
  constexpr int kAhead = 4;  // chunks whose loads are in flight together
  __shared__ float red[kThreads / 32];
  const int PN = d.P * d.N, n_cc = gridDim.x;
  const int i = (blockIdx.x * kThreads + threadIdx.x) * 4;
  const bool live = i < PN;
  const size_t bh = static_cast<size_t>(blockIdx.z) * d.H + blockIdx.y;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 G = live && dfin != nullptr ? load4(dfin + bh * PN + i) : zero;
  for (int top = d.nc - 1; top >= 0; top -= kAhead) {
    float4 mine[kAhead], E[kAhead];
    float decay[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = top - k;
      mine[k] = E[k] = zero;
      decay[k] = 0.f;
      if (c < 0) continue;
      const size_t slot = (bh * d.nc + c) * PN;
      decay[k] = expf(cum[(bh * d.nc + c) * d.Q +
                          min(d.Q, d.S - c * d.Q) - 1]);
      if (!live) continue;
      mine[k] = load4(own + slot + i);
      if (split) {
        const bf16* half = reinterpret_cast<const bf16*>(entry + slot);
        const uint2 hv = *reinterpret_cast<const uint2*>(half + i);
        const uint2 lv = *reinterpret_cast<const uint2*>(half + PN + i);
        const float2 h0 = bf2(reinterpret_cast<const bf16*>(&hv.x));
        const float2 h1 = bf2(reinterpret_cast<const bf16*>(&hv.y));
        const float2 l0 = bf2(reinterpret_cast<const bf16*>(&lv.x));
        const float2 l1 = bf2(reinterpret_cast<const bf16*>(&lv.y));
        E[k] = make_float4(h0.x + l0.x, h0.y + l0.y, h1.x + l1.x,
                           h1.y + l1.y);
      } else {
        E[k] = load4(entry + slot + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = top - k;
      if (c < 0) break;   // the same for every thread
      const float dot = block_sum(dot4(E[k], G), red);
      if (threadIdx.x == 0)
        carry_part[(bh * d.nc + c) * n_cc + blockIdx.x] = decay[k] * dot;
      if (live) {
        float* slot = gst + (bh * d.nc + c) * PN;
        if (split) {
          uint32_t hi[2], lo[2];
          split2(G.x, G.y, hi[0], lo[0]);
          split2(G.z, G.w, hi[1], lo[1]);
          bf16* half = reinterpret_cast<bf16*>(slot);
          *reinterpret_cast<uint2*>(half + i) = make_uint2(hi[0], hi[1]);
          *reinterpret_cast<uint2*>(half + PN + i) = make_uint2(lo[0], lo[1]);
        } else {
          *reinterpret_cast<float4*>(slot + i) = G;
        }
      }
      G = make_float4(G.x * decay[k] + mine[k].x, G.y * decay[k] + mine[k].y,
                      G.z * decay[k] + mine[k].z, G.w * decay[k] + mine[k].w);
    }
  }
  if (live) *reinterpret_cast<float4*>(dinit + bh * PN + i) = G;
}

// ---- bf16, pass 3: dC and each row's part of dcum ------------------------
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_dc_tc(const bf16* __restrict__ x,
                         const float* __restrict__ dt,
                         const bf16* __restrict__ Bm,
                         const bf16* __restrict__ Cm,
                         const bf16* __restrict__ dy,
                         const float* __restrict__ entry,
                         const float* __restrict__ cum,
                         float* __restrict__ dCh,
                         float* __restrict__ row_dcum, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);   // query rows [i][n]
  bf16* sDy = sC + kHTileN;                       // a head's [i][p]
  bf16* sR = sDy + kHTileP;        // E hi, lo [p][n]; then two key stages
  float* sCumQ = reinterpret_cast<float*>(sR + 2 * kHStage);
  float* sCumK = sCumQ + kT;                      // [stage][kT]
  float* sDtK = sCumK + 2 * kT;                   // [stage][kT]

  const int slice = blockIdx.x, c = blockIdx.y;
  const int n_qt = (d.Q + kT - 1) / kT, B = gridDim.z / n_qt;
  const int b = blockIdx.z % B, qt = n_qt - 1 - blockIdx.z / B;
  const int h0 = slice * d.hs, g = h0 / (d.H / d.G);
  const int c0 = c * d.Q, L = min(d.Q, d.S - c0), i0 = qt * kT;
  if (i0 >= L) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3, m0 = 16 * warp;
  const int r8 = lane & 7, mi = lane >> 3;
  const size_t xr = d.x_row(), bcr = d.bc_row();
  const size_t pos0 = static_cast<size_t>(b) * d.S + c0;
  const bf16* Cb = Cm + pos0 * bcr + g * d.N;
  const bf16* Bb = Bm + pos0 * bcr + g * d.N;
  const int PN = d.P * d.N;

  load_tile(sC, kHN, Cb + i0 * bcr, bcr, d.N, L - i0);
  float acc[kMaxN / 8][4] = {};   // dC over the slice's heads
  for (int hh = 0; hh < d.hs; ++hh) {
    const int h = h0 + hh;
    const bf16* xb = x + pos0 * xr + h * d.P;
    const bf16* dyb = dy + pos0 * xr + h * d.P;
    const float* dtb = dt + pos0 * d.H + h;
    const size_t bhc = (static_cast<size_t>(b) * d.H + h) * d.nc + c;
    const float* cumc = cum + bhc * d.Q;
    if (hh > 0) __syncthreads();   // the last head is done with sDy, sR
    load_tile(sDy, kHP, dyb + i0 * xr, xr, d.P, L - i0);
    const bf16* e = reinterpret_cast<const bf16*>(entry + bhc * PN);
    load_tile(sR, kHN, e, d.N, d.N, d.P);
    load_tile(sR + kHTileN, kHN, e + PN, d.N, d.N, d.P);
    cp_async_commit();
    if (tid < kT)
      sCumQ[tid] = i0 + tid < L ? cumc[i0 + tid] * kLog2e : 0.f;
    cp_async_wait<0>();
    __syncthreads();

    // this warp's 16 rows of dy as A fragments, for both of its products
    uint32_t yf[kMaxP / 16][4];
#pragma unroll
    for (int ks = 0; ks < kMaxP / 16; ++ks)
      if (16 * ks < d.P)
        ldsm_x4(yf[ks], sDy + (m0 + r8 + (mi & 1) * 8) * kHP + 16 * ks +
                            (mi >> 1) * 8);
    // exp(cum_i) E^T dy_i: A = dy [i][p], B(k = p, n) = E stored [p][n]
    float part0 = 0.f, part1 = 0.f;  // C_i . (exp(cum_i) E^T dy_i), then + W
    {
      float ed[kMaxN / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < kMaxP / 16; ++ks) {
#pragma unroll
        for (int np = 0; np < kMaxN / 16; ++np) {
          if (16 * ks < d.P && 16 * np < d.N) {
            const int o = (16 * ks + r8 + (mi & 1) * 8) * kHN + 16 * np +
                          (mi >> 1) * 8;
            uint32_t bh[4], bl[4];
            ldsm_x4_t(bh, sR + o);
            ldsm_x4_t(bl, sR + kHTileN + o);
            mma_bf16(ed[2 * np], yf[ks], bh[0], bh[1]);
            mma_bf16(ed[2 * np], yf[ks], bl[0], bl[1]);
            mma_bf16(ed[2 * np + 1], yf[ks], bh[2], bh[3]);
            mma_bf16(ed[2 * np + 1], yf[ks], bl[2], bl[3]);
          }
        }
      }
      const float e0 = ex2(sCumQ[m0 + gq]), e1 = ex2(sCumQ[m0 + gq + 8]);
      const bf16* c_a = sC + (m0 + gq) * kHN;
      const bf16* c_b = c_a + 8 * kHN;
#pragma unroll
      for (int nt = 0; nt < kMaxN / 8; ++nt) {
        const int n = 8 * nt + 2 * t;
        if (n < d.N) {
          const float2 ca = bf2(c_a + n), cb = bf2(c_b + n);
          const float v0 = ed[nt][0] * e0, v1 = ed[nt][1] * e0;
          const float v2 = ed[nt][2] * e1, v3 = ed[nt][3] * e1;
          part0 += v0 * ca.x + v1 * ca.y;
          part1 += v2 * cb.x + v3 * cb.y;
          acc[nt][0] += v0;
          acc[nt][1] += v1;
          acc[nt][2] += v2;
          acc[nt][3] += v3;
        }
      }
    }
    __syncthreads();  // every warp is done with E

    // key tile j0 into `stage`: B and x rows by cp.async, cum and dt
    auto fetch = [&](int j0, int stage) {
      bf16* s = sR + stage * kHStage;
      load_tile(s, kHN, Bb + j0 * bcr, bcr, d.N, L - j0);
      load_tile(s + kHTileN, kHP, xb + j0 * xr, xr, d.P, L - j0);
      cp_async_commit();
      if (tid < kT) {
        const bool live = j0 + tid < L;
        sCumK[stage * kT + tid] = live ? cumc[j0 + tid] * kLog2e : 0.f;
        sDtK[stage * kT + tid] =
            live ? dtb[static_cast<size_t>(j0 + tid) * d.H] : 0.f;
      }
    };
    fetch(0, 0);
    int stage = 0;
    const float cq[2] = {sCumQ[m0 + gq], sCumQ[m0 + gq + 8]};
    for (int j0 = 0;; j0 += kT) {
      const bool more = j0 + kT <= i0;
      if (more) {
        fetch(j0 + kT, stage ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* sB = sR + stage * kHStage;
      const bf16* sX = sB + kHTileN;
      const float* cumK = sCumK + stage * kT;
      const float* dtK = sDtK + stage * kT;
      // on the diagonal tile this warp's rows see only the keys below m0 + 16
      const int n_keys = j0 == i0 ? m0 + 16 : kT;
      // C_i B_j^T and dy_i x_j^T (exact): B(k, j) = B_j, x_j stored [j][k]
      float cb[kT / 8][4] = {}, m[kT / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < kMaxN / 16; ++ks) {
        if (16 * ks < d.N) {
          uint32_t ca[4];
          ldsm_x4(ca, sC + (m0 + r8 + (mi & 1) * 8) * kHN + 16 * ks +
                          (mi >> 1) * 8);
#pragma unroll
          for (int np = 0; np < kT / 16; ++np) {
            if (16 * np < n_keys) {
              uint32_t bf[4];
              ldsm_x4(bf, sB + (16 * np + r8 + (mi >> 1) * 8) * kHN +
                              16 * ks + (mi & 1) * 8);
              mma_bf16(cb[2 * np], ca, bf[0], bf[1]);
              mma_bf16(cb[2 * np + 1], ca, bf[2], bf[3]);
            }
          }
        }
      }
#pragma unroll
      for (int ks = 0; ks < kMaxP / 16; ++ks) {
#pragma unroll
        for (int np = 0; np < kT / 16; ++np) {
          if (16 * ks < d.P && 16 * np < n_keys) {
            uint32_t bf[4];
            ldsm_x4(bf, sX + (16 * np + r8 + (mi >> 1) * 8) * kHP +
                            16 * ks + (mi & 1) * 8);
            mma_bf16(m[2 * np], yf[ks], bf[0], bf[1]);
            mma_bf16(m[2 * np + 1], yf[ks], bf[2], bf[3]);
          }
        }
      }
      // M: decayed, masked where the tile crosses the diagonal or S
      const bool full = j0 < i0 && i0 + kT <= L;
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt) {
        const int j = 8 * nt + 2 * t;
        const float2 ck = *reinterpret_cast<const float2*>(cumK + j);
        const float2 dk = *reinterpret_cast<const float2*>(dtK + j);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int il = i0 + m0 + gq + 8 * (q >> 1), jl = j0 + j + (q & 1);
          const float w = ex2(cq[q >> 1] - (q & 1 ? ck.y : ck.x)) *
                          (q & 1 ? dk.y : dk.x);
          const float v =
              full || (jl <= il && il < L) ? m[nt][q] * w : 0.f;
          if (q >> 1) part1 += cb[nt][q] * v; else part0 += cb[nt][q] * v;
          m[nt][q] = v;
        }
      }
      // dC_i += M_ij B_j: A = M (split), B(k = j, n) = B_j stored [j][n]
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        if (16 * kk < n_keys) {
          uint32_t ah[4], al[4];
          split_frag(m, kk, ah, al);
#pragma unroll
          for (int np = 0; np < kMaxN / 16; ++np) {
            if (16 * np < d.N) {
              uint32_t bf[4];
              ldsm_x4_t(bf, sB + (16 * kk + r8 + (mi & 1) * 8) * kHN +
                                16 * np + (mi >> 1) * 8);
              mma_bf16(acc[2 * np], ah, bf[0], bf[1]);
              mma_bf16(acc[2 * np], al, bf[0], bf[1]);
              mma_bf16(acc[2 * np + 1], ah, bf[2], bf[3]);
              mma_bf16(acc[2 * np + 1], al, bf[2], bf[3]);
            }
          }
        }
      }
      if (!more) break;
      __syncthreads();  // every warp is done with this stage
      stage ^= 1;
    }
    part0 = quad_sum(part0);
    part1 = quad_sum(part1);
    if (t == 0) {
      if (i0 + m0 + gq < L) row_dcum[bhc * d.Q + i0 + m0 + gq] = part0;
      if (i0 + m0 + gq + 8 < L)
        row_dcum[bhc * d.Q + i0 + m0 + gq + 8] = part1;
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + gq + 8 * half;
    if (i0 + r >= L) continue;
    float* out = dCh + ((pos0 + i0 + r) * d.slices() + slice) * d.N;
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      const int n = 8 * nt + 2 * t;
      if (n < d.N)
        *reinterpret_cast<float2*>(out + n) =
            make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

// ---- bf16, pass 4: dx, dB and each key's sums ----------------------------
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_dbx_tc(const bf16* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ Dv,
                          const bf16* __restrict__ Bm,
                          const bf16* __restrict__ Cm,
                          const bf16* __restrict__ dy,
                          const float* __restrict__ gst,
                          const float* __restrict__ cum, bf16* __restrict__ dx,
                          float* __restrict__ dBh, float* __restrict__ key_r,
                          float* __restrict__ key_u,
                          float* __restrict__ key_xdy, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sB = reinterpret_cast<bf16*>(smem_raw);   // key rows [j][n]
  bf16* sX = sB + kHTileN;                        // a head's [j][p]
  bf16* sR = sX + kHTileP;      // G hi, lo [p][n]; then two query stages
  float* sCumJ = reinterpret_cast<float*>(sR + 2 * kHStage);
  float* sDtJ = sCumJ + kT;
  float* sCumI = sDtJ + kT;                       // [stage][kT]
  float* red = sCumI + 2 * kT;

  const int slice = blockIdx.x, c = blockIdx.y;
  const int n_kt = (d.Q + kT - 1) / kT, B = gridDim.z / n_kt;
  const int b = blockIdx.z % B, kt = blockIdx.z / B;
  const int h0 = slice * d.hs, g = h0 / (d.H / d.G);
  const int c0 = c * d.Q, L = min(d.Q, d.S - c0), j0 = kt * kT;
  if (j0 >= L) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3, m0 = 16 * warp;
  const int r8 = lane & 7, mi = lane >> 3;
  const int ra = m0 + gq, rb = m0 + gq + 8;
  const size_t xr = d.x_row(), bcr = d.bc_row();
  const size_t pos0 = static_cast<size_t>(b) * d.S + c0;
  const bf16* Bb = Bm + pos0 * bcr + g * d.N;
  const bf16* Cb = Cm + pos0 * bcr + g * d.N;
  const int PN = d.P * d.N;

  load_tile(sB, kHN, Bb + j0 * bcr, bcr, d.N, L - j0);
  float db[kMaxN / 8][4] = {};   // dB over the slice's heads
  for (int hh = 0; hh < d.hs; ++hh) {
    const int h = h0 + hh;
    const bf16* xb = x + pos0 * xr + h * d.P;
    const bf16* dyb = dy + pos0 * xr + h * d.P;
    const float* dtb = dt + pos0 * d.H + h;
    const size_t bhc = (static_cast<size_t>(b) * d.H + h) * d.nc + c;
    const float* cumc = cum + bhc * d.Q;
    if (hh > 0) __syncthreads();   // the last head is done with sX, sR
    load_tile(sX, kHP, xb + j0 * xr, xr, d.P, L - j0);
    const bf16* gs = reinterpret_cast<const bf16*>(gst + bhc * PN);
    load_tile(sR, kHN, gs, d.N, d.N, d.P);
    load_tile(sR + kHTileN, kHN, gs + PN, d.N, d.N, d.P);
    cp_async_commit();
    if (tid < kT) {
      const bool live = j0 + tid < L;
      sCumJ[tid] = live ? cumc[j0 + tid] * kLog2e : 0.f;
      sDtJ[tid] = live ? dtb[static_cast<size_t>(j0 + tid) * d.H] : 0.f;
    }
    const float cum_l = cumc[L - 1] * kLog2e;
    cp_async_wait<0>();
    __syncthreads();

    // this warp's 16 rows of x as A fragments, for all of its x products
    uint32_t xf[kMaxP / 16][4];
#pragma unroll
    for (int ks = 0; ks < kMaxP / 16; ++ks)
      if (16 * ks < d.P)
        ldsm_x4(xf[ks], sX + (m0 + r8 + (mi & 1) * 8) * kHP + 16 * ks +
                            (mi >> 1) * 8);
    const float te0 = ex2(cum_l - sCumJ[ra]), te1 = ex2(cum_l - sCumJ[rb]);
    const float dt0 = sDtJ[ra], dt1 = sDtJ[rb];
    // G B_j (j, p): A = B_j [j][n], B(k = n, p) = G stored [p][n]
    float dxa[kMaxP / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
      if (16 * ks < d.N) {
        uint32_t a[4];
        ldsm_x4(a, sB + (m0 + r8 + (mi & 1) * 8) * kHN + 16 * ks +
                       (mi >> 1) * 8);
#pragma unroll
        for (int np = 0; np < kMaxP / 16; ++np) {
          if (16 * np < d.P) {
            const int o = (16 * np + r8 + (mi >> 1) * 8) * kHN + 16 * ks +
                          (mi & 1) * 8;
            uint32_t bh[4], bl[4];
            ldsm_x4(bh, sR + o);
            ldsm_x4(bl, sR + kHTileN + o);
            mma_bf16(dxa[2 * np], a, bh[0], bh[1]);
            mma_bf16(dxa[2 * np], a, bl[0], bl[1]);
            mma_bf16(dxa[2 * np + 1], a, bh[2], bh[3]);
            mma_bf16(dxa[2 * np + 1], a, bl[2], bl[3]);
          }
        }
      }
    }
    // t_j dt_j G^T x_j (j, n), 64 columns at a time: A = x_j [j][p],
    // B(k = p, n) = G stored [p][n]
#pragma unroll
    for (int nh = 0; nh < kMaxN / 64; ++nh) {
      if (64 * nh < d.N) {
        float gx[8][4] = {};
#pragma unroll
        for (int ks = 0; ks < kMaxP / 16; ++ks) {
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (16 * ks < d.P && 64 * nh + 16 * np < d.N) {
              const int o = (16 * ks + r8 + (mi & 1) * 8) * kHN + 64 * nh +
                            16 * np + (mi >> 1) * 8;
              uint32_t bh[4], bl[4];
              ldsm_x4_t(bh, sR + o);
              ldsm_x4_t(bl, sR + kHTileN + o);
              mma_bf16(gx[2 * np], xf[ks], bh[0], bh[1]);
              mma_bf16(gx[2 * np], xf[ks], bl[0], bl[1]);
              mma_bf16(gx[2 * np + 1], xf[ks], bh[2], bh[3]);
              mma_bf16(gx[2 * np + 1], xf[ks], bl[2], bl[3]);
            }
          }
        }
        const float s0 = te0 * dt0, s1 = te1 * dt1;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          db[8 * nh + nt][0] += gx[nt][0] * s0;
          db[8 * nh + nt][1] += gx[nt][1] * s0;
          db[8 * nh + nt][2] += gx[nt][2] * s1;
          db[8 * nh + nt][3] += gx[nt][3] * s1;
        }
      }
    }
    // v_j = t_j x_j . G B_j
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kMaxP / 8; ++nt) {
      const int p = 8 * nt + 2 * t;
      if (p < d.P) {
        const float2 xa = bf2(sX + ra * kHP + p), xb2 = bf2(sX + rb * kHP + p);
        v0 += dxa[nt][0] * xa.x + dxa[nt][1] * xa.y;
        v1 += dxa[nt][2] * xb2.x + dxa[nt][3] * xb2.y;
      }
      dxa[nt][0] *= te0;
      dxa[nt][1] *= te0;
      dxa[nt][2] *= te1;
      dxa[nt][3] *= te1;
    }
    v0 = te0 * quad_sum(v0);
    v1 = te1 * quad_sum(v1);
    __syncthreads();  // every warp is done with G

    // query tile i0 into `stage`: C and dy rows by cp.async, and cum
    auto fetch = [&](int i0, int stage) {
      bf16* s = sR + stage * kHStage;
      load_tile(s, kHN, Cb + i0 * bcr, bcr, d.N, L - i0);
      load_tile(s + kHTileN, kHP, dyb + i0 * xr, xr, d.P, L - i0);
      cp_async_commit();
      if (tid < kT)
        sCumI[stage * kT + tid] =
            i0 + tid < L ? cumc[i0 + tid] * kLog2e : 0.f;
    };
    fetch(j0, 0);
    int stage = 0;
    const float cj[2] = {sCumJ[ra], sCumJ[rb]};
    const float dj[2] = {dt0, dt1};
    float rs[2] = {0.f, 0.f};        // sum_i R_ij
    for (int i0 = j0;; i0 += kT) {
      const bool more = i0 + kT < L;
      if (more) {
        fetch(i0 + kT, stage ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* sCq = sR + stage * kHStage;
      const bf16* sDq = sCq + kHTileN;
      const float* cumI = sCumI + stage * kT;
      // on the diagonal tile this warp's keys see only the queries from m0
      const int k_lo = i0 == j0 ? m0 / 16 : 0;
      // B_j C_i^T and x_j dy_i^T (exact): B(k, i) = C_i, dy_i stored [i][k]
      float s[kT / 8][4] = {}, m[kT / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < kMaxN / 16; ++ks) {
        if (16 * ks < d.N) {
          uint32_t a[4];
          ldsm_x4(a, sB + (m0 + r8 + (mi & 1) * 8) * kHN + 16 * ks +
                         (mi >> 1) * 8);
#pragma unroll
          for (int np = 0; np < kT / 16; ++np) {
            if (np >= k_lo) {
              uint32_t bf[4];
              ldsm_x4(bf, sCq + (16 * np + r8 + (mi >> 1) * 8) * kHN +
                              16 * ks + (mi & 1) * 8);
              mma_bf16(s[2 * np], a, bf[0], bf[1]);
              mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
            }
          }
        }
      }
#pragma unroll
      for (int ks = 0; ks < kMaxP / 16; ++ks) {
#pragma unroll
        for (int np = 0; np < kT / 16; ++np) {
          if (16 * ks < d.P && np >= k_lo) {
            uint32_t bf[4];
            ldsm_x4(bf, sDq + (16 * np + r8 + (mi >> 1) * 8) * kHP +
                            16 * ks + (mi & 1) * 8);
            mma_bf16(m[2 * np], xf[ks], bf[0], bf[1]);
            mma_bf16(m[2 * np + 1], xf[ks], bf[2], bf[3]);
          }
        }
      }
      // S^T and M^T: decayed, masked where the tile crosses the diagonal
      // or S
      const bool full = i0 > j0 && i0 + kT <= L;
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt) {
        const int i = 8 * nt + 2 * t;
        const float2 ci = *reinterpret_cast<const float2*>(cumI + i);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jl = j0 + m0 + gq + 8 * (q >> 1), il = i0 + i + (q & 1);
          const bool live = full || (jl <= il && il < L);
          const float e = ex2((q & 1 ? ci.y : ci.x) - cj[q >> 1]);
          const float sv = live ? s[nt][q] * e : 0.f;
          rs[q >> 1] += sv * m[nt][q];
          s[nt][q] = sv;
          m[nt][q] = live ? m[nt][q] * dj[q >> 1] * e : 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        if (kk >= k_lo) {
          uint32_t ah[4], al[4];
          // dB_j += M_ij C_i: A = M^T [j][i], B(k = i, n) = C_i [i][n]
          split_frag(m, kk, ah, al);
#pragma unroll
          for (int np = 0; np < kMaxN / 16; ++np) {
            if (16 * np < d.N) {
              uint32_t bf[4];
              ldsm_x4_t(bf, sCq + (16 * kk + r8 + (mi & 1) * 8) * kHN +
                                16 * np + (mi >> 1) * 8);
              mma_bf16(db[2 * np], ah, bf[0], bf[1]);
              mma_bf16(db[2 * np], al, bf[0], bf[1]);
              mma_bf16(db[2 * np + 1], ah, bf[2], bf[3]);
              mma_bf16(db[2 * np + 1], al, bf[2], bf[3]);
            }
          }
          // dx_j += S_ij dy_i (times dt_j below): B(k = i, p) = dy_i [i][p]
          split_frag(s, kk, ah, al);
#pragma unroll
          for (int np = 0; np < kMaxP / 16; ++np) {
            if (16 * np < d.P) {
              uint32_t bf[4];
              ldsm_x4_t(bf, sDq + (16 * kk + r8 + (mi & 1) * 8) * kHP +
                                16 * np + (mi >> 1) * 8);
              mma_bf16(dxa[2 * np], ah, bf[0], bf[1]);
              mma_bf16(dxa[2 * np], al, bf[0], bf[1]);
              mma_bf16(dxa[2 * np + 1], ah, bf[2], bf[3]);
              mma_bf16(dxa[2 * np + 1], al, bf[2], bf[3]);
            }
          }
        }
      }
      if (!more) break;
      __syncthreads();  // every warp is done with this stage
      stage ^= 1;
    }

    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
    const float d_h = Dv[h];
    float xdy = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + gq + 8 * half;
      if (j0 + r >= L) continue;
      const float dtj = half ? dt1 : dt0, v = half ? v1 : v0;
      const size_t pos = pos0 + j0 + r;
      const bf16* dyr = dy + pos * xr + h * d.P;
      bf16* dxr = dx + pos * xr + h * d.P;
#pragma unroll
      for (int nt = 0; nt < kMaxP / 8; ++nt) {
        const int p = 8 * nt + 2 * t;
        if (p < d.P) {
          const float2 y = bf2(dyr + p), xv = bf2(sX + r * kHP + p);
          xdy += xv.x * y.x + xv.y * y.y;
          store2<bf16>(dxr + p, dtj * dxa[nt][2 * half] + d_h * y.x,
                       dtj * dxa[nt][2 * half + 1] + d_h * y.y);
        }
      }
      if (t == 0) {
        const size_t k = bhc * d.Q + j0 + r;
        key_r[k] = rs[half] + v;
        key_u[k] = dtj * v;
      }
    }
    xdy = block_sum(xdy, red);
    if (tid == 0) key_xdy[bhc * n_kt + kt] = xdy;
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + gq + 8 * half;
    if (j0 + r >= L) continue;
    float* out = dBh + ((pos0 + j0 + r) * d.slices() + slice) * d.N;
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      const int n = 8 * nt + 2 * t;
      if (n < d.N)
        *reinterpret_cast<float2*>(out + n) =
            make_float2(db[nt][2 * half], db[nt][2 * half + 1]);
    }
  }
}

// ---- fp32, pass 3: dC and each row's part of dcum ------------------------
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_dc(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ dy,
                      const float* __restrict__ entry,
                      const float* __restrict__ cum,
                      float* __restrict__ dCh, float* __restrict__ row_dcum,
                      Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* sC = smem;                  // query rows [i][n]
  float* sDy = sC + kTileN;          // [i][p]
  float* sE = sDy + kTileP;          // the entering state [p][n], first;
  float* sB = sE;                    // then key rows [j][n],
  float* sX = sB + kTileN;           // [j][p]
  float* sM = sX + kTileP;           // and M [i][j]
  float* sCumQ = sM + kTileK;
  float* sCumK = sCumQ + kT;
  float* sDtK = sCumK + kT;

  const int h = blockIdx.x, c = blockIdx.y;
  const int n_qt = (d.Q + kT - 1) / kT, B = gridDim.z / n_qt;
  const int b = blockIdx.z % B, qt = n_qt - 1 - blockIdx.z / B;
  const int g = h / (d.H / d.G);
  const int c0 = c * d.Q, L = min(d.Q, d.S - c0), i0 = qt * kT;
  if (i0 >= L) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3, m0 = 16 * warp;
  const size_t xr = d.x_row(), bcr = d.bc_row();
  const size_t xo = (static_cast<size_t>(b) * d.S + c0) * xr + h * d.P;
  const size_t bco = (static_cast<size_t>(b) * d.S + c0) * bcr + g * d.N;
  const float* dtb = dt + (static_cast<size_t>(b) * d.S + c0) * d.H + h;
  const size_t bhc = (static_cast<size_t>(b) * d.H + h) * d.nc + c;
  const float* cumc = cum + bhc * d.Q;
  const int PN = d.P * d.N;

  load_rows(sC, kLdN, Cm + bco + i0 * bcr, bcr, d.N, L - i0);
  load_rows(sDy, kLdP, dy + xo + i0 * xr, xr, d.P, L - i0);
  const float* eslot = entry + bhc * PN;
  for (int i = threadIdx.x * 4; i < PN; i += kThreads * 4)
    *reinterpret_cast<float4*>(sE + (i / d.N) * kLdN + i % d.N) =
        load4(eslot + i);
  load_col(sCumQ, cumc + i0, 1, min(kT, d.Q - i0));
  __syncthreads();

  // exp(cum_i) E^T dy_i: A = dy [i][p], B(k = p, n) = E stored [p][n]
  float acc[kMaxN / 8][4] = {};
  gemm<false, true>(acc, sDy, kLdP, sE, kLdN, m0, d.P, d.N);
  const float e0 = expf(sCumQ[m0 + gq]), e1 = expf(sCumQ[m0 + gq + 8]);
  float part0 = 0.f, part1 = 0.f;   // C_i . (exp(cum_i) E^T dy_i), then + W
#pragma unroll
  for (int nt = 0; nt < kMaxN / 8; ++nt) {
    const int n = 8 * nt + 2 * t;
    acc[nt][0] *= e0;
    acc[nt][1] *= e0;
    acc[nt][2] *= e1;
    acc[nt][3] *= e1;
    if (n < d.N) {
      part0 += acc[nt][0] * sC[(m0 + gq) * kLdN + n] +
               acc[nt][1] * sC[(m0 + gq) * kLdN + n + 1];
      part1 += acc[nt][2] * sC[(m0 + gq + 8) * kLdN + n] +
               acc[nt][3] * sC[(m0 + gq + 8) * kLdN + n + 1];
    }
  }
  __syncthreads();  // every warp is done with E

  for (int j0 = 0; j0 <= i0; j0 += kT) {
    load_rows(sB, kLdN, Bm + bco + j0 * bcr, bcr, d.N, L - j0);
    load_rows(sX, kLdP, x + xo + j0 * xr, xr, d.P, L - j0);
    load_col(sCumK, cumc + j0, 1, min(kT, d.Q - j0));
    load_col(sDtK, dtb + static_cast<size_t>(j0) * d.H, d.H, L - j0);
    __syncthreads();
    // on the diagonal tile this warp's rows see only the keys below m0 + 16
    const int n_keys = j0 == i0 ? m0 + 16 : kT;
    float cb[kT / 8][4] = {}, yx[kT / 8][4] = {};
    gemm<false, false>(cb, sC, kLdN, sB, kLdN, m0, d.N, n_keys);   // C_i . B_j
    gemm<false, false>(yx, sDy, kLdP, sX, kLdP, m0, d.P, n_keys);  // dy_i . x_j
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ri = m0 + gq + 8 * (q >> 1), cj = 8 * nt + 2 * t + (q & 1);
        const int il = i0 + ri, jl = j0 + cj;
        float m = 0.f;
        if (jl <= il && il < L) {
          m = yx[nt][q] * sDtK[cj] * expf(sCumQ[ri] - sCumK[cj]);
          if (q >> 1) part1 += cb[nt][q] * m; else part0 += cb[nt][q] * m;
        }
        sM[ri * kLdK + cj] = m;
      }
    }
    __syncwarp();
    // dC_i += M_ij B_j: A = M [i][j], B(k = j, n) = B_j stored [j][n]
    gemm<false, true>(acc, sM, kLdK, sB, kLdN, m0, n_keys, d.N);
    __syncthreads();  // every warp is done with this key tile
  }

  part0 = quad_sum(part0);
  part1 = quad_sum(part1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + gq + 8 * half;
    if (i0 + r >= L) continue;
    float* out = dCh + ((static_cast<size_t>(b) * d.S + c0 + i0 + r) * d.H +
                        h) * d.N;
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      const int n = 8 * nt + 2 * t;
      if (n < d.N)
        *reinterpret_cast<float2*>(out + n) =
            make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
    if (t == 0) row_dcum[bhc * d.Q + i0 + r] = half ? part1 : part0;
  }
}

// ---- fp32, pass 4: dx, dB and each key's sums ----------------------------
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_dbx(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ Dv,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm,
                       const float* __restrict__ dy,
                       const float* __restrict__ gst,
                       const float* __restrict__ cum, float* __restrict__ dx,
                       float* __restrict__ dBh, float* __restrict__ key_r,
                       float* __restrict__ key_u, float* __restrict__ key_xdy,
                       Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;                  // key rows [j][n]
  float* sX = sB + kTileN;           // [j][p]
  float* sG = sX + kTileP;           // G [p][n], first;
  float* sC = sG;                    // then query rows [i][n],
  float* sDy = sC + kTileN;          // [i][p],
  float* sS = sDy + kTileP;          // S^T [j][i]
  float* sM = sS + kTileK;           // M^T [j][i]
  float* sCumJ = sM + kTileK;
  float* sDtJ = sCumJ + kT;
  float* sCumI = sDtJ + kT;
  float* red = sCumI + kT;

  const int h = blockIdx.x, c = blockIdx.y;
  const int n_kt = (d.Q + kT - 1) / kT, B = gridDim.z / n_kt;
  const int b = blockIdx.z % B, kt = blockIdx.z / B;
  const int g = h / (d.H / d.G);
  const int c0 = c * d.Q, L = min(d.Q, d.S - c0), j0 = kt * kT;
  if (j0 >= L) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3, m0 = 16 * warp;
  const size_t xr = d.x_row(), bcr = d.bc_row();
  const size_t xo = (static_cast<size_t>(b) * d.S + c0) * xr + h * d.P;
  const size_t bco = (static_cast<size_t>(b) * d.S + c0) * bcr + g * d.N;
  const float* dtb = dt + (static_cast<size_t>(b) * d.S + c0) * d.H + h;
  const size_t bhc = (static_cast<size_t>(b) * d.H + h) * d.nc + c;
  const float* cumc = cum + bhc * d.Q;
  const int PN = d.P * d.N;

  load_rows(sB, kLdN, Bm + bco + j0 * bcr, bcr, d.N, L - j0);
  load_rows(sX, kLdP, x + xo + j0 * xr, xr, d.P, L - j0);
  load_rows(sG, kLdN, gst + bhc * PN, d.N, d.N, d.P, d.P);
  load_col(sCumJ, cumc + j0, 1, min(kT, d.Q - j0));
  load_col(sDtJ, dtb + static_cast<size_t>(j0) * d.H, d.H, L - j0);
  const float cum_l = cumc[L - 1];
  __syncthreads();

  // G B_j (j, p): A = B_j [j][n], B(k = n, p) = G stored [p][n]
  float dxa[kMaxP / 8][4] = {};
  gemm<false, false>(dxa, sB, kLdN, sG, kLdN, m0, d.N, d.P);
  // G^T x_j (j, n): A = x_j [j][p], B(k = p, n) = G stored [p][n]
  float db[kMaxN / 8][4] = {};
  gemm<false, true>(db, sX, kLdP, sG, kLdN, m0, d.P, d.N);
  const int ra = m0 + gq, rb = m0 + gq + 8;
  const float te0 = expf(cum_l - sCumJ[ra]), te1 = expf(cum_l - sCumJ[rb]);
  const float dt0 = sDtJ[ra], dt1 = sDtJ[rb];
  float v0 = 0.f, v1 = 0.f;          // x_j . G B_j
#pragma unroll
  for (int nt = 0; nt < kMaxP / 8; ++nt) {
    const int p = 8 * nt + 2 * t;
    if (p < d.P) {
      v0 += dxa[nt][0] * sX[ra * kLdP + p] + dxa[nt][1] * sX[ra * kLdP + p + 1];
      v1 += dxa[nt][2] * sX[rb * kLdP + p] + dxa[nt][3] * sX[rb * kLdP + p + 1];
    }
    dxa[nt][0] *= te0;
    dxa[nt][1] *= te0;
    dxa[nt][2] *= te1;
    dxa[nt][3] *= te1;
  }
  v0 = te0 * quad_sum(v0);
  v1 = te1 * quad_sum(v1);
#pragma unroll
  for (int nt = 0; nt < kMaxN / 8; ++nt) {
    db[nt][0] *= te0 * dt0;
    db[nt][1] *= te0 * dt0;
    db[nt][2] *= te1 * dt1;
    db[nt][3] *= te1 * dt1;
  }
  __syncthreads();  // every warp is done with G

  float rs0 = 0.f, rs1 = 0.f;        // sum_i R_ij
  for (int i0 = j0; i0 < L; i0 += kT) {
    load_rows(sC, kLdN, Cm + bco + i0 * bcr, bcr, d.N, L - i0);
    load_rows(sDy, kLdP, dy + xo + i0 * xr, xr, d.P, L - i0);
    load_col(sCumI, cumc + i0, 1, min(kT, d.Q - i0));
    __syncthreads();
    float cb[kT / 8][4] = {}, yx[kT / 8][4] = {};
    gemm<false, false>(cb, sB, kLdN, sC, kLdN, m0, d.N, kT);    // B_j . C_i
    gemm<false, false>(yx, sX, kLdP, sDy, kLdP, m0, d.P, kT);   // x_j . dy_i
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rj = m0 + gq + 8 * (q >> 1), ci = 8 * nt + 2 * t + (q & 1);
        const int jl = j0 + rj, il = i0 + ci;
        float s = 0.f, m = 0.f;
        if (jl <= il && il < L) {
          const float e = expf(sCumI[ci] - sCumJ[rj]);
          s = cb[nt][q] * e;
          m = yx[nt][q] * sDtJ[rj] * e;
          if (q >> 1) rs1 += s * yx[nt][q]; else rs0 += s * yx[nt][q];
        }
        sS[rj * kLdK + ci] = s;
        sM[rj * kLdK + ci] = m;
      }
    }
    __syncwarp();
    // dB_j += M_ij C_i: A = M^T [j][i], B(k = i, n) = C_i stored [i][n]
    gemm<false, true>(db, sM, kLdK, sC, kLdN, m0, kT, d.N);
    // dx_j += S_ij dy_i (times dt_j below): B(k = i, p) = dy_i [i][p]
    gemm<false, true>(dxa, sS, kLdK, sDy, kLdP, m0, kT, d.P);
    __syncthreads();  // every warp is done with this query tile
  }

  rs0 = quad_sum(rs0);
  rs1 = quad_sum(rs1);
  const float d_h = Dv[h];
  float xdy = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + gq + 8 * half;
    if (j0 + r >= L) continue;
    const float dtj = half ? dt1 : dt0;
    const size_t pos = static_cast<size_t>(b) * d.S + c0 + j0 + r;
    const float* dyr = dy + pos * xr + h * d.P;
    float* dxr = dx + pos * xr + h * d.P;
#pragma unroll
    for (int nt = 0; nt < kMaxP / 8; ++nt) {
      const int p = 8 * nt + 2 * t;
      if (p < d.P) {
        const float y0 = dyr[p], y1 = dyr[p + 1];
        xdy += sX[r * kLdP + p] * y0 + sX[r * kLdP + p + 1] * y1;
        dxr[p] = (dtj * dxa[nt][2 * half] + d_h * y0);
        dxr[p + 1] = (dtj * dxa[nt][2 * half + 1] + d_h * y1);
      }
    }
    float* out = dBh + (pos * d.H + h) * d.N;
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      const int n = 8 * nt + 2 * t;
      if (n < d.N)
        *reinterpret_cast<float2*>(out + n) =
            make_float2(db[nt][2 * half], db[nt][2 * half + 1]);
    }
    if (t == 0) {
      const size_t k = bhc * d.Q + j0 + r;
      key_r[k] = (half ? rs1 : rs0) + (half ? v1 : v0);
      key_u[k] = dtj * (half ? v1 : v0);
    }
  }
  xdy = block_sum(xdy, red);
  if (threadIdx.x == 0) key_xdy[bhc * ((d.Q + kT - 1) / kT) + kt] = xdy;
}

// ---- pass 5: the decay's gradient, ddt, and each chunk's dA and dD --------
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_decay(const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const float* __restrict__ row_dcum,
                         const float* __restrict__ key_r,
                         const float* __restrict__ key_u,
                         const float* __restrict__ key_xdy,
                         const float* __restrict__ carry_part, int n_cc,
                         float* __restrict__ ddt, float* __restrict__ chunk_dA,
                         float* __restrict__ chunk_dD, Dims d) {
  extern __shared__ __align__(16) float sDc[];   // Q values
  __shared__ float red[kThreads / 32];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * d.Q, L = min(d.Q, d.S - c0);
  const size_t bhc = (static_cast<size_t>(b) * d.H + h) * d.nc + c;
  const float* dtb = dt + (static_cast<size_t>(b) * d.S + c0) * d.H + h;
  float u = 0.f;
  for (int k = threadIdx.x; k < L; k += kThreads) {
    const size_t i = bhc * d.Q + k;
    sDc[k] = row_dcum[i] - dtb[static_cast<size_t>(k) * d.H] * key_r[i];
    u += key_u[i];
  }
  // the chunk's end: sum_j dt_j v_j + exp(cum_L) <E, G>, the latter in
  // the carry's CTAs' parts
  const float tail = block_sum(u, red);
  if (threadIdx.x == 0) {
    float carry = 0.f;
    for (int k = 0; k < n_cc; ++k) carry += carry_part[bhc * n_cc + k];
    sDc[L - 1] += tail + carry;
    // the key tiles pass 4 ran: a ragged last chunk may have fewer
    float xdy = 0.f;
    for (int k = 0; k < (L + kT - 1) / kT; ++k)
      xdy += key_xdy[bhc * ((d.Q + kT - 1) / kT) + k];
    chunk_dD[bhc] = xdy;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // reverse inclusive cumsum, in double: each lane a contiguous run from
    // the end, then a warp scan of the runs
    const int lane = threadIdx.x, per = (L + 31) / 32;
    const int k1 = max(L - lane * per, 0), k0 = max(k1 - per, 0);
    double run = 0.0;
    for (int k = k0; k < k1; ++k) run += sDc[k];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, run, o);
      if (lane >= o) run += v;
    }
    double acc = __shfl_up_sync(0xffffffffu, run, 1);
    if (lane == 0) acc = 0.0;
    for (int k = k1 - 1; k >= k0; --k) {
      acc += sDc[k];
      sDc[k] = static_cast<float>(acc);
    }
  }
  __syncthreads();
  const float a_h = A[h];
  float da_dt = 0.f;
  for (int k = threadIdx.x; k < L; k += kThreads) {
    const float dtk = dtb[static_cast<size_t>(k) * d.H];
    ddt[(static_cast<size_t>(b) * d.S + c0 + k) * d.H + h] =
        key_r[bhc * d.Q + k] + a_h * sDc[k];
    da_dt += dtk * sDc[k];
  }
  da_dt = block_sum(da_dt, red);
  if (threadIdx.x == 0) chunk_dA[bhc] = da_dt;
}

// ---- pass 6: group sums of dB and dC; dA and dD ---------------------------
// dBh and dCh hold a partial sum for each slice of heads (d.slices() a
// position, each of one group's heads).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_reduce(const float* __restrict__ dBh,
                          const float* __restrict__ dCh, T* __restrict__ dBm,
                          T* __restrict__ dCm,
                          const float* __restrict__ chunk_dA,
                          const float* __restrict__ chunk_dD,
                          float* __restrict__ dA, float* __restrict__ dD,
                          int B, Dims d) {
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < d.H; h += kThreads) {
      float sa = 0.f, sd = 0.f;
      for (int b = 0; b < B; ++b)
        for (int c = 0; c < d.nc; ++c) {
          const size_t bhc = (static_cast<size_t>(b) * d.H + h) * d.nc + c;
          sa += chunk_dA[bhc];
          sd += chunk_dD[bhc];
        }
      dA[h] = sa;
      dD[h] = sd;
    }
    return;
  }
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t total = static_cast<size_t>(B) * d.S * d.G * d.N;
  if (i >= total) return;
  const int n = i % d.N, g = (i / d.N) % d.G;
  const size_t pos = i / (static_cast<size_t>(d.G) * d.N);
  const int per = d.slices() / d.G;
  const size_t o =
      (pos * d.slices() + static_cast<size_t>(g) * per) * d.N + n;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < per; ++k) {
    sb += dBh[o + static_cast<size_t>(k) * d.N];
    sc += dCh[o + static_cast<size_t>(k) * d.N];
  }
  dBm[i] = repro::from_f32<T>(sb);
  dCm[i] = repro::from_f32<T>(sc);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

constexpr size_t kStatesBytes = (kTileP + kTileN + kT) * sizeof(float);
constexpr size_t kDcBytes =
    (kTileN + kTileP + kTileN + kTileP + kTileK + 3 * kT) * sizeof(float);
constexpr size_t kDbxBytes =
    (kTileN + kTileP + kTileN + kTileP + 2 * kTileK + 3 * kT + kThreads / 32) *
    sizeof(float);
constexpr size_t kStatesTcBytes =
    2 * kHStage * sizeof(bf16) + 2 * kT * sizeof(float);
// the slice's C or B tile, a head's dy or x tile, two stages; then cum and
// dt rows (and pass 4's `red`)
constexpr size_t kTcBytes = (kHTileN + kHTileP + 2 * kHStage) * sizeof(bf16) +
                            (5 * kT + kThreads / 32) * sizeof(float);

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D,
                   const void* dy, const float* dfin, const float* entry,
                   const float* cum, void* dx, float* ddt, float* dA,
                   void* dBm, void* dCm, float* dD, float* dinit, float* gst,
                   float* dBCh, float* rows, float* chunk_sums, int B,
                   const Dims& d, cudaStream_t stream) {
  constexpr bool kTwo = sizeof(T) == 2;
  static bool configured = false;
  if (!configured) {
    cudaError_t e;
    if constexpr (kTwo) {
      e = allow_smem(ssd_bwd_kernel_states_tc, kStatesTcBytes);
      if (e == cudaSuccess) e = allow_smem(ssd_bwd_kernel_dc_tc, kTcBytes);
      if (e == cudaSuccess) e = allow_smem(ssd_bwd_kernel_dbx_tc, kTcBytes);
    } else {
      e = allow_smem(ssd_bwd_kernel_states, kStatesBytes);
      if (e == cudaSuccess) e = allow_smem(ssd_bwd_kernel_dc, kDcBytes);
      if (e == cudaSuccess) e = allow_smem(ssd_bwd_kernel_dbx, kDbxBytes);
    }
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  const T* dyt = static_cast<const T*>(dy);
  const int PN = d.P * d.N, n_cc = (PN + kCarry - 1) / kCarry;
  const int n_t = (d.Q + kT - 1) / kT;
  const size_t plane = static_cast<size_t>(B) * d.H * d.nc * d.Q;
  const size_t chunks = static_cast<size_t>(B) * d.H * d.nc;
  float* own = gst;
  float* G = gst + chunks * PN;
  float* dBh = dBCh;
  float* dCh = dBCh + static_cast<size_t>(B) * d.S * d.slices() * d.N;
  float *row_dcum = rows, *key_r = rows + plane, *key_u = rows + 2 * plane;
  float* key_xdy = rows + 3 * plane;   // B * H * nc * n_t values
  float *chunk_dA = chunk_sums, *chunk_dD = chunk_sums + chunks;
  float* carry_part = chunk_sums + 2 * chunks;   // B * H * nc * n_cc values

  if constexpr (kTwo)
    ssd_bwd_kernel_states_tc<<<dim3(d.nc, d.H, B), kThreads, kStatesTcBytes,
                               stream>>>(dyt, Ct, cum, own, d);
  else
    ssd_bwd_kernel_states<<<dim3(d.nc, d.H, B), kThreads, kStatesBytes,
                            stream>>>(dyt, Ct, cum, own, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_kernel_carry<<<dim3(n_cc, d.H, B), kThreads, 0, stream>>>(
      own, G, entry, cum, dfin, dinit, carry_part, kTwo, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 tiles(d.slices(), d.nc, n_t * B);
  if constexpr (kTwo)
    ssd_bwd_kernel_dc_tc<<<tiles, kThreads, kTcBytes, stream>>>(
        xt, dt, Bt, Ct, dyt, entry, cum, dCh, row_dcum, d);
  else
    ssd_bwd_kernel_dc<<<tiles, kThreads, kDcBytes, stream>>>(
        xt, dt, Bt, Ct, dyt, entry, cum, dCh, row_dcum, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if constexpr (kTwo)
    ssd_bwd_kernel_dbx_tc<<<tiles, kThreads, kTcBytes, stream>>>(
        xt, dt, D, Bt, Ct, dyt, G, cum, static_cast<T*>(dx), dBh, key_r,
        key_u, key_xdy, d);
  else
    ssd_bwd_kernel_dbx<<<tiles, kThreads, kDbxBytes, stream>>>(
        xt, dt, D, Bt, Ct, dyt, G, cum, static_cast<T*>(dx), dBh, key_r,
        key_u, key_xdy, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_kernel_decay<<<dim3(d.nc, d.H, B), kThreads, d.Q * sizeof(float),
                         stream>>>(dt, A, row_dcum, key_r, key_u, key_xdy,
                                   carry_part, n_cc, ddt, chunk_dA, chunk_dD,
                                   d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t total = static_cast<size_t>(B) * d.S * d.G * d.N;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads) + 1;
  ssd_bwd_kernel_reduce<T><<<blocks, kThreads, 0, stream>>>(
      dBh, dCh, static_cast<T*>(dBm), static_cast<T*>(dCm), chunk_dA,
      chunk_dD, dA, dD, B, d);
  return cudaGetLastError();
}

}  // namespace

// dfin may be null (a zero gradient). entry and cum are the forward's
// scratch (ssd_scan_launch's `entry` and `cum`, written with the same bf16
// flag). hs: the heads a CTA of passes 3 and 4 takes, dividing H / G (1
// for fp32). Scratch, each written before it is read: gst 2*B*H*nc*P*N
// floats, dBCh 2*B*S*(H/hs)*N, rows 4*B*H*nc*Q, chunk_sums
// B*H*nc*(2 + ceil(P*N/512)) (nc = ceil(S/Q)). All tensors contiguous on
// the device; x, Bm, Cm, dy, dfin, dinit and the scratch 16-byte aligned.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* dy, const void* dfin,
    const void* entry, const void* cum, void* dx, void* ddt, void* dA,
    void* dBm, void* dCm, void* dD, void* dinit, void* gst, void* dBCh,
    void* rows, void* chunk_sums, int B, int S, int H, int P, int G, int N,
    int Q, int hs, int bf16, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || Q <= 0 || Q > 4096 || G <= 0 ||
      H % G != 0 || P <= 0 || P > kMaxP || N <= 0 || N > kMaxN ||
      P % 16 != 0 || N % 16 != 0 || hs <= 0 || (H / G) % hs != 0 ||
      (!bf16 && hs != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{S, H, P, G, N, Q, (S + Q - 1) / Q, hs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(x, f(dt), f(A), Bm, Cm, f(D), dy, f(dfin),
                                   f(entry), f(cum), dx, w(ddt), w(dA), dBm,
                                   dCm, w(dD), w(dinit), w(gst), w(dBCh),
                                   w(rows), w(chunk_sums), B, d, s)
           : launch<float>(x, f(dt), f(A), Bm, Cm, f(D), dy, f(dfin),
                           f(entry), f(cum), dx, w(ddt), w(dA), dBm, dCm,
                           w(dD), w(dinit), w(gst), w(dBCh), w(rows),
                           w(chunk_sums), B, d, s);
  return static_cast<int>(e);
}
