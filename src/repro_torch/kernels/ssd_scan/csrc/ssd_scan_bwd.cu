// Kernel B4's backward: the gradients of the Mamba-2 SSD chunked scan, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel, and its
// gradient through the scan is XLA's autodiff of the jnp `ssd_chunked_ref`
// (src/repro/kernels/ssd_scan/ref.py). It runs as the backward of the
// forward kernel (ssd_scan.cu) under autograd, and takes the forward's
// scratch: the chunk cumsums of dt * A, and the state entering each chunk
// (for bf16 inputs stored as bf16 hi and lo tiles, read here as hi + lo,
// within 2^-16 of the fp32 state).
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
//   1. `ssd_bwd_kernel_states`, one CTA per (chunk, head, batch): each
//      chunk's sum_i exp(cum_i) dy_i^T C_i, a (P, N) product like the
//      forward's own state, into the fp32 scratch `gst`.
//   2. `ssd_bwd_kernel_carry`, one CTA per (batch, head): the reverse carry
//      over the chunks, last to first, with the whole (P, N) state in the
//      CTA's registers; it overwrites each chunk's slot of `gst` with G, the
//      gradient of the state leaving it, writes dinit, and each chunk's
//      exp(cum_L) <E, G> (a block reduction) for the decay gradient.
//   3. `ssd_bwd_kernel_dc`, one CTA per (64-row query tile, chunk, head,
//      batch), heaviest tiles first: dC_i of each head (into the fp32
//      scratch `dBCh`) and each row's part of dcum.
//   4. `ssd_bwd_kernel_dbx`, one CTA per (64-row key tile, chunk, head,
//      batch): dx_j, dB_j of each head, sum_i R_ij + v_j, dt_j v_j and
//      x_j . dy_j. Passes 3 and 4 each compute the score tiles C B^T and
//      dy x^T of their pairs of tiles, as flash attention's backward splits
//      dq from dk and dv.
//   5. `ssd_bwd_kernel_decay`, one CTA per (chunk, head, batch): dcum, its
//      reverse cumsum (one warp, in double), ddt, and the chunk's parts of
//      dA and dD.
//   6. `ssd_bwd_kernel_reduce`: dB and dC summed over each group's heads
//      and cast to the input type; its last CTA sums dA and dD.
//
// What bounds it on the H100: at the training shape (B = 2, S = 4096,
// H = 64, P = 64, N = 128, Q = 256) passes 3 and 4 hold ~all of the
// ~150 GFLOP of products, all fp32 FMAs from padded shared tiles (bf16
// operands converted as they load), a few times the bound of the bytes it
// must move (~0.2 GB). Tensor cores (the forward's split-bf16 mma.sync, or
// wgmma) and sharing the score tiles between passes 3 and 4 are the next
// levers.
#include "common.cuh"
#include "fma_gemm.cuh"
#include "launch.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::gemm;
using repro::to_f32;
using repro::warp_sum;

constexpr int kThreads = 128;   // four warps, 16 rows each
constexpr int kT = 64;          // rows of a tile
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kLdP = kMaxP + 4; // padded fp32 rows: the FMA reads of eight
constexpr int kLdN = kMaxN + 4; // rows hit eight banks
constexpr int kLdK = kT + 4;
constexpr int kTileP = kT * kLdP, kTileN = kT * kLdN, kTileK = kT * kLdK;
constexpr int kCarryVec = kMaxP * kMaxN / (4 * kThreads);  // float4s a thread

// four consecutive values as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// four entries of a chunk's entering state from the forward's scratch:
// fp32, or (split) a bf16 hi tile then a bf16 lo tile in the slot's bytes
__device__ __forceinline__ float4 entry4(const float* slot, int i, int PN,
                                         bool split) {
  if (!split) return load4(slot + i);
  const bf16* half = reinterpret_cast<const bf16*>(slot);
  const float4 hi = load4(half + i), lo = load4(half + PN + i);
  return make_float4(hi.x + lo.x, hi.y + lo.y, hi.z + lo.z, hi.w + lo.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// `rows` rows of `cols` values, `stride` elements apart, into fp32 rows of
// `ld`; rows at or past `live` are zeros
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          size_t stride, int cols, int live,
                                          int rows = kT) {
  const int per_row = cols / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 4;
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        r < live ? load4(src + r * stride + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
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

struct Dims {
  int S, H, P, G, N, Q, nc;
  __host__ __device__ size_t x_row() const {
    return static_cast<size_t>(H) * P;
  }
  __host__ __device__ size_t bc_row() const {
    return static_cast<size_t>(G) * N;
  }
};

// ---- pass 1: sum_i exp(cum_i) dy_i^T C_i per chunk ------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_states(const T* __restrict__ dy, const T* __restrict__ Cm,
                          const float* __restrict__ cum,
                          float* __restrict__ gst, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* sDy = smem;                 // [i][p]
  float* sC = sDy + kTileP;          // [i][n]
  float* sF = sC + kTileN;           // exp(cum_i)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (d.H / d.G), warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int c0 = c * d.Q, L = min(d.Q, d.S - c0), p0 = 16 * warp;
  const T* dyb = dy + (static_cast<size_t>(b) * d.S + c0) * d.x_row() + h * d.P;
  const T* Cb = Cm + (static_cast<size_t>(b) * d.S + c0) * d.bc_row() + g * d.N;
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
    float* out = gst + bhc * d.P * d.N;
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
// Each thread holds kCarryVec float4s of the state's gradient G; chunk
// c's slot of `gst` holds its sum_i exp(cum_i) dy_i^T C_i on entry and G
// leaving chunk c on exit.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_carry(float* __restrict__ gst,
                         const float* __restrict__ entry,
                         const float* __restrict__ cum,
                         const float* __restrict__ dfin,
                         float* __restrict__ dinit,
                         float* __restrict__ chunk_carry, bool split,
                         Dims d) {
  __shared__ float red[kThreads / 32];
  const int PN = d.P * d.N;
  const size_t bh = static_cast<size_t>(blockIdx.y) * d.H + blockIdx.x;
  float4 G[kCarryVec];
#pragma unroll
  for (int k = 0; k < kCarryVec; ++k) {
    const int i = (k * kThreads + threadIdx.x) * 4;
    G[k] = i < PN && dfin != nullptr ? load4(dfin + bh * PN + i)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int c = d.nc - 1; c >= 0; --c) {
    float* slot = gst + (bh * d.nc + c) * PN;
    const float* eslot = entry + (bh * d.nc + c) * PN;
    const float decay = expf(cum[(bh * d.nc + c) * d.Q +
                                 min(d.Q, d.S - c * d.Q) - 1]);
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < kCarryVec; ++k) {
      const int i = (k * kThreads + threadIdx.x) * 4;
      if (i < PN) {
        const float4 own = load4(slot + i);
        dot += dot4(entry4(eslot, i, PN, split), G[k]);
        *reinterpret_cast<float4*>(slot + i) = G[k];
        G[k] = make_float4(G[k].x * decay + own.x, G[k].y * decay + own.y,
                           G[k].z * decay + own.z, G[k].w * decay + own.w);
      }
    }
    dot = block_sum(dot, red);
    if (threadIdx.x == 0) chunk_carry[bh * d.nc + c] = decay * dot;
  }
#pragma unroll
  for (int k = 0; k < kCarryVec; ++k) {
    const int i = (k * kThreads + threadIdx.x) * 4;
    if (i < PN) *reinterpret_cast<float4*>(dinit + bh * PN + i) = G[k];
  }
}

// ---- pass 3: dC and each row's part of dcum ------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_dc(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const T* __restrict__ dy,
                      const float* __restrict__ entry,
                      const float* __restrict__ cum, bool split,
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
        entry4(eslot, i, PN, split);
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

// ---- pass 4: dx, dB and each key's sums ----------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_dbx(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ Dv,
                       const T* __restrict__ Bm, const T* __restrict__ Cm,
                       const T* __restrict__ dy,
                       const float* __restrict__ gst,
                       const float* __restrict__ cum, T* __restrict__ dx,
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

  load_rows(sB, kLdN, Bm + bco + j0 * bcr, bcr, d.N, L - j0);
  load_rows(sX, kLdP, x + xo + j0 * xr, xr, d.P, L - j0);
  load_rows(sG, kLdN, gst + bhc * d.P * d.N, d.N, d.N, d.P, d.P);
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
    const T* dyr = dy + pos * xr + h * d.P;
    T* dxr = dx + pos * xr + h * d.P;
#pragma unroll
    for (int nt = 0; nt < kMaxP / 8; ++nt) {
      const int p = 8 * nt + 2 * t;
      if (p < d.P) {
        const float y0 = to_f32(dyr[p]), y1 = to_f32(dyr[p + 1]);
        xdy += sX[r * kLdP + p] * y0 + sX[r * kLdP + p + 1] * y1;
        dxr[p] = repro::from_f32<T>(dtj * dxa[nt][2 * half] + d_h * y0);
        dxr[p + 1] = repro::from_f32<T>(dtj * dxa[nt][2 * half + 1] + d_h * y1);
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
                         const float* __restrict__ chunk_carry,
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
  // the chunk's end: sum_j dt_j v_j + exp(cum_L) <E, G>
  const float tail = block_sum(u, red) + chunk_carry[bhc];
  if (threadIdx.x == 0) {
    sDc[L - 1] += tail;
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
  const int per = d.H / d.G;
  const size_t o = (pos * d.H + static_cast<size_t>(g) * per) * d.N + n;
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

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D,
                   const void* dy, const float* dfin, const float* entry,
                   const float* cum, void* dx, float* ddt, float* dA,
                   void* dBm, void* dCm, float* dD, float* dinit, float* gst,
                   float* dBCh, float* rows, float* chunk_sums, int B,
                   const Dims& d, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = allow_smem(ssd_bwd_kernel_states<T>, kStatesBytes);
    if (e == cudaSuccess) e = allow_smem(ssd_bwd_kernel_dc<T>, kDcBytes);
    if (e == cudaSuccess) e = allow_smem(ssd_bwd_kernel_dbx<T>, kDbxBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  const T* dyt = static_cast<const T*>(dy);
  const bool split = sizeof(T) == 2;
  const int n_t = (d.Q + kT - 1) / kT;
  const size_t plane = static_cast<size_t>(B) * d.H * d.nc * d.Q;
  const size_t chunks = static_cast<size_t>(B) * d.H * d.nc;
  float* dBh = dBCh;
  float* dCh = dBCh + static_cast<size_t>(B) * d.S * d.H * d.N;
  float *row_dcum = rows, *key_r = rows + plane, *key_u = rows + 2 * plane;
  float* key_xdy = rows + 3 * plane;   // B * H * nc * n_t values
  float *chunk_carry = chunk_sums, *chunk_dA = chunk_sums + chunks,
        *chunk_dD = chunk_sums + 2 * chunks;

  ssd_bwd_kernel_states<T><<<dim3(d.nc, d.H, B), kThreads, kStatesBytes,
                             stream>>>(dyt, Ct, cum, gst, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_kernel_carry<<<dim3(d.H, B), kThreads, 0, stream>>>(
      gst, entry, cum, dfin, dinit, chunk_carry, split, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_kernel_dc<T><<<dim3(d.H, d.nc, n_t * B), kThreads, kDcBytes,
                         stream>>>(xt, dt, Bt, Ct, dyt, entry, cum, split,
                                   dCh, row_dcum, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_kernel_dbx<T><<<dim3(d.H, d.nc, n_t * B), kThreads, kDbxBytes,
                          stream>>>(xt, dt, D, Bt, Ct, dyt, gst, cum,
                                    static_cast<T*>(dx), dBh, key_r, key_u,
                                    key_xdy, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_kernel_decay<<<dim3(d.nc, d.H, B), kThreads, d.Q * sizeof(float),
                         stream>>>(dt, A, row_dcum, key_r, key_u, key_xdy,
                                   chunk_carry, ddt, chunk_dA, chunk_dD, d);
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
// flag). Scratch, each written before it is read: gst B*H*nc*P*N floats,
// dBCh 2*B*S*H*N, rows 4*B*H*nc*Q, chunk_sums 3*B*H*nc (nc = ceil(S/Q)).
// All tensors contiguous on the device; x, Bm, Cm, dy, dfin, dinit and the
// scratch 16-byte aligned.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* dy, const void* dfin,
    const void* entry, const void* cum, void* dx, void* ddt, void* dA,
    void* dBm, void* dCm, void* dD, void* dinit, void* gst, void* dBCh,
    void* rows, void* chunk_sums, int B, int S, int H, int P, int G, int N,
    int Q, int bf16, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || Q <= 0 || Q > 4096 || G <= 0 ||
      H % G != 0 || P <= 0 || P > kMaxP || N <= 0 || N > kMaxN ||
      P % 16 != 0 || N % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{S, H, P, G, N, Q, (S + Q - 1) / Q};
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
