// Kernel B2's backward: the gradients of GQA flash attention for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel, and its
// gradient through attention is XLA's autodiff of the jnp
// `flash_attention_ref` (src/repro/kernels/flash_attention/ref.py:106). It
// runs as the backward of the forward kernel (flash_attention.cu) under
// autograd and reads the logsumexp that the forward wrote:
//
//   q, dout, out: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), one type (fp32 or
//   bf16); lse: (B, Hq, Sq) fp32, natural-log units of the scaled scores,
//   +inf on a row that sees no key. dq in q's type; dk, dv in k's type;
//   Hq % Hkv == 0; D in {64, 128}, or 112 in bf16; Skv >= 1; q_offset >= 0;
//   masks as the forward's (causal, kv_len).
//
// With P = exp(scale q k^T - lse) (0 where masked) and delta = rowsum(dO *
// O): dV = P^T dO, dP = dO V^T, dS = scale P * (dP - delta), dK = dS^T Q,
// dQ = dS K, dK and dV summed over each GQA group. Three passes:
//   1. `flash_bwd_preprocess_kernel`: delta (B, Hq, Sq) fp32, one warp a
//      row, and zeroes the fp32 dQ accumulator.
//   2. `flash_bwd_bf16_kernel` / `flash_bwd_f32_kernel`: one CTA per K/V
//      tile of one KV head and batch, walking every query tile of every
//      query head of its group that can see the tile (under causal masking
//      the tiles wholly above the diagonal are skipped; `bwd_tiles` in
//      ops.py lists the same visits). dK and dV accumulate in registers
//      over the whole group and are written once, with no atomics, so they
//      are the same from run to run; each visit adds its dQ to the fp32
//      accumulator (bf16: TMA reductions of whole tiles,
//      cp.reduce.async.bulk.tensor .add; fp32: float4 atomics), whose order,
//      and so dQ's last bits, vary from run to run. The deterministic
//      alternative, a second kernel per query tile, would compute S and
//      dP again: two more products.
//   3. `flash_bwd_convert_kernel`: dQ in q's type from the accumulator (for
//      fp32 the accumulator is dq itself and this part is skipped), and for
//      each sequence that sees no key (kv_len[b] == 0) its rows' share of
//      the forward's uniform softmax: dK = 0 and dO / Skv, summed over the
//      rows and the group, added to every key's dV (pass 2 skips such a
//      sequence). Launched only for bf16 or with kv_len.
//
// bf16 (tensor cores): a CTA holds 128 keys, two consumer warpgroups of 64
// keys each, and a third warpgroup whose warp 0 loads and whose warp 1
// reduces dQ; setmaxnreg gives its registers to the consumers (240 each).
// The loading warp brings K and V once with TMA, then each visit's lse (in
// log2 units) and delta with its lanes and then, from lane 0, its Q and dO
// tiles (64 rows) with TMA into a ring of two stages. (Issued before the
// lanes' loads, those TMA loads made zamba2-7b's shape 30% slower.) Each
// consumer warpgroup computes, with wgmma and fp32 accumulators:
//   S^T = K Q^T and dP^T = V dO^T (both operands K-major, as TMA wrote them),
//   P^T and dS^T in registers (exp2 of the log2-scaled scores less lse;
//   the mask only on visits whose tile crosses Sq, kv_len or the diagonal),
//   dS written as bf16 into its key panel of one of two shared dS tiles
//   (the 128-byte swizzled layout of a K-major A operand),
//   then, in one group: dQ of the visit before (dS over the CTA's 128 keys,
//   both warpgroups' halves written a visit ago, times one 64-column panel
//   of K read MN-major; for D = 64 its own half of dS times its own 64
//   keys), dV += P^T dO and dK += dS^T Q (P^T and dS^T as bf16 A fragments
//   from registers, dO and Q read MN-major: no transpose anywhere).
// Deferring dQ by a visit removes the barrier that joined the warpgroups
// every visit (dQ needs both halves of dS): each waits on mbarriers for
// the other's half of the dS tile of the visit before, written long since.
// So the two can issue their products in turns (named barriers, as the
// forward's consumers do), two a visit each, warpgroup 0 first: one's exps,
// dS and stores run while the other's products hold the tensor cores
// (without the turns the pass took 8% longer at granite-3-8b's training
// shape on an H100).
// Its dQ panel goes to one of two shared fp32 tiles (128-byte swizzled in
// boxes of 32 columns, so a warp's writes take two wavefronts) that the dQ
// warp adds to the accumulator with TMA reductions. The warpgroup's role
// is no template argument and no branch lies between a product's issue
// and its wait, so both run one copy of the code and ptxas serializes no
// wgmma.
// fp32 (no fp32 tensor-core product without TF32 rounding): one CTA of 256
// threads per 64 keys, plain fp32 FMAs from padded shared tiles as the fp32
// forward does; each thread owns a 4 x 4 block of the score tiles and a
// 4 x D/16 slice of dK, dV and dQ.
//
// What bounds it on the H100: operations. At granite-3-8b's training shape
// (B = 2, S = 4096, 32/8 heads of 128, causal, bf16) the five products are
// 2.5 times the forward's, 687 GFLOP, 0.695 ms at 989 TFLOP/s, against 0.12
// ms for the bytes. A visit of a 64-row query tile does five products of
// 1.05 MFLOP a warpgroup, 1.40 us at an SM's share of the peak; it takes
// ~2.7 us. The products with N = 64 read both operands from shared memory,
// ~368 KB of shared traffic a visit with the dQ stores and reductions, and
// a warpgroup spends most of a visit off the tensor cores: exps, dS, dQ
// stores, and waits on its stage's loads. Key tiles launch in order, the
// first first: under causal masking key tile 0 is seen from every query
// tile, so the longest CTAs start first (the reverse order is 1.7-1.8x
// slower).
//
// Measured and not kept (PERF.md): a 256-thread CTA with no loading
// warpgroup (its loads and reductions, issued by a consumer warp, held
// that warpgroup up); Q and dO released before the deferred dQ product;
// the convert pass folded into this one (the CTA that finishes a query
// tile converts it: 3x slower, the dQ warp waiting on reductions to
// complete).
#include <cuda.h>
#include <limits.h>

#include "common.cuh"
#include "launch.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = repro::sm90;
using repro::to_f32;
using repro::warp_sum;

constexpr float kLog2e = 1.4426950408889634f;

// ---- pass 1: delta = rowsum(dO * O), dQ accumulator zeroed ----------------

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = to_f32(e[j]);
}

// One warp a (b, i, h) row of (B, Sq, Hq, D); lanes take 4 columns each.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_preprocess_kernel(const T* __restrict__ dout,
                                const T* __restrict__ out,
                                float* __restrict__ delta,
                                float* __restrict__ dq_acc, int rows, int Sq,
                                int Hq, int D) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * D;
  float s = 0.f;
  for (int c = lane * 4; c < D; c += 128) {
    float a[4], o[4];
    load4(dout + base + c, a);
    load4(out + base + c, o);
    s += a[0] * o[0] + a[1] * o[1] + a[2] * o[2] + a[3] * o[3];
    *reinterpret_cast<float4*>(dq_acc + base + c) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  s = warp_sum(s);
  if (lane == 0) {
    const int h = row % Hq, i = (row / Hq) % Sq, b = row / (Hq * Sq);
    delta[(static_cast<size_t>(b) * Hq + h) * Sq + i] = s;
  }
}

// ---- pass 3: dQ in q's type; the sequences that see no key ----------------

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(bf16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_convert_kernel(const float* __restrict__ dq_acc,
                             T* __restrict__ dq, size_t n4, int conv_blocks,
                             const T* __restrict__ dout,
                             T* __restrict__ dk, T* __restrict__ dv,
                             const int* __restrict__ kv_len, int Sq, int Skv,
                             int Hq, int Hkv, int D) {
  if (static_cast<int>(blockIdx.x) < conv_blocks) {
    for (size_t i = blockIdx.x * 256ull + threadIdx.x; i < n4;
         i += static_cast<size_t>(conv_blocks) * 256) {
      const float4 x = reinterpret_cast<const float4*>(dq_acc)[i];
      store4(dq + 4 * i, x);
    }
    return;
  }
  const int idx = blockIdx.x - conv_blocks;
  const int b = idx / Hkv, hk = idx % Hkv, group = Hq / Hkv;
  if (kv_len[b] > 0) return;
  const size_t q_row = static_cast<size_t>(Hq) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < Sq; ++i)
      for (int g = 0; g < group; ++g)
        s += to_f32(dout[(static_cast<size_t>(b) * Sq + i) * q_row +
                         (hk * group + g) * D + d]);
    const T val = repro::from_f32<T>(s / Skv);
    const T zero = repro::from_f32<T>(0.f);
    for (int k = 0; k < Skv; ++k) {
      const size_t at = (static_cast<size_t>(b) * Skv + k) * kv_row +
                        hk * D + d;
      dv[at] = val;
      dk[at] = zero;
    }
  }
}

// The query tiles of `BQ` rows that keys [k0, ...) can be seen from: under
// causal masking, row q (position q_offset + q) sees key k0 iff k0 <=
// q_offset + q, so the first tile is floor((k0 - q_offset) / BQ).
template <int BQ>
__device__ __forceinline__ int first_q_tile(int k0, int q_offset,
                                            int causal) {
  return causal && k0 > q_offset ? (k0 - q_offset) / BQ : 0;
}

// ---- pass 2, fp32 (CUDA cores) ---------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32Rows = 64;  // keys of a CTA, and rows of a query tile
constexpr int kLdS = kF32Rows + 4;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D>
constexpr int smem_bytes_bwd_f32() {
  return (4 * kF32Rows * (D + 4) + 3 * kF32Rows * kLdS + 2 * kF32Rows) *
         static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq_acc, float* __restrict__ dk,
                         float* __restrict__ dv,
                         const int* __restrict__ kv_len, int B, int Sq,
                         int Skv, int Hq, int Hkv, int q_offset, int causal,
                         float scale) {
  constexpr int R = kF32Rows;
  constexpr int LD = D + 4;
  constexpr int NG = D / 64;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + R * LD;
  float* sQ = sV + R * LD;
  float* sO = sQ + R * LD;     // dO
  float* sPq = sO + R * LD;    // P as [q][key]
  float* sDq = sPq + R * kLdS;  // dS as [q][key]
  float* sDk = sDq + R * kLdS;  // dS as [key][q]
  float* sL = sDk + R * kLdS;   // lse of the tile's rows
  float* sDl = sL + R;          // delta of the tile's rows

  const int kt = blockIdx.x / (Hkv * B), rest = blockIdx.x % (Hkv * B);
  const int hk = rest % Hkv, b = rest / Hkv, k0 = kt * R;
  const int group = Hq / Hkv;
  const int kvl = kv_len != nullptr ? kv_len[b] : Skv;
  if (kvl <= 0) return;  // pass 3 writes this sequence's dK and dV
  const int kv_lim = min(Skv, kvl);
  const int n_qt = (Sq + R - 1) / R;
  const int qt_lo = k0 < kv_lim ? first_q_tile<R>(k0, q_offset, causal)
                                : n_qt;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t q_row = static_cast<size_t>(Hq) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const float* kp = k + static_cast<size_t>(b) * Skv * kv_row + hk * D;
  const float* vp = v + static_cast<size_t>(b) * Skv * kv_row + hk * D;

  for (int idx = tid; idx < R * D; idx += kF32Threads) {
    const int r = idx / D, c = idx % D, kr = k0 + r;
    sK[r * LD + c] = kr < Skv ? kp[kr * kv_row + c] : 0.f;
    sV[r * LD + c] = kr < Skv ? vp[kr * kv_row + c] : 0.f;
  }
  float dk_acc[4][4 * NG], dv_acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  // the keys of this thread's score rows, and whether each is live
  int key[4];
  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    key[i] = k0 + ty * 4 + i;
    key_ok[i] = key[i] < kv_lim;
  }

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const float* qp = q + static_cast<size_t>(b) * Sq * q_row + h * D;
    const float* op = dout + static_cast<size_t>(b) * Sq * q_row + h * D;
    float* dqp = dq_acc + static_cast<size_t>(b) * Sq * q_row + h * D;
    const float* lp = lse + (static_cast<size_t>(b) * Hq + h) * Sq;
    const float* dlp = delta + (static_cast<size_t>(b) * Hq + h) * Sq;
    for (int qt = qt_lo; qt < n_qt; ++qt) {
      const int q0 = qt * R;
      __syncthreads();  // the previous tile's reads are done
      for (int idx = tid; idx < R * D; idx += kF32Threads) {
        const int r = idx / D, c = idx % D, qr = q0 + r;
        sQ[r * LD + c] = qr < Sq ? qp[qr * q_row + c] : 0.f;
        sO[r * LD + c] = qr < Sq ? op[qr * q_row + c] : 0.f;
      }
      if (tid < R) {
        const int qr = q0 + tid;
        sL[tid] = qr < Sq ? lp[qr] : INFINITY;
        sDl[tid] = qr < Sq ? dlp[qr] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: keys ty*4 + i, queries tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < D; c += 4) {
        float4 kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = ld4(&sK[(ty * 4 + i) * LD + c]);
          vv[i] = ld4(&sV[(ty * 4 + i) * LD + c]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = ld4(&sQ[(tx + 16 * j) * LD + c]);
          ov[j] = ld4(&sO[(tx + 16 * j) * LD + c]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] += kv[i].x * qv[j].x + kv[i].y * qv[j].y +
                       kv[i].z * qv[j].z + kv[i].w * qv[j].w;
            dp[i][j] += vv[i].x * ov[j].x + vv[i].y * ov[j].y +
                        vv[i].z * ov[j].z + vv[i].w * ov[j].w;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx + 16 * j, qr = q0 + qi;
          const bool ok = key_ok[i] && qr < Sq &&
                          (!causal || key[i] <= q_offset + qr);
          const float p = ok ? expf(s[i][j] * scale - sL[qi]) : 0.f;
          const float ds = p * (dp[i][j] - sDl[qi]) * scale;
          sPq[qi * kLdS + ty * 4 + i] = p;
          sDq[qi * kLdS + ty * 4 + i] = ds;
          sDk[(ty * 4 + i) * kLdS + qi] = ds;
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: keys ty*4 + i, columns g*64 + tx*4 + e
#pragma unroll 2
      for (int qi = 0; qi < R; ++qi) {
        const float4 p4 = ld4(&sPq[qi * kLdS + ty * 4]);
        const float4 d4 = ld4(&sDq[qi * kLdS + ty * 4]);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
        const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 o4 = ld4(&sO[qi * LD + g * 64 + tx * 4]);
          const float4 q4 = ld4(&sQ[qi * LD + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][g * 4 + 0] += pr[i] * o4.x;
            dv_acc[i][g * 4 + 1] += pr[i] * o4.y;
            dv_acc[i][g * 4 + 2] += pr[i] * o4.z;
            dv_acc[i][g * 4 + 3] += pr[i] * o4.w;
            dk_acc[i][g * 4 + 0] += dr[i] * q4.x;
            dk_acc[i][g * 4 + 1] += dr[i] * q4.y;
            dk_acc[i][g * 4 + 2] += dr[i] * q4.z;
            dk_acc[i][g * 4 + 3] += dr[i] * q4.w;
          }
        }
      }
      // dQ = dS K: query rows ty*4 + i, columns g*64 + tx*4 + e
      float dq[4][4 * NG];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4 * NG; ++c) dq[i][c] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < R; ++kk) {
        const float4 d4 = ld4(&sDk[kk * kLdS + ty * 4]);
        const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 k4 = ld4(&sK[kk * LD + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dq[i][g * 4 + 0] += dr[i] * k4.x;
            dq[i][g * 4 + 1] += dr[i] * k4.y;
            dq[i][g * 4 + 2] += dr[i] * k4.z;
            dq[i][g * 4 + 3] += dr[i] * k4.w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = q0 + ty * 4 + i;
        if (qr >= Sq) continue;
#pragma unroll
        for (int g = 0; g < NG; ++g)
          atomicAdd(reinterpret_cast<float4*>(dqp + qr * q_row + g * 64 +
                                              tx * 4),
                    make_float4(dq[i][g * 4 + 0], dq[i][g * 4 + 1],
                                dq[i][g * 4 + 2], dq[i][g * 4 + 3]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (key[i] >= Skv) continue;
    const size_t at = (static_cast<size_t>(b) * Skv + key[i]) * kv_row +
                      hk * D;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      *reinterpret_cast<float4*>(dk + at + g * 64 + tx * 4) =
          make_float4(dk_acc[i][g * 4 + 0], dk_acc[i][g * 4 + 1],
                      dk_acc[i][g * 4 + 2], dk_acc[i][g * 4 + 3]);
      *reinterpret_cast<float4*>(dv + at + g * 64 + tx * 4) =
          make_float4(dv_acc[i][g * 4 + 0], dv_acc[i][g * 4 + 1],
                      dv_acc[i][g * 4 + 2], dv_acc[i][g * 4 + 3]);
    }
  }
}

// ---- pass 2, bf16 (TMA + wgmma) --------------------------------------------

constexpr int kPanel = 64;  // bf16 columns of one 128-byte swizzled row

template <bool B>
struct Bool {
  static constexpr bool value = B;
};

template <int D>
struct BwdConfig {
  static constexpr int BQ = 64;                 // rows of a query tile
  static constexpr int BK = 128;                // keys of a CTA
  static constexpr int NP = (D + kPanel - 1) / kPanel;  // column panels
  static constexpr int KS = D / 16;             // k-steps over D
  static constexpr int ST = 2;                  // Q/dO ring depth
  static constexpr int THREADS = 384;  // 2 consumer WGs (64 keys each), 1 more
  static constexpr int Q_ELEMS = BQ * NP * kPanel;   // a Q or dO tile
  static constexpr int KV_ELEMS = BK * NP * kPanel;  // the K or V tile
  static constexpr int DS_ELEMS = BQ * BK;           // dS, 2 key panels
  static constexpr int Q_BYTES = Q_ELEMS * 2;
  static constexpr int KV_BYTES = KV_ELEMS * 2;
  // each warpgroup's dQ panel: 64 columns of dQ over all 128 keys, or for
  // D = 64 all of dQ over its own 64 keys (two parts, both reduced)
  static constexpr bool DQ_OWN_KEYS = NP == 1;
  // a dQ tile: BQ rows x the two warpgroups' panels in fp32, as boxes of
  // 32 columns (128 bytes a row), two a panel
  static constexpr int DQ_ELEMS = BQ * 2 * kPanel;
  // K, V, the Q and dO rings, two dS tiles, two dQ tiles, lse and delta a
  // stage, the barriers (full K/V; full and empty a stage; full and empty
  // a dS and a dQ tile), 1024 bytes of alignment
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + 2 * ST * Q_BYTES +
                              2 * DS_ELEMS * 2 + 2 * DQ_ELEMS * 4 +
                              2 * ST * BQ * 4 + (9 + 2 * ST) * 8;
  // the loading warpgroup keeps few registers; the consumers hold dK and
  // dV (D/2 each) beside S^T and dP^T (32 each), or P^T and dS^T (16 each)
  // and a dQ panel (32)
  static constexpr uint32_t LOADER_REGS = 24;
  static constexpr uint32_t CONSUMER_REGS = 240;
  // setmaxnreg moves registers within the CTA's launch allocation (168 a
  // thread at 384 threads): a consumer's .inc past it would wait forever
  static_assert(LOADER_REGS + 2 * CONSUMER_REGS <= 3 * 168,
                "the warpgroups' register budgets exceed the launch's");
};

// 2^x on the special-function unit, subnormal results flushed to zero.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 64) = A B^T over KS k-steps of 16: A (64 rows) and B (64 rows)
// K-major, in panels of 64 columns `a_panel` and `b_panel` elements apart.
template <int KS>
__device__ __forceinline__ void issue_nt(float (&d)[32], const bf16* a,
                                         int a_panel, const bf16* b,
                                         int b_panel) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int p = ks / 4, c = (ks % 4) * 16;
    sm90::wgmma_ss<64>(d, sm90::desc_sw128(a + p * a_panel + c, 16, 1024),
                       sm90::desc_sw128(b + p * b_panel + c, 16, 1024),
                       ks > 0);
  }
}

// D (64 x D) += A (64 x 64, bf16 fragments) B: B (64 rows x D) MN-major,
// its 64-column panels 64 rows apart.
template <int D>
__device__ __forceinline__ void issue_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_rs<D>(d, a[kk],
                      sm90::desc_sw128(b + kk * 16 * kPanel, 64 * 128, 1024));
}

// dQ (64 x 64) = dS (64 queries x 16 KS keys, K-major, in key panels of
// 64) K (those keys x the 64 columns of one panel, MN-major); issued, not
// committed.
template <int KS>
__device__ __forceinline__ void issue_dq(float (&d)[32], const bf16* ds,
                                         const bf16* kp) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int p = ks / 4, c = (ks % 4) * 16;
    sm90::wgmma_ss_tb<64>(
        d, sm90::desc_sw128(ds + p * 64 * kPanel + c, 16, 1024),
        sm90::desc_sw128(kp + ks * 16 * kPanel, 128 * 128, 1024), ks > 0);
  }
}

// A 64 x 64 fp32 accumulator tile as bf16 A fragments, one per 16 columns.
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// A warpgroup's 64 x 64 dQ panel (columns col0 ..) from registers into the
// shared fp32 dQ tile `sdq` (boxes of 64 rows x 32 columns, 128-byte
// swizzled as TMA reads them, so a warp's 8-byte writes take two
// wavefronts), then ordered before the reduction's reads.
__device__ __forceinline__ void store_dq(const float (&d)[32], float* sdq,
                                         int wr, int t, int col0) {
  uint8_t* tile = reinterpret_cast<uint8_t*>(sdq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + 8 * r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + 8 * j + 2 * t;  // even: 8 bytes in one chunk
      *reinterpret_cast<float2*>(
          tile + (c >> 5) * 64 * 128 + row * 128 +
          ((((c & 31) >> 2) ^ (row & 7)) << 4) + (c & 3) * 4) =
          make_float2(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
    }
  }
  sm90::fence_async_shared();
}

template <int D>
__global__ void __launch_bounds__(BwdConfig<D>::THREADS, 1)
    flash_bwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dq,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk,
                          bf16* __restrict__ dv,
                          const int* __restrict__ kv_len, int B, int Sq,
                          int Skv, int Hq, int Hkv, int q_offset, int causal,
                          float scale, float scale_log2) {
  using C = BwdConfig<D>;
  constexpr int ST = C::ST, BQ = C::BQ, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sK = reinterpret_cast<bf16*>(base);
  bf16* sV = sK + C::KV_ELEMS;
  bf16* sQ = sV + C::KV_ELEMS;       // ST stages
  bf16* sO = sQ + ST * C::Q_ELEMS;   // dO, ST stages
  bf16* sDS = sO + ST * C::Q_ELEMS;  // 2 dS tiles
  float* sDQ = reinterpret_cast<float*>(sDS + 2 * C::DS_ELEMS);  // 2 tiles
  float* sL = sDQ + 2 * C::DQ_ELEMS;  // ST x BQ
  float* sDl = sL + ST * BQ;
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sDl + ST * BQ);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + ST;
  uint64_t* ds_full = empty + ST;    // both halves of a dS tile are in
  uint64_t* ds_empty = ds_full + 2;  // the dQ products have read a dS tile
  uint64_t* dq_full = ds_empty + 2;  // both panels of a dQ tile are in
  uint64_t* dq_empty = dq_full + 2;  // a dQ tile's reductions have read it

  // key tiles in launch order: the first (under causal masking the
  // longest: key tile 0 is seen from every query tile) first
  const int kt = blockIdx.x / (Hkv * B);
  const int rest = blockIdx.x % (Hkv * B);
  const int hk = rest % Hkv, b = rest / Hkv, k0 = kt * BK;
  const int group = Hq / Hkv;
  const int kvl = kv_len != nullptr ? kv_len[b] : Skv;
  if (kvl <= 0) return;  // pass 3 writes this sequence's dK and dV
  const int kv_lim = min(Skv, kvl);
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt_lo = k0 < kv_lim ? first_q_tile<BQ>(k0, q_offset, causal)
                                : n_qt;
  // visit v is query tile qt_lo + v % per_head of the group's head
  // v / per_head
  const int per_head = n_qt - qt_lo;
  const int n_vis = group * per_head;

  if (threadIdx.x == 0) {
    sm90::mbar_init(full_kv, 1);
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(&full[s], 32);  // the loading warp, and TMA's bytes
      sm90::mbar_init(&empty[s], 8);  // one arrival a warp
    }
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&ds_full[i], 8);
      sm90::mbar_init(&ds_empty[i], 8);
      sm90::mbar_init(&dq_full[i], 8);
      sm90::mbar_init(&dq_empty[i], 1);  // the reductions' issuer
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32, t = lane % 4;
  if (wg == 2) {
    // ---- warpgroup 2: warp 0 loads, warp 1's lane 0 reduces dQ ----------
    sm90::regs_dealloc<C::LOADER_REGS>();
    if (n_vis == 0 || tid >= 64) return;
    if (tid >= 32) {
      // each visit's dQ tile into the accumulator, one TMA reduction a box
      // (both warpgroups' panels; for D = 64 their two parts, into the
      // same columns); tile (u - 1) % 2 is handed back once read
      if (lane != 0) return;
      sm90::prefetch_tmap(&tm_dq);
      for (int u = 0; u < n_vis; ++u) {
        const int h = hk * group + u / per_head;
        const int q0 = (qt_lo + u % per_head) * BQ;
        sm90::mbar_wait(&dq_full[u & 1], (u >> 1) & 1);
        for (int bx = 0; bx < 4; ++bx)
          sm90::tma_reduce_add_4d(
              &tm_dq, sDQ + (u & 1) * C::DQ_ELEMS + bx * BQ * 32,
              (C::DQ_OWN_KEYS ? bx % 2 : bx) * 32, h, q0, b);
        sm90::tma_store_commit();
        sm90::bulk_wait_read_1();
        if (u > 0) sm90::mbar_arrive(&dq_empty[(u - 1) & 1]);
      }
      sm90::bulk_wait_all();
      return;
    }
    // K and V once (TMA), then each visit's Q and dO (TMA, lane 0) and its
    // lse (in log2 units) and delta (every lane) into stage v % ST, once
    // both warpgroups are done with visit v - ST
    if (lane == 0) {
      sm90::prefetch_tmap(&tm_q);
      sm90::prefetch_tmap(&tm_do);
      sm90::mbar_expect_tx(full_kv, 2 * C::KV_BYTES);
      for (int p = 0; p < C::NP; ++p) {
        sm90::tma_load_4d(sK + p * BK * kPanel, &tm_k, full_kv, p * kPanel,
                          hk, k0, b);
        sm90::tma_load_4d(sV + p * BK * kPanel, &tm_v, full_kv, p * kPanel,
                          hk, k0, b);
      }
    }
    for (int v = 0; v < n_vis; ++v) {
      const int s = v % ST;
      const int h = hk * group + v / per_head;
      const int q0 = (qt_lo + v % per_head) * BQ;
      if (v >= ST) sm90::mbar_wait(&empty[s], ((v / ST) & 1) ^ 1);
      const float* lp = lse + (static_cast<size_t>(b) * Hq + h) * Sq;
      const float* dlp = delta + (static_cast<size_t>(b) * Hq + h) * Sq;
      for (int r = lane; r < BQ; r += 32) {
        // rows past Sq: lse +inf and delta 0 (only masked visits reach
        // them)
        const int qr = q0 + r;
        sL[s * BQ + r] = qr < Sq ? lp[qr] * kLog2e : INFINITY;
        sDl[s * BQ + r] = qr < Sq ? dlp[qr] : 0.f;
      }
      if (lane == 0) {
        sm90::mbar_expect_tx(&full[s], 2 * C::Q_BYTES);
        for (int p = 0; p < C::NP; ++p) {
          sm90::tma_load_4d(sQ + s * C::Q_ELEMS + p * BQ * kPanel, &tm_q,
                            &full[s], p * kPanel, h, q0, b);
          sm90::tma_load_4d(sO + s * C::Q_ELEMS + p * BQ * kPanel, &tm_do,
                            &full[s], p * kPanel, h, q0, b);
        }
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: keys k0 + 64 wg .. + 63 ---------------------
  sm90::regs_alloc<C::CONSUMER_REGS>();
  const int wr = (tid / 32) * 16 + lane / 4;  // rows wr, wr + 8 of the 64
  // this thread's keys: k0 + 64 wg + wr and 8 after it
  const int key0 = k0 + wg * 64 + wr;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  if (wg == 1) sm90::named_bar_arrive(3, 256);
  if (n_vis > 0) sm90::mbar_wait(full_kv, 0);

  // No branch lies between a product's issue and its wait (ptxas would
  // serialize every wgmma otherwise), and both warpgroups run the same
  // code. They issue their products in turns (named barriers 3 and 4),
  // warpgroup 0 first, two turns a visit each (S^T and dP^T; dQ, dV and
  // dK), so one's exps, dS and stores run while the other's products hold
  // the tensor cores. Warpgroup 1 opens once; warpgroup 0 takes the last
  // hand-over.
  auto turn_begin = [&] { sm90::named_bar_sync(3 + wg, 256); };
  auto turn_end = [&] { sm90::named_bar_arrive(4 - wg, 256); };
  const bf16* sKw = sK + wg * 64 * kPanel;
  const bf16* sVw = sV + wg * 64 * kPanel;
  // warpgroup wg's dQ product: dS over all 128 keys times K's column
  // panel wg (the last one of D = 112 reads K's zero-filled columns
  // 112-127; TMA drops them from the sum), or for D = 64 its own half of
  // dS times its own 64 keys of K
  const int dq_a = C::DQ_OWN_KEYS ? wg * BQ * kPanel : 0;
  const bf16* sKp =
      sK + (C::DQ_OWN_KEYS ? wg * 64 * kPanel : wg * BK * kPanel);
  constexpr int kDqSteps = C::DQ_OWN_KEYS ? 4 : 8;
  // dQ of visit u (done) from registers into this warpgroup's panel of dQ
  // tile u % 2, once visit u - 2's reductions have read the tile
  auto put_dq = [&](const float (&dq)[32], int u) {
    if (u >= 2) sm90::mbar_wait(&dq_empty[u & 1], ((u >> 1) - 1) & 1);
    store_dq(dq, sDQ + (u & 1) * C::DQ_ELEMS, wr, t, 64 * wg);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&dq_full[u & 1]);
  };

  // Visit v: query tile q0 from ring stage v % ST. A visit needs the
  // mask only when its tile crosses Sq, kv_lim or (if causal) the
  // diagonal; the first visit has no dQ of a visit before it.
  auto visit = [&](int v, int q0, auto masked, auto first) {
    constexpr bool kDq = !decltype(first)::value;
    const int s = v % ST, u = v - 1;
    const bf16* sQs = sQ + s * C::Q_ELEMS;
    const bf16* sOs = sO + s * C::Q_ELEMS;
    sm90::mbar_wait(&full[s], (v / ST) & 1);
    float sc[32], dp[32];  // S^T and dP^T, 64 keys x 64 queries
    turn_begin();
    sm90::wgmma_fence();
    issue_nt<C::KS>(sc, sKw, BK * kPanel, sQs, BQ * kPanel);
    sm90::wgmma_commit();
    issue_nt<C::KS>(dp, sVw, BK * kPanel, sOs, BQ * kPanel);
    sm90::wgmma_commit();
    turn_end();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(sc);
    // P^T = exp2(S^T scale log2 e - lse log2 e), 0 where masked:
    // element 4j + 2r + e is key key0 + 8r, query q0 + 8j + 2t + e, and
    // key k is seen from the query rows at or past q_min (none past
    // kv_lim)
    int q_min[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = key0 + 8 * r;
      q_min[r] = k >= kv_lim ? INT_MAX : (causal ? k - q_offset : INT_MIN);
    }
    const float* sLs = sL + s * BQ;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * j + 2 * t + e, qpos = q0 + qi;
        const float l2 = sLs[qi];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = sc[4 * j + 2 * r + e];
          x = fast_exp2(fmaf(x, scale_log2, -l2));
          if (decltype(masked)::value)
            x = qpos >= q_min[r] && qpos < Sq ? x : 0.f;
        }
      }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
    // dS^T = scale P^T (dP^T - delta)
    const float* sDls = sDl + s * BQ;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = sDls[8 * j + 2 * t + e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * j + 2 * r + e;
          dp[x] = sc[x] * (dp[x] - dl) * scale;
        }
      }
    uint32_t pa[4][4], da[4][4];
    pack_a(sc, pa);
    pack_a(dp, da);
    // dS as bf16 into this warpgroup's key panel of dS tile v % 2, row q,
    // 16-byte chunk (key / 8) ^ (q % 8): a K-major A operand for dQ, once
    // visit v - 2's dQ products have read the tile. (Written while the
    // products below run, the stores made nvcc's cicc crash.)
    if (v >= 2) sm90::mbar_wait(&ds_empty[v & 1], ((v >> 1) - 1) & 1);
    uint8_t* sDSw =
        reinterpret_cast<uint8_t*>(sDS + (v & 1) * C::DS_ELEMS) +
        wg * BQ * 128;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * j + 2 * t + e;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kk = wr + 8 * r;
          *reinterpret_cast<bf16*>(sDSw + qi * 128 +
                                   (((kk >> 3) ^ (qi & 7)) << 4) +
                                   (kk & 7) * 2) =
              __float2bfloat16(dp[4 * j + 2 * r + e]);
        }
      }
    sm90::fence_async_shared();
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&ds_full[v & 1]);
    // dQ of visit v - 1 (whose dS tile both warpgroups wrote in their
    // visit before), dV and dK of this one
    if (kDq) sm90::mbar_wait(&ds_full[u & 1], (u >> 1) & 1);
    float dq[32];
    turn_begin();
    sm90::wgmma_fence();
    if constexpr (kDq)
      issue_dq<kDqSteps>(dq, sDS + (u & 1) * C::DS_ELEMS + dq_a, sKp);
    issue_rs<D>(dv_acc, pa, sOs);
    issue_rs<D>(dk_acc, da, sQs);
    sm90::wgmma_commit();
    turn_end();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv_acc);
    sm90::fence_regs(dk_acc);
    if constexpr (kDq) sm90::fence_regs(dq);
    __syncwarp();
    if (lane == 0) {
      sm90::mbar_arrive(&empty[s]);  // Q, dO, lse, delta done
      if (kDq) sm90::mbar_arrive(&ds_empty[u & 1]);
    }
    if constexpr (kDq) put_dq(dq, u);
  };

  const int key_hi = k0 + wg * 64 + 63;
  for (int hh = 0, v = 0; hh < group; ++hh)
    for (int qt = qt_lo; qt < n_qt; ++qt, ++v) {
      const int q0 = qt * BQ;
      const bool masked = key_hi >= kv_lim || q0 + BQ > Sq ||
                          (causal && key_hi > q_offset + q0);
      if (v == 0) {
        if (masked)
          visit(v, q0, Bool<true>{}, Bool<true>{});
        else
          visit(v, q0, Bool<false>{}, Bool<true>{});
      } else if (masked) {
        visit(v, q0, Bool<true>{}, Bool<false>{});
      } else {
        visit(v, q0, Bool<false>{}, Bool<false>{});
      }
    }
  if (n_vis > 0) {
    // the last visit's dQ
    const int u = n_vis - 1;
    sm90::mbar_wait(&ds_full[u & 1], (u >> 1) & 1);
    float dq[32];
    turn_begin();
    sm90::wgmma_fence();
    issue_dq<kDqSteps>(dq, sDS + (u & 1) * C::DS_ELEMS + dq_a, sKp);
    sm90::wgmma_commit();
    turn_end();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    put_dq(dq, u);
  }
  if (wg == 0) sm90::named_bar_sync(3, 256);

  // dK and dV of this thread's two keys
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Skv) continue;
    const size_t at = (static_cast<size_t>(b) * Skv + key) * kv_row +
                      hk * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * j) =
          pack_bf16(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * j) =
          pack_bf16(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// ---- launch -----------------------------------------------------------------

template <int D>
cudaError_t launch_main_f32(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, float* dq_acc, void* dk,
                            void* dv, const int* kv_len, int B, int Sq,
                            int Skv, int Hq, int Hkv, int q_offset,
                            int causal, float scale, cudaStream_t stream) {
  static bool configured = false;
  cudaError_t e = sm90::allow_smem(flash_bwd_f32_kernel<D>,
                                   smem_bytes_bwd_f32<D>(), &configured);
  if (e != cudaSuccess) return e;
  const int grid = (Skv + kF32Rows - 1) / kF32Rows * Hkv * B;
  flash_bwd_f32_kernel<D>
      <<<grid, kF32Threads, smem_bytes_bwd_f32<D>(), stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout), lse,
          delta, dq_acc, static_cast<float*>(dk), static_cast<float*>(dv),
          kv_len, B, Sq, Skv, Hq, Hkv, q_offset, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_main_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, float* dq_acc, void* dk,
                             void* dv, const int* kv_len, int B, int Sq,
                             int Skv, int Hq, int Hkv, int q_offset,
                             int causal, float scale, cudaStream_t stream) {
  using C = BwdConfig<D>;
  static bool configured = false;
  cudaError_t e =
      sm90::allow_smem(flash_bwd_bf16_kernel<D>, C::SMEM, &configured);
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if ((e = sm90::tensor_map(&tq, q, B, Sq, Hq, D, C::BQ)) != cudaSuccess ||
      (e = sm90::tensor_map(&tdq, dq_acc, B, Sq, Hq, D, C::BQ, true)) !=
          cudaSuccess ||
      (e = sm90::tensor_map(&tdo, dout, B, Sq, Hq, D, C::BQ)) !=
          cudaSuccess ||
      (e = sm90::tensor_map(&tk, k, B, Skv, Hkv, D, C::BK)) !=
          cudaSuccess ||
      (e = sm90::tensor_map(&tv, v, B, Skv, Hkv, D, C::BK)) != cudaSuccess)
    return e;
  const int grid = (Skv + C::BK - 1) / C::BK * Hkv * B;
  flash_bwd_bf16_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, tdq, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), kv_len, B, Sq, Skv, Hq, Hkv, q_offset, causal,
      scale, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_passes(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const float* lse,
                          const int* kv_len, void* dq, void* dk, void* dv,
                          float* dq_acc, float* delta, int B, int Sq, int Skv,
                          int Hq, int Hkv, int D, int q_offset, int causal,
                          float scale, cudaStream_t s) {
  const int rows = B * Sq * Hq;
  flash_bwd_preprocess_kernel<T><<<(rows + 7) / 8, 256, 0, s>>>(
      static_cast<const T*>(dout), static_cast<const T*>(o), delta, dq_acc,
      rows, Sq, Hq, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr bool kBf16 = sizeof(T) == 2;
  if constexpr (kBf16)
    e = D == 64    ? launch_main_bf16<64>(q, k, v, dout, lse, delta, dq_acc,
                                          dk, dv, kv_len, B, Sq, Skv, Hq,
                                          Hkv, q_offset, causal, scale, s)
        : D == 112 ? launch_main_bf16<112>(q, k, v, dout, lse, delta, dq_acc,
                                           dk, dv, kv_len, B, Sq, Skv, Hq,
                                           Hkv, q_offset, causal, scale, s)
                   : launch_main_bf16<128>(q, k, v, dout, lse, delta, dq_acc,
                                           dk, dv, kv_len, B, Sq, Skv, Hq,
                                           Hkv, q_offset, causal, scale, s);
  else
    e = D == 64 ? launch_main_f32<64>(q, k, v, dout, lse, delta, dq_acc, dk,
                                      dv, kv_len, B, Sq, Skv, Hq, Hkv,
                                      q_offset, causal, scale, s)
                : launch_main_f32<128>(q, k, v, dout, lse, delta, dq_acc, dk,
                                       dv, kv_len, B, Sq, Skv, Hq, Hkv,
                                       q_offset, causal, scale, s);
  if (e != cudaSuccess) return e;
  const size_t n4 = static_cast<size_t>(rows) * D / 4;
  const int conv_blocks =
      kBf16 ? static_cast<int>(n4 < 132 * 16 * 256 ? (n4 + 255) / 256
                                                   : 132 * 16)
            : 0;
  const int dead_blocks = kv_len != nullptr ? B * Hkv : 0;
  if (conv_blocks + dead_blocks == 0) return cudaSuccess;
  flash_bwd_convert_kernel<T><<<conv_blocks + dead_blocks, 256, 0, s>>>(
      dq_acc, static_cast<T*>(dq), n4, conv_blocks,
      static_cast<const T*>(dout), static_cast<T*>(dk), static_cast<T*>(dv),
      kv_len, Sq, Skv, Hq, Hkv, D);
  return cudaGetLastError();
}

}  // namespace

// Tensors contiguous and 16-byte aligned on the device; kv_len (B,) int32
// or null. dq_acc: (B, Sq, Hq, D) fp32 scratch (for fp32 inputs, dq
// itself); delta: (B, Hq, Sq) fp32 scratch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* kv_len, void* dq,
    void* dk, void* dv, void* dq_acc, void* delta, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, int q_offset, int causal, float scale,
    int bf16_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0 || q_offset < 0 ||
      (D != 64 && D != 128 && !(bf16_in && D == 112)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  const float* lp = static_cast<const float*>(lse);
  const int* kl = static_cast<const int*>(kv_len);
  float* acc = static_cast<float*>(dq_acc);
  float* dl = static_cast<float*>(delta);
  const cudaError_t e =
      bf16_in ? launch_passes<bf16>(q, k, v, o, dout, lp, kl, dq, dk, dv, acc,
                                    dl, B, Sq, Skv, Hq, Hkv, D, q_offset,
                                    causal, scale, s)
              : launch_passes<float>(q, k, v, o, dout, lp, kl, dq, dk, dv,
                                     acc, dl, B, Sq, Skv, Hq, Hkv, D,
                                     q_offset, causal, scale, s);
  return static_cast<int>(e);
}
