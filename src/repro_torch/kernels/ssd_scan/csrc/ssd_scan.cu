// Kernel B4: Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan_pallas` in
// src/repro/kernels/ssd_scan/ssd_scan.py (body `_ssd_kernel`).
//
//   x: (B, S, H, P) and Bm, Cm: (B, S, G, N), one type (fp32 or bf16);
//   dt: (B, S, H), A, D: (H,), init: (B, H, P, N) or null, all fp32.
//   y: (B, S, H, P) in x's type; fin: (B, H, P, N) fp32. Head h reads
//   group h / (H / G); P <= 64 and N <= 128, both multiples of 4.
//
// For each chunk of Q positions (the last may be ragged), with
// cum = cumsum(dt * A) restarting at the chunk's start:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . state^T + D x_i
//   state = state exp(cum_last) + sum_j x_j^T (B_j exp(cum_last - cum_j) dt_j)
// which is `ssd_chunked_ref`'s block decomposition, and for a ragged chunk
// the recurrence's own result (positions past S act as dt = 0, x = 0).
//
// What bounds it on the H100: fp32 operations. Per (batch, head, chunk)
// the three products (C B^T over the lower triangle, y_inter, the state
// update) cost ~3 * Q * P * N * 2 flops against ~Q * (P + 2N) input
// values, far above the card's balance point; the reference computes in
// fp32, and an fp32 tensor-core product would round through TF32, so the
// products are fp32 FMAs on the CUDA cores.
//
// Design (simple first): one 256-thread CTA per (head, batch) walks the
// chunks in order, in place of the TPU's sequential grid axis; the (P, N)
// fp32 state stays in shared memory for the whole walk. A chunk is walked
// in 64-row sub-tiles so that no Q x Q matrix is ever formed: for each
// query tile the CTA keeps C (fp32) in shared memory and an output tile in
// registers, and for each key tile at or below it forms the 64 x 64 score
// tile, masks and scales it by exp(cum_i - cum_j) dt_j (a difference of the
// fp32 cumsums, as the reference takes it), and multiplies it into x. All
// products run through one register-tiled routine: each thread owns a 4 x 4
// block of the output at rows ty + 16a, columns tx + 16c, and the tiles'
// rows are padded by one float so every shared read is conflict-free or a
// broadcast. The chunk's cumsum is accumulated in double by one warp and
// rounded to fp32. About 134 KB of shared memory at Q = 256, so one CTA per
// SM; at batch 1 only H CTAs run (64 for mamba2-1.3b on 132 SMs).
// Computing C B^T once per group rather than per head, bf16 tensor cores
// for it, and chunk-parallel states are later work.
#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 256;
constexpr int kT = 64;                // rows of a sub-tile
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kLdN = kMaxN + 1;       // padded row of C, B and the state
constexpr int kLdT = kT + 1;          // padded row of x and the score tile
constexpr int kFixedFloats = 3 * kT * kLdN + 2 * kT * kLdT;

// acc[a][c] += sum_k A(ty + 16a, k) * B(k, tx + 16c), with
// A(r, k) = A[r * ar + k * ak] and B(k, c) = B[k * bk + c * bc]
__device__ __forceinline__ void mm4x4(float (&acc)[4][4], const float* A,
                                      int ar, int ak, const float* B, int bk,
                                      int bc, int K, int ty, int tx) {
  for (int k = 0; k < K; ++k) {
    float a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * ar + k * ak];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = B[k * bk + (tx + 16 * j) * bc];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// kT rows of `cols` values, `stride` elements apart in global memory, into
// shared rows of `ld` floats; rows at or past `live` are zeros
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          size_t stride, int cols, int live) {
  for (int i = threadIdx.x; i < kT * cols; i += kThreads) {
    const int r = i / cols, c = i % cols;
    dst[r * ld + c] = r < live ? to_f32(src[r * stride + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ Dv,
                    const float* __restrict__ init, T* __restrict__ y,
                    float* __restrict__ fin, int S, int H, int P, int G,
                    int N, int Q) {
  extern __shared__ float smem[];
  float* sC = smem;
  float* sB = sC + kT * kLdN;
  float* sSt = sB + kT * kLdN;
  float* sX = sSt + kT * kLdN;
  float* sS = sX + kT * kLdT;
  float* sCum = sS + kT * kLdT;
  float* sDt = sCum + Q;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const float a_h = A[h], d_h = Dv[h];

  // zero padding everywhere, so rows and columns past the live ones are
  // finite and only ever reach outputs that are not written
  for (int i = tid; i < kFixedFloats; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  const size_t st_off = (static_cast<size_t>(b) * H + h) * P * N;
  if (init != nullptr)
    for (int i = tid; i < P * N; i += kThreads)
      sSt[(i / N) * kLdN + i % N] = init[st_off + i];

  const size_t x_row = static_cast<size_t>(H) * P;   // one position of x, y
  const size_t bc_row = static_cast<size_t>(G) * N;  // one position of B, C
  const T* xb = x + static_cast<size_t>(b) * S * x_row + h * P;
  T* yb = y + static_cast<size_t>(b) * S * x_row + h * P;
  const T* Bb = Bm + static_cast<size_t>(b) * S * bc_row + g * N;
  const T* Cb = Cm + static_cast<size_t>(b) * S * bc_row + g * N;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int L = min(Q, S - c0);
    __syncthreads();  // the previous chunk is done with sDt, sCum and sSt
    for (int i = tid; i < Q; i += kThreads)
      sDt[i] = i < L ? dtb[static_cast<size_t>(c0 + i) * H] : 0.f;
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
      double base = __shfl_up_sync(0xffffffffu, run, 1);
      if (lane == 0) base = 0.0;
      for (int k = k0; k < k1; ++k) {
        base += static_cast<double>(sDt[k] * a_h);
        sCum[k] = static_cast<float>(base);
      }
    }
    __syncthreads();
    const float cum_last = sCum[L - 1];

    for (int i0 = 0; i0 < L; i0 += kT) {
      load_rows(sC, kLdN, Cb + static_cast<size_t>(c0 + i0) * bc_row, bc_row,
                N, L - i0);
      __syncthreads();
      // y_inter from the state entering the chunk
      float yacc[4][4] = {};
      mm4x4(yacc, sC, kLdN, 1, sSt, 1, kLdN, N, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int il = i0 + ty + 16 * a;
        const float e = il < L ? expf(sCum[il]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) yacc[a][c] *= e;
      }
      // y_intra over the key tiles at or below this query tile
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        __syncthreads();  // the previous key tile is no longer read
        const size_t t0 = static_cast<size_t>(c0 + j0);
        load_rows(sB, kLdN, Bb + t0 * bc_row, bc_row, N, L - j0);
        load_rows(sX, kLdT, xb + t0 * x_row, x_row, P, L - j0);
        __syncthreads();
        float s[4][4] = {};
        mm4x4(s, sC, kLdN, 1, sB, 1, kLdN, N, ty, tx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int il = i0 + ty + 16 * a;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int jl = j0 + tx + 16 * c;
            const bool live = jl <= il && il < L;
            sS[(ty + 16 * a) * kLdT + tx + 16 * c] =
                live ? s[a][c] * expf(sCum[il] - sCum[jl]) * sDt[jl] : 0.f;
          }
        }
        __syncthreads();
        mm4x4(yacc, sS, kLdT, 1, sX, kLdT, 1, kT, ty, tx);
      }
      // sX now holds this query tile's own x rows (the last key tile)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        if (i0 + r >= L) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p < P)
            yb[static_cast<size_t>(c0 + i0 + r) * x_row + p] =
                from_f32<T>(yacc[a][c] + d_h * sX[r * kLdT + p]);
        }
      }
    }

    // state = state exp(cum_last) + x^T (B exp(cum_last - cum) dt)
    float acc[2][4][4] = {};
    for (int j0 = 0; j0 < L; j0 += kT) {
      __syncthreads();  // sB, sX (and, first, sSt's y_inter) reads are done
      const int live = L - j0;
      for (int i = tid; i < kT * N; i += kThreads) {
        const int r = i / N, n = i % N, jl = j0 + r;
        float v = 0.f;
        if (r < live)
          v = to_f32(Bb[static_cast<size_t>(c0 + jl) * bc_row + n]) *
              (expf(cum_last - sCum[jl]) * sDt[jl]);
        sB[r * kLdN + n] = v;
      }
      load_rows(sX, kLdT, xb + static_cast<size_t>(c0 + j0) * x_row, x_row,
                P, live);
      __syncthreads();
      mm4x4(acc[0], sX, 1, kLdT, sB, kLdN, 1, kT, ty, tx);
      if (N > kT) mm4x4(acc[1], sX, 1, kLdT, sB + kT, kLdN, 1, kT, ty, tx);
    }
    const float decay = expf(cum_last);
    // each thread owns its (p, n) entries: no other thread reads them now
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = ty + 16 * a, n = half * kT + tx + 16 * c;
          if (p < P && n < N)
            sSt[p * kLdN + n] = sSt[p * kLdN + n] * decay + acc[half][a][c];
        }
  }

  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads)
    fin[st_off + i] = sSt[(i / N) * kLdN + i % N];
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D,
                   const float* init, void* y, float* fin, int B, int S,
                   int H, int P, int G, int N, int Q, cudaStream_t stream) {
  static size_t configured = 0;
  const size_t bytes =
      (static_cast<size_t>(kFixedFloats) + 2 * static_cast<size_t>(Q)) *
      sizeof(float);
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  ssd_scan_kernel<T><<<dim3(H, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, init, static_cast<T*>(y), fin, S, H, P,
      G, N, Q);
  return cudaGetLastError();
}

}  // namespace

// init may be null (a zero state). All tensors contiguous on the device.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               const void* init, void* y, void* fin, int B,
                               int S, int H, int P, int G, int N, int Q,
                               int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S <= 0 || Q <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > kMaxP ||
      N <= 0 || N > kMaxN || P % 4 != 0 || N % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* initf = static_cast<const float*>(init);
  float* finf = static_cast<float*>(fin);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, Df, initf, y, finf, B,
                                   S, H, P, G, N, Q, s)
           : launch<float>(x, dtf, Af, Bm, Cm, Df, initf, y, finf, B, S, H,
                           P, G, N, Q, s);
  return static_cast<int>(e);
}
