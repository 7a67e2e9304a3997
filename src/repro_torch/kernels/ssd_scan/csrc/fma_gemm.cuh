// The fp32 product of B4's forward and backward kernels, for fp32 inputs
// only (their bf16 paths run every product on the tensor cores,
// mma_sync.cuh): FMAs from shared tiles, each warp's accumulator kept in
// the mma.sync fragment layout, so that one epilogue serves fp32 and
// tensor-core products alike.
#pragma once

namespace repro {

// acc += A B over k < K for the column tiles below n_live. A warp's
// accumulator acc[nt] is the 16 x 8 tile at rows m0 + {g, g + 8}, columns
// 8 nt + {2t, 2t + 1} (g = lane / 4, t = lane % 4). A is (M, K) stored
// [m][k] (kAKM false) or [k][m] (true), B is (K, N) stored [n][k] (kBKN
// false) or [k][n] (true); with a_scale, A(m, k) is scaled by a_scale[k].
template <bool kAKM, bool kBKN, int NT>
__device__ __forceinline__ void gemm(float (&acc)[NT][4], const float* a,
                                     int lda, const float* b, int ldb,
                                     int m0, int K, int n_live,
                                     const float* a_scale = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float a0 = kAKM ? a[k * lda + m0 + g] : a[(m0 + g) * lda + k];
    float a1 = kAKM ? a[k * lda + m0 + g + 8] : a[(m0 + g + 8) * lda + k];
    if (a_scale != nullptr) {
      a0 *= a_scale[k];
      a1 *= a_scale[k];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = 8 * nt + 2 * t;
      if (8 * nt < n_live) {
        float b0, b1;
        if constexpr (kBKN) {
          const float2 v = *reinterpret_cast<const float2*>(b + k * ldb + n);
          b0 = v.x;
          b1 = v.y;
        } else {
          b0 = b[n * ldb + k];
          b1 = b[(n + 1) * ldb + k];
        }
        acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
        acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
        acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
        acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
      }
    }
  }
}

}  // namespace repro
