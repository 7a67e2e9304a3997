// The tensor-core products of B4's forward and backward kernels for bf16
// inputs: `mma.sync.m16n8k16` bf16 with fp32 accumulation, bf16 operands
// from padded shared tiles through `ldmatrix` (`.trans` where the natural
// layout is K-major), fp32 operands split in registers into bf16 hi and lo
// parts (split2), and tiles loaded by 16-byte `cp.async`. Also B2's fp32
// route: `mma.sync.m16n8k8` tf32 products of fp32 operands split into a
// tf32 hi and lo part (split_tf32, mma_tf32; layout at mma_tf32).
//
// A warp's accumulator acc[nt] is the 16 x 8 tile at rows m0 + {g, g + 8},
// columns 8 nt + {2t, 2t + 1} (g = lane / 4, t = lane % 4). ldmatrix reads
// row r8 = lane % 8 of matrix mi = lane / 8, at (row, column):
//   A (16 x 16) stored [m][k]: ldsm_x4 at
//     (m0 + r8 + (mi & 1) 8, k0 + (mi >> 1) 8)
//   A stored [k][m]: ldsm_x4_t at (k0 + r8 + (mi >> 1) 8, m0 + (mi & 1) 8)
//   B, two 8-column tiles (16 x 16), stored [n][k]: ldsm_x4 at
//     (n0 + r8 + (mi >> 1) 8, k0 + (mi & 1) 8)
//   B stored [k][n]: ldsm_x4_t at (k0 + r8 + (mi & 1) 8, n0 + (mi >> 1) 8)
// and b[0], b[1] feed the first 8-column tile, b[2], b[3] the second. An
// accumulator's columns 16 kk .. 16 kk + 15 become the next product's A
// fragment over k as {acc[2 kk][0..1], acc[2 kk][2..3], acc[2 kk + 1][0..1],
// acc[2 kk + 1][2..3]}.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {

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

// kRows rows of `cols` values (a multiple of 16 bytes), `stride` elements
// apart in global memory, into shared rows of `ld` by kThreads threads;
// rows at or past `live` are zeros
template <int kRows, int kThreads, typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          size_t stride, int cols,
                                          int live) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = cols / V;
  for (int i = threadIdx.x; i < kRows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * V;
    const bool ok = r < live;
    cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// hi and lo bf16 halves of two fp32 values, packed as an mma operand pair:
// hi = bf16(v), lo = bf16(v - hi), together ~16 significant bits of v
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

// columns 16 kk .. 16 kk + 15 of a warp's fp32 accumulator as the hi and
// lo A fragments of the next product
template <int NT>
__device__ __forceinline__ void split_frag(const float (&acc)[NT][4], int kk,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split2(acc[2 * kk][0], acc[2 * kk][1], hi[0], lo[0]);
  split2(acc[2 * kk][2], acc[2 * kk][3], hi[1], lo[1]);
  split2(acc[2 * kk + 1][0], acc[2 * kk + 1][1], hi[2], lo[2]);
  split2(acc[2 * kk + 1][2], acc[2 * kk + 1][3], hi[3], lo[3]);
}

// D += A B for one warp, tf32 operands, fp32 accumulation. A (16 x 8):
// a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4); B
// (8 x 8): b0 (t, g), b1 (t + 4, g); D (16 x 8) as an m16n8k16
// accumulator: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). The
// tensor cores read the top 19 bits of each operand register.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as hi + lo: hi = x rounded to tf32, to nearest with ties away from zero
// (what cvt.rna.tf32.f32 gives, written as the bit arithmetic that the
// plain emulation repeats), lo = x - hi, exact in fp32; the tensor cores
// read lo truncated to tf32. hi.hi + hi.lo + lo.hi then misses x y by at
// most about 2^-20 of |x y|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float v0, float v1);
template <>
__device__ __forceinline__ void store2<float>(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

}  // namespace repro
