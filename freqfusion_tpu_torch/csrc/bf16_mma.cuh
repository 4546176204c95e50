// bf16 products on the tensor cores: the helpers that the bf16 versions of
// window attention (window_attention.cu), GRL's mixed attention
// (grl_attention.cu) and the scan's projection (selective_scan.cu) share.
//
// One mma.sync m16n8k16 takes bf16 operands and accumulates in fp32: one
// product where the fp32 kernels run three TF32 ones (tf32_mma.cuh).
// Operands come from shared memory by ldmatrix, which reads 8 x 8 tiles
// of 16-bit values, each row 16 contiguous bytes at a 16-byte aligned
// address; the .trans form hands a row-major [k][n] tile over as the
// column-major B fragment. Self-contained (no other header's helpers), so
// any source can include it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t bf16_smem_addr(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

// c += a b, one m16n8k16 bf16 product, fp32 accumulators. Fragments (g =
// lane / 4, t = lane % 4), two bf16 a register, the lower column (or k)
// in the low half: a0 = A[g][2t, 2t + 1], a1 = A[g + 8][2t, 2t + 1],
// a2 = A[g][2t + 8, 2t + 9], a3 = A[g + 8][2t + 8, 2t + 9]; b0 =
// B[2t, 2t + 1][g], b1 = B[2t + 8, 2t + 9][g]; c = C[g][2t], C[g][2t + 1],
// C[g + 8][2t], C[g + 8][2t + 1] (as m16n8k8's).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 tiles of 16-bit values: lanes 8i .. 8i + 7 give the row
// addresses of tile i, which lands in r[i] (lane g * 4 + t: row g, columns
// 2t and 2t + 1; with .trans: rows 2t and 2t + 1 of column g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(bf16_smem_addr(row)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(bf16_smem_addr(row)));
}

// The A fragment of the 16 x 16 tile at `tile` (rows of `ld` bf16): lane
// l reads row l % 16 at column 8 (l / 16).
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4],
                                      const __nv_bfloat16* tile, int ld) {
  const int l = threadIdx.x % 32;
  ldsm_x4(a, tile + (l % 16) * ld + (l / 16) * 8);
}

// The B fragments of two n-tiles from an [n][k] tile (B^T row-major, as K
// for Q K^T): keys (n) 0-7 and 8-15, k 0-15 from `tile`: b[j][0..1] for
// n-tile j. Lane l reads row 8 (l / 16) + l % 8 at column 8 ((l / 8) % 2).
__device__ __forceinline__ void ldsm_b_nk(uint32_t (&b)[2][2],
                                         const __nv_bfloat16* tile, int ld) {
  const int l = threadIdx.x % 32;
  uint32_t r[4];
  ldsm_x4(r, tile + (8 * (l / 16) + l % 8) * ld + 8 * ((l / 8) % 2));
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// The B fragments of two n-tiles from a [k][n] tile (row-major, as V for
// P V): k 0-15, n 0-7 and 8-15 from `tile`: b[j][0..1] for n-tile j. Lane
// l reads row 8 ((l / 8) % 2) + l % 8 at column 8 (l / 16), transposed.
__device__ __forceinline__ void ldsm_b_kn(uint32_t (&b)[2][2],
                                         const __nv_bfloat16* tile, int ld) {
  const int l = threadIdx.x % 32;
  uint32_t r[4];
  ldsm_x4_trans(r, tile + (8 * ((l / 8) % 2) + l % 8) * ld + 8 * (l / 16));
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// Two floats as bf16x2, each rounded to nearest even, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x rounded to bf16 and back (to nearest even).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The A fragment of P V from S's accumulators of two 8-key n-tiles
// (C[g][2t, 2t + 1] and C[g + 8][..] of keys 0-7, then 8-15), each value
// times `inv` of its row (h 0: row g, 1: row g + 8), rounded to bf16.
__device__ __forceinline__ void p_frag_bf16(uint32_t (&a)[4],
                                           const float (&s0)[4],
                                           const float (&s1)[4],
                                           const float (&inv)[2]) {
  a[0] = pack_bf16(s0[0] * inv[0], s0[1] * inv[0]);
  a[1] = pack_bf16(s0[2] * inv[1], s0[3] * inv[1]);
  a[2] = pack_bf16(s1[0] * inv[0], s1[1] * inv[0]);
  a[3] = pack_bf16(s1[2] * inv[1], s1[3] * inv[1]);
}

// Eight bf16 of a row from device memory, src[0 .. 8), those at or past
// `valid` read as zeros: one 16-byte load where src is 16-byte aligned and
// all eight are valid, else eight independent 2-byte loads. Staging loops
// built on it keep eight loads in flight a thread, not one.
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* src,
                                           int valid) {
  if (valid >= 8 && (reinterpret_cast<size_t>(src) & 15) == 0)
    return __ldg(reinterpret_cast<const uint4*>(src));
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < valid ? __ldg(s + e) : 0u;
  return make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                    v[6] | v[7] << 16);
}

// f applied to each of the eight bf16 of x, each result rounded to bf16.
template <typename F>
__device__ __forceinline__ uint4 map8_bf16(uint4 x, F f) {
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    w[i] = pack_bf16(f(v.x), f(v.y));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace
