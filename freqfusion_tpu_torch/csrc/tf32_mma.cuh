// 3xTF32 products on the tensor cores, cp.async and bulk copies: the
// helpers that window attention (window_attention.cuh), GRL's mixed
// attention (grl_attention.cuh), the fused FFN (fused_mlp.cu), the CAB
// convolutions (cab.cu) and tf32_gemm.cuh share; the bf16 scan
// (selective_scan.cu) takes its ex2, mbarriers and bulk copies.
//
// TF32 keeps 10 mantissa bits, too few for fp32 tolerances, so a product
// runs as three TF32 products: x = hi + lo with hi = x rounded to TF32 (to
// nearest, ties away, as cvt.rna.tf32 does) and lo = x - hi; a product is
// lo*hi + hi*lo + hi*hi (lo*lo, ~2^-22 relative, dropped), accumulated in
// fp32 by mma.sync m16n8k8. PyTorch's TF32 switches do not touch it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x's TF32 rounding as cvt.rna.tf32.f32 does it (to nearest, ties away
// from zero, 10 mantissa bits), in two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi its TF32 rounding, lo = x - hi exactly (|lo| <= 2^-11
// |x|). lo goes to the tensor core as it is, which reads its top 10
// mantissa bits: an error of at most 2^-10 |lo| <= 2^-21 |x| in the lo
// terms, of the order of rounding lo to TF32 first (two more operations).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b, one m16n8k8 TF32 product. Fragments (g = lane / 4, t = lane %
// 4): a = A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]; b = B[t][g],
// B[t + 4][g]; c = C[g][2t], C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[p][mt] += a[mt] b[p] in 3xTF32 for P n-tiles and M m-tiles, both
// operands given split: the two cross terms first, then hi * hi, each pass
// over all P x M tiles so that no product waits on the one just before it.
template <int P, int M>
__device__ __forceinline__ void mma_3xtf32_split(
    float (&c)[P][M][4], const uint32_t (&ah)[M][4],
    const uint32_t (&al)[M][4], const uint32_t (&bh)[P][2],
    const uint32_t (&bl)[P][2]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int mt = 0; mt < M; ++mt)
      mma_tf32(c[p][mt], al[mt], bh[p][0], bh[p][1]);
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int mt = 0; mt < M; ++mt)
      mma_tf32(c[p][mt], ah[mt], bl[p][0], bl[p][1]);
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int mt = 0; mt < M; ++mt)
      mma_tf32(c[p][mt], ah[mt], bh[p][0], bh[p][1]);
}

// The same with b[p] given as fp32 and split here once for all m-tiles.
template <int P, int M>
__device__ __forceinline__ void mma_3xtf32(float (&c)[P][M][4],
                                           const uint32_t (&ah)[M][4],
                                           const uint32_t (&al)[M][4],
                                           const float (&b)[P][2]) {
  uint32_t bh[P][2], bl[P][2];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    split_tf32(b[p][0], bh[p][0], bl[p][0]);
    split_tf32(b[p][1], bh[p][1], bl[p][1]);
  }
  mma_3xtf32_split(c, ah, al, bh, bl);
}

// 2^x (-inf -> 0), for softmaxes taken in exp2 of log2 e-scaled logits.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Copies into shared memory that do not wait: 16 or 4 bytes, or zeros
// where !ok (src-size 0; src must still be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = uint32_t(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = uint32_t(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Bulk copies into shared memory that complete on an mbarrier: one thread
// issues a contiguous copy (16-byte multiples, 16-byte aligned ends); the
// barrier's phase completes when its one arrival (with the bytes to
// expect) is in and every copy charged to it has landed.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes mbarrier inits visible before any thread or copy uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One arrival with no bytes (a consumer releasing a stage, or a producer
// whose stage came by plain stores).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's earlier shared-memory accesses before later
// bulk copies (the async proxy) into the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

}  // namespace
