// A bf16 GEMM for Hopper on wgmma, fed by bulk copies through an mbarrier
// ring: the products of the bf16 qkv window attention
// (window_attention_qkv.cu, TPU #11), of the bf16 NAFBlock (nafblock.cu,
// #16), of the bf16 fused FFN (fused_mlp.cu, #14: its own two kernels on
// these pieces, outputs by bulk stores, bw_store), the bf16 CAB's convs
// (cab.cu, #15: A read from a staged halo through shifted descriptors,
// bw_desc_at), GRL's bf16 qkv projection (grl_attention_qkv.cu, #12: its
// own kernel, each output by bulk stores) and the bf16 window attention's
// two products (window_attention.cu, #1: P V with A from registers,
// bw_mma_rs), and the bf16 hierarchical stage 3's six convs (hier.cu, #19:
// the CAB's shifted descriptors over a staged halo, N 8 to 64). bf16
// operands, fp32 accumulation, every other step in fp32 and rounded to
// bf16 only where the JAX kernels cast.
//
// Two kernels. bw_gemm_kernel: a block is WGS consumer warpgroups (128
// threads each, 64 rows apiece: BM = 64 WGS rows) and one producer warp,
// with two operands:
//   A  the block's rows, the whole K, staged once into shared memory in
//      the core-matrix order wgmma reads without swizzle (8 rows x 16
//      bytes a core matrix; for each 16 of K the BM / 8 row groups 256
//      bytes apart, the two halves of K 128 apart: bw_a_off). The
//      consumers stage it themselves, through a loader functor that may
//      transform it on the way. The activations' rows are 8-byte, not
//      16-byte, multiples at DRCT-L's widths (C 180 is 360 bytes), and x
//      and #1's output are made outside this GEMM, so no pass can hand A
//      over in core-matrix order and a bulk copy cannot land a 360-byte
//      row there (TMA tiles need 16-byte row strides too). A is read from
//      device memory once a block (BM K 2 bytes; 40 KB at DRCT-L's
//      widest, K 308 padded to 320, one warpgroup) and reused by every
//      column chunk.
//   B  the weight, laid out once per module into wgmma's order and cached
//      (ops/wgmma.py:weight_layout: [chunk][k16][BN / 8][2][8][8], K
//      padded to 32 and N to whole chunks of BN columns with zeros). The
//      producer warp streams it in stages of 32 of K (BN x 64 bytes, one
//      cp.async.bulk each) through a full/empty mbarrier ring; the
//      consumers wait on `full`, issue wgmma.mma_async m64nBNk16 (A and B
//      from shared memory by descriptor), and release a stage to `empty`
//      once the wgmma that read it has retired. No block barrier in the K
//      loop.
// The columns go BN (64, 96 or 128) at a time; an epilogue functor takes
// each chunk's fp32 sums through a shared-memory tile (bw_epilogue).
// bw_tiled_kernel streams A too, from a tiled layout that the pass making
// A writes, 128 rows x one chunk a block: for few rows and wide products.
//
// What bounds them on the H100: the tensor cores (989 TFLOP/s bf16,
// dense) for the products; #11's projections in practice by their q, k, v
// stores, the NAFBlock at C <= 256 by its bytes (nafblock.cu keeps its
// intermediates on chip there) and above by the products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

// Timing marks for csrc/bench/wgmma_variants.py: with BW_PROFILE defined,
// thread 0 of block b stores clock64() at mark k into bw_prof[96 b + k]
// (blocks below 8192; marks 0-29 the NAFBlock's gate kernel, 32-61 its
// pass B, 64-93 bw_gemm_kernel), and the global timer (ns) at its start
// and end into the group's last two (BW_SPAN); compiled out of the
// package.
#ifdef BW_PROFILE
__device__ long long bw_prof[8192 * 96];
__device__ __forceinline__ long long bw_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define BW_MARK(k)                                                     \
  do {                                                                 \
    if (threadIdx.x == 0 && blockIdx.x < 8192 && (k) < 96)             \
      bw_prof[blockIdx.x * 96 + (k)] = clock64();                      \
  } while (0)
#define BW_SPAN(k)                                                     \
  do {                                                                 \
    if (threadIdx.x == 0 && blockIdx.x < 8192)                         \
      bw_prof[blockIdx.x * 96 + (k)] = bw_ns();                        \
  } while (0)
#else
#define BW_MARK(k) ((void)0)
#define BW_SPAN(k) ((void)0)
#endif

constexpr int kBwStages = 4;   // the weight ring's stages (at most 8)
constexpr int kBwK = 32;       // K a stage: two k16 steps
constexpr int kBwHead = 128;   // the ring's barriers, at the head of smem
constexpr int kBwBatch = 8;    // staging loads in flight a thread

// A wgmma shared-memory descriptor, no swizzle: the start address, the
// byte offset between the two core matrices along K (128) and between
// 8-row groups (256), in 16-byte units.
__device__ __forceinline__ uint64_t bw_desc(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) |
         (uint64_t(256 >> 4) << 32);
}

__device__ __forceinline__ void bw_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void bw_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void bw_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// The consumers' barrier (named barrier 1; the producer warp never joins).
__device__ __forceinline__ void bw_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}


// d (+)= A B for one 64 x N tile and k 16 (bf16 operands, fp32 sums), A
// and B in shared memory by their descriptors, both K-major; d is taken
// as zero where `accumulate` is 0. d[4 j + 2 h + e] is row 16 (warp % 4)
// + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e.
__device__ __forceinline__ void bw_mma_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void bw_mma_n8(float (&d)[4], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void bw_mma_n16(float (&d)[8], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void bw_mma_n32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void bw_mma_n48(float (&d)[24], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void bw_mma_n96(float (&d)[48], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void bw_mma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void bw_mma(float (&d)[BN / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  static_assert(BN == 8 || BN == 16 || BN == 32 || BN == 48 || BN == 64 ||
                    BN == 96 || BN == 128,
                "instantiated widths");
  if constexpr (BN == 8) bw_mma_n8(d, da, db, accumulate);
  else if constexpr (BN == 16) bw_mma_n16(d, da, db, accumulate);
  else if constexpr (BN == 32) bw_mma_n32(d, da, db, accumulate);
  else if constexpr (BN == 48) bw_mma_n48(d, da, db, accumulate);
  else if constexpr (BN == 64) bw_mma_n64(d, da, db, accumulate);
  else if constexpr (BN == 96) bw_mma_n96(d, da, db, accumulate);
  else bw_mma_n128(d, da, db, accumulate);
}

// d (+)= A B for one 64 x N tile and k 16, A from registers (this thread's
// A fragment: a[0] = A[g][2t, 2t + 1], a[1] = A[g + 8][..], a[2] =
// A[g][2t + 8, 2t + 9], a[3] = A[g + 8][..] of the warp's 16 rows, g =
// lane / 4, t = lane % 4: the layout of the sums of two 8-column n-tiles,
// so an S tile's accumulators become P's fragments in place), B in shared
// memory by its descriptor, MN-major (tnspB = 1: a [k][n] matrix with n
// contiguous; core matrices of 8 k-rows x 16 bytes, the n groups sbo
// apart, the k groups lbo apart, as CUTLASS's Major-MN INTERLEAVE layout).
// d is taken as zero where `accumulate` is 0. The bf16 window attention's
// P V (window_attention.cu, V read as it was staged, key by key).

__device__ __forceinline__ void bw_mma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void bw_mma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void bw_mma_rs_n48(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void bw_mma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void bw_mma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void bw_mma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void bw_mma_rs_n112(float (&d)[56],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void bw_mma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void bw_mma_rs(float (&d)[N / 2],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  static_assert(N % 16 == 0 && N >= 16 && N <= 128, "instantiated widths");
  if constexpr (N == 16) bw_mma_rs_n16(d, a, db, accumulate);
  else if constexpr (N == 32) bw_mma_rs_n32(d, a, db, accumulate);
  else if constexpr (N == 48) bw_mma_rs_n48(d, a, db, accumulate);
  else if constexpr (N == 64) bw_mma_rs_n64(d, a, db, accumulate);
  else if constexpr (N == 80) bw_mma_rs_n80(d, a, db, accumulate);
  else if constexpr (N == 96) bw_mma_rs_n96(d, a, db, accumulate);
  else if constexpr (N == 112) bw_mma_rs_n112(d, a, db, accumulate);
  else if constexpr (N == 128) bw_mma_rs_n128(d, a, db, accumulate);
}

// Moves this warpgroup's register budget to N a thread (a multiple of 8),
// every warp of the warpgroup at once: a producer warpgroup gives its
// registers up (dec) for the consumers' sums (inc). The budgets of a
// block must fit what its launch bounds gave it (384 threads at one block
// an SM: 168 a thread; 40 for the producer, 232 for two consumers).
template <int N>
__device__ __forceinline__ void bw_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void bw_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// A descriptor with its own strides (no swizzle): `lbo` bytes between the
// two core matrices along K, `sbo` between 8-row groups (16-byte
// multiples). The CAB's convs read a halo tap with lbo = the halo's
// pixels x 16 and sbo = 128 (8 consecutive pixels).
__device__ __forceinline__ uint64_t bw_desc_at(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32);
}

// A block's output tile from shared memory to device memory as one bulk
// copy (the async proxy: fence_proxy_async after the tile's stores, then
// a barrier, before one thread issues it); bytes and both addresses
// 16-byte multiples. bw_store_commit closes a group; bw_store_wait_read<N>
// waits until at most N groups still read shared memory (the tile may be
// written again), bw_store_wait<0> until every store is done.
__device__ __forceinline__ void bw_store(void* dst, const void* src,
                                         uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bw_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bw_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bw_store_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above a wait.
template <int N>
__device__ __forceinline__ void bw_fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Byte offset of row r's 8-column group q in a staged A of bm rows.
__device__ __forceinline__ int bw_a_off(int r, int q, int bm) {
  return (q >> 1) * bm * 32 + (r >> 3) * 256 + (q & 1) * 128 + (r & 7) * 16;
}

// The weight ring, as each side sees it: `it` counts the stages this side
// has passed through it.
struct BwRing {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* buf;
  int bytes;   // a stage: BN x 64
  int stages;  // the ring's depth, at most 8 (the head holds 16 barriers)
  int it;
};

__device__ __forceinline__ BwRing bw_ring(unsigned char* smem, int bytes,
                                          int consumer_warps,
                                          int stages = kBwStages) {
  BwRing r{reinterpret_cast<uint64_t*>(smem),
           reinterpret_cast<uint64_t*>(smem) + 8, smem + kBwHead, bytes,
           stages, 0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], consumer_warps);  // one arrival a warp
    }
    mbar_init_fence();
  }
  return r;
}

// The producer (one thread): n stages of r.bytes, contiguous from src.
__device__ __forceinline__ void bw_produce(BwRing& r, const void* src,
                                           int n) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  for (int i = 0; i < n; ++i, ++r.it) {
    const int slot = r.it % r.stages;
    mbar_wait(&r.empty[slot], ((r.it / r.stages) & 1) ^ 1);
    mbar_arrive_expect_tx(&r.full[slot], r.bytes);
    bulk_copy(r.buf + slot * r.bytes, s + (long long)i * r.bytes, r.bytes,
              &r.full[slot]);
  }
}

// One column chunk's sums: acc = A B over nst stages (K = 32 nst) of the
// ring. a: this warpgroup's 64 rows of the staged A (bm rows in all).
template <int BN>
__device__ __forceinline__ void bw_chunk(float (&acc)[BN / 2],
                                         const unsigned char* a, int bm,
                                         int nst, BwRing& r) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  bw_fence_acc(acc);
  for (int s = 0; s < nst; ++s) {
    const int it = r.it + s, slot = it % r.stages;
    mbar_wait(&r.full[slot], (it / r.stages) & 1);
    bw_fence();
    const unsigned char* b = r.buf + slot * r.bytes;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      bw_mma<BN>(acc, bw_desc(a + (2 * s + k) * bm * 32),
                 bw_desc(b + k * BN * 32), s > 0 || k > 0);
    bw_commit();
    if (s > 0) {  // the stage before this one is read: release it
      bw_wait<1>();
      if (lane == 0) mbar_arrive(&r.empty[(it - 1) % r.stages]);
    }
  }
  bw_wait<0>();
  bw_fence_acc(acc);
  if (lane == 0) mbar_arrive(&r.empty[(r.it + nst - 1) % r.stages]);
  r.it += nst;
}

// f(j, h, row, col) for each pair of a chunk's sums this thread holds,
// acc[4 j + 2 h] and acc[4 j + 2 h + 1]: row in [0, 64 WGS) of the block,
// col (even) in [0, BN) of the chunk.
template <int BN, class F>
__device__ __forceinline__ void bw_frag(F f) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = 16 * w + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) f(j, h, row + 8 * h, 8 * j + col);
}

// f(row, col, v0, v1) for each pair of a chunk's sums this thread holds.
template <int BN, class F>
__device__ __forceinline__ void bw_each(const float (&acc)[BN / 2], F f) {
  bw_frag<BN>([&](int j, int h, int row, int col) {
    f(row, col, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  });
}

// Column vectors (biases, scales: bf16, n of them) as fp32 in shared
// memory, zeros up to np: the epilogues read them there, not from device
// memory between their stores.
__device__ __forceinline__ void bw_vector(float* dst,
                                          const __nv_bfloat16* src, int n,
                                          int np, int tid, int threads) {
  for (int i = tid; i < np; i += threads)
    dst[i] = i < n ? __bfloat162float(src[i]) : 0.f;
}

// Stage A: bm rows x kp columns into `as`, f(r, q) giving the 8 bf16 of
// row r, columns 8q .. 8q + 7 (zeros past the data). Item e is row
// 8 i + e % 8 of group q, so eight lanes fill one core matrix (128
// contiguous bytes) and a warp's stores meet no bank twice; kBwBatch
// items' loads are in flight a thread.
template <class F>
__device__ __forceinline__ void bw_stage(unsigned char* as, int bm, int kp,
                                         int tid, int threads, F f) {
  const int kq = kp / 8, items = bm * kq;
  for (int e0 = tid; e0 < items; e0 += threads * kBwBatch) {
    uint4 v[kBwBatch];
#pragma unroll
    for (int b = 0; b < kBwBatch; ++b) {
      const int e = e0 + threads * b;
      v[b] = e < items ? f(8 * ((e >> 3) / kq) + (e & 7), (e >> 3) % kq)
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int b = 0; b < kBwBatch; ++b) {
      const int e = e0 + threads * b;
      if (e < items)
        *reinterpret_cast<uint4*>(
            as + bw_a_off(8 * ((e >> 3) / kq) + (e & 7), (e >> 3) % kq,
                          bm)) = v[b];
    }
  }
}

// Eight bf16 at p, those at or past `valid` zeros: 16- or 8-byte loads
// where p allows (rows of C % 8 == 4 alternate between the two), else
// 2-byte ones (the last group of a row whose C is no multiple of 8).
__device__ __forceinline__ uint4 bw_load8(const __nv_bfloat16* p,
                                          int valid) {
  if (valid <= 0) return make_uint4(0, 0, 0, 0);
  const size_t a = reinterpret_cast<size_t>(p);
  if (valid >= 8 && (a & 15) == 0)
    return __ldg(reinterpret_cast<const uint4*>(p));
  if (valid >= 8 && (a & 7) == 0) {
    const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p));
    const uint2 hi = __ldg(reinterpret_cast<const uint2*>(p) + 1);
    return make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
  return load8_bf16(p, valid);
}

// A from a row-major bf16 matrix [M, K] (rows of any even K): row m0 + r.
struct BwRows {
  const __nv_bfloat16* a;
  long long M;
  int K;
  __device__ __forceinline__ void stage(unsigned char* as, unsigned char*,
                                        long long m0, int bm, int kp,
                                        int tid, int threads) const {
    bw_stage(as, bm, kp, tid, threads, [&](int r, int q) {
      const long long m = m0 + r;
      return m < M ? bw_load8(a + m * K + 8 * q, K - 8 * q)
                   : make_uint4(0, 0, 0, 0);
    });
  }
};

// Eight values of a row as fp32 (bf16 widened), those at or past `valid`
// zeros.
__device__ __forceinline__ void bw_get8(float (&v)[8],
                                        const __nv_bfloat16* p, int valid) {
  const uint4 u = bw_load8(p, valid);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void bw_get8(float (&v)[8], const float* p,
                                        int valid) {
  if (valid >= 8 && (reinterpret_cast<size_t>(p) & 15) == 0) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = i < valid ? p[i] : 0.f;
}

__device__ __forceinline__ void bw_get8(float (&v)[8], const uint4* p) {
  const uint4 u = *p;
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 bw_pack8(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ float bw_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float bw_f(float v) { return v; }

// A = bf16(LN(row) s + b) of rows already staged raw (bf16) in `as` (kp
// columns, zeros past C): each row's mean and 1 / std from shared memory
// (two threads a row, threads = 2 bm), then each value normalised in
// place; rows where inside(r) is false stay zero. lns, lnb: s and b as
// fp32 in shared memory. (From shared memory, the rows are read from
// device memory once, by 16-byte loads.)
template <class In>
__device__ __forceinline__ void bw_ln_inplace(unsigned char* as,
                                              float2* stats, int bm, int kp,
                                              int C, float eps,
                                              const float* lns,
                                              const float* lnb, int tid,
                                              int threads, In inside) {
  {
    const int r = tid >> 1, h = tid & 1, kq = kp / 8;
    const int q0 = h * (kq / 2), q1 = q0 + kq / 2;
    float v[8], s = 0.f;
    for (int q = q0; q < q1; ++q) {
      bw_get8(v, reinterpret_cast<const uint4*>(as + bw_a_off(r, q, bm)));
#pragma unroll
      for (int i = 0; i < 8; ++i) s += v[i];
    }
    s += __shfl_xor_sync(~0u, s, 1);
    const float mu = s / C;
    float qs = 0.f;
    for (int q = q0; q < q1; ++q) {
      bw_get8(v, reinterpret_cast<const uint4*>(as + bw_a_off(r, q, bm)));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = 8 * q + i < C ? v[i] - mu : 0.f;
        qs += d * d;
      }
    }
    qs += __shfl_xor_sync(~0u, qs, 1);
    if (!h) stats[r] = make_float2(mu, rsqrtf(qs / C + eps));
  }
  bw_sync(threads);
  const int kq = kp / 8, items = bm * kq;
  for (int e = tid; e < items; e += threads) {
    const int r = 8 * ((e >> 3) / kq) + (e & 7), q = (e >> 3) % kq;
    uint4* p = reinterpret_cast<uint4*>(as + bw_a_off(r, q, bm));
    float v[8];
    bw_get8(v, p);
    const float2 st = stats[r];
    const bool in = inside(r);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * q + i;
      v[i] = in && c < C ? (v[i] - st.x) * st.y * lns[c] + lnb[c] : 0.f;
    }
    *p = bw_pack8(v);
  }
}

// Dynamic shared memory of a block: the ring's barriers, the ring, A (bm
// x kp bf16), then `extra` bytes.
inline int bw_smem_bytes(int bm, int kp, int bn, int extra,
                         int stages = kBwStages) {
  return kBwHead + stages * bn * 64 + bm * kp * 2 + extra;
}

__host__ __device__ inline int bw_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// #11's chunk width of N columns (ops/wgmma.py:chunk_cols): the lesser
// padding of 96 and 64, 96 on a tie.
inline int bw_cols(int n) { return bw_up(n, 64) < bw_up(n, 96) ? 64 : 96; }

// Let a kernel take `bytes` of dynamic shared memory (set once a device,
// again only for more).
template <typename K>
cudaError_t bw_allow(K kernel, int bytes, int (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return err;
}

// The epilogues take a chunk's sums through shared memory: each thread
// puts its fragments' pairs in a tile (epi.stage), then the threads walk
// the tile row by row, consecutive lanes on consecutive column pairs, so
// that the epilogue's loads and stores are coalesced (stored in fragment
// order, eight rows a warp instruction, #11's q | k | v took 4-5x the
// products' time). An epilogue has:
//   kVecs, vec(k), n(): column vectors staged as fp32 (bw_vector), np
//     floats each (vs);
//   stage(n, v0, v1, vs, np): a tile entry (uint32_t or float2) from the
//     sums of columns n and n + 1;
//   load(m, n): what it reads of row m, columns n and n + 1 (read-only
//     data, by __ldg), eight pairs' loads issued before their stores;
//   (m, n, t, vs, np, pre): row m's columns n and n + 1 (n even), the
//     padding's included (it stores what is real).
struct BwNone {};

// A tile row's stride, in entries: a warp's fragment stores (8 rows x 4
// pairs) meet no bank twice (4-byte entries; 8-byte ones, stored a half
// warp at a time, neither).
template <int BN>
__host__ __device__ constexpr int bw_tile_stride() {
  return BN / 2 + 4;
}

// Chunk c's sums (acc, this thread's fragments of the block's kBm rows
// from m0) through `tile` to the epilogue; kThreads consumer threads.
template <int kBm, int kThreads, int BN, class Epi, class Tile>
__device__ __forceinline__ void bw_epilogue(const float (&acc)[BN / 2],
                                            Tile* tile, const Epi& epi,
                                            const float* vs, int np,
                                            long long m0, int c, int tid) {
  constexpr int kTs = bw_tile_stride<BN>();
  constexpr int kPer = kBm * (BN / 2) / kThreads;  // pairs a thread
  using Pre = decltype(epi.load(0LL, 0));
  bw_each<BN>(acc, [&](int row, int col, float v0, float v1) {
    tile[row * kTs + col / 2] = epi.stage(c * BN + col, v0, v1, vs, np);
  });
  bw_sync(kThreads);
#pragma unroll
  for (int k0 = 0; k0 < kPer; k0 += 8) {  // 8 pairs' loads, then stores
    Pre pre[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = tid + kThreads * (k0 + k), row = e / (BN / 2);
      pre[k] = epi.load(m0 + row, c * BN + 2 * (e % (BN / 2)));
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = tid + kThreads * (k0 + k), row = e / (BN / 2);
      const int u = e % (BN / 2);
      epi(m0 + row, c * BN + 2 * u, tile[row * kTs + u], vs, np, pre[k]);
    }
  }
}

// out = Epi(A W) over M rows, A staged whole: grid of ceil(M / BM)
// blocks, each staging its rows through the loader (ld.stage(as,
// scratch, m0, bm, kp, tid, threads); its scratch, `ld_extra` bytes,
// last) and running every chunk of W's layout.
struct BwGemm {
  const void* w;  // the layout: nch chunks x kp / 32 stages of bn x 64 B
  long long M;
  int kp, nch;
};

template <int WGS, int BN, class Ld, class Epi>
__global__ void __launch_bounds__(128 * WGS + 32)
bw_gemm_kernel(const BwGemm g, const Ld ld, const Epi epi) {
  extern __shared__ __align__(128) unsigned char bw_smem[];
  constexpr int kBm = 64 * WGS, kThreads = 128 * WGS;
  using Tile = decltype(epi.stage(0, 0.f, 0.f, nullptr, 0));
  BwRing r = bw_ring(bw_smem, BN * 64, 4 * WGS);
  unsigned char* as = bw_smem + kBwHead + kBwStages * BN * 64;
  Tile* tile = reinterpret_cast<Tile*>(as + kBm * g.kp * 2);
  float* vs = reinterpret_cast<float*>(tile + kBm * bw_tile_stride<BN>());
  const int np = g.nch * BN;
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid >= kThreads) {
    if (tid == kThreads) bw_produce(r, g.w, g.nch * (g.kp / kBwK));
    return;
  }
  const long long m0 = (long long)blockIdx.x * kBm;
  BW_MARK(64);
  BW_SPAN(94);
#pragma unroll
  for (int k = 0; k < Epi::kVecs; ++k)
    bw_vector(vs + k * np, epi.vec(k), epi.n(), np, tid, kThreads);
  ld.stage(as, reinterpret_cast<unsigned char*>(vs + Epi::kVecs * np), m0,
           kBm, g.kp, tid, kThreads);
  fence_proxy_async();  // the staged A, before wgmma reads it
  bw_sync(kThreads);
  BW_MARK(65);
  const unsigned char* a = as + (tid >> 7) * 2048;
  for (int c = 0; c < g.nch; ++c) {
    float acc[BN / 2];
    bw_chunk<BN>(acc, a, kBm, g.kp / kBwK, r);
    BW_MARK(66 + 3 * (c & 7));
    bw_epilogue<kBm, kThreads, BN>(acc, tile, epi, vs, np, m0, c, tid);
    BW_MARK(68 + 3 * (c & 7));
    bw_sync(kThreads);  // the tile read before the next chunk's fill
  }
  BW_SPAN(95);
}

template <int WGS, int BN, class Ld, class Epi>
cudaError_t bw_gemm(const BwGemm& g, const Ld& ld, const Epi& epi,
                    int ld_extra, cudaStream_t stream) {
  static int allowed[64] = {};
  using Tile = decltype(epi.stage(0, 0.f, 0.f, nullptr, 0));
  const int tile = 64 * WGS * bw_tile_stride<BN>() * int(sizeof(Tile));
  const int bytes = bw_smem_bytes(
      64 * WGS, g.kp, BN, tile + Epi::kVecs * g.nch * BN * 4 + ld_extra);
  const long long blocks = (g.M + 64 * WGS - 1) / (64 * WGS);
  if (g.kp % kBwK || bytes > 227 * 1024 || blocks > 0x7fffffffLL ||
      reinterpret_cast<size_t>(g.w) % 16)
    return cudaErrorInvalidValue;
  if (blocks <= 0) return cudaSuccess;
  cudaError_t err =
      bw_allow(bw_gemm_kernel<WGS, BN, Ld, Epi>, bytes, allowed);
  if (err != cudaSuccess) return err;
  bw_gemm_kernel<WGS, BN, Ld, Epi>
      <<<unsigned(blocks), 128 * WGS + 32, bytes, stream>>>(g, ld, epi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// Both operands streamed, for few rows and wide products (the NAFBlock
// above C 256: 10,752 rows at C 1024, where a block a 64-row slab of A
// leaves most SMs idle). A lies in device memory in the tiled order
// (bw_tiled_off: for each 128-row block and each 32 of K, 8 KB in the
// core-matrix order of a staged A), written so by the pass that makes it;
// a block is 128 rows (two consumer warpgroups) x one chunk of BN
// columns, its producer bulk-copying A's 8 KB and W's BN x 64 bytes a
// stage into one ring slot. The epilogue's tile lies in the ring once the
// products are done.
constexpr int kBtStages = 5;

// Byte offset of row m, column k (< kp) of A in the tiled order.
__device__ __forceinline__ long long bw_tiled_off(long long m, int k,
                                                  int kp) {
  return ((m >> 7) * (kp / kBwK) + k / kBwK) * 8192 +
         bw_a_off(int(m & 127), (k % kBwK) >> 3, 128) + (k & 7) * 2;
}

struct BwTiled {
  const void* a;  // [ceil(M / 128)][kp / 32][8192 B]
  const void* w;  // the layout: nch chunks x kp / 32 stages of bn x 64 B
  long long M;
  int kp, nch;
};

template <int BN>
__host__ __device__ constexpr int bw_tiled_stage() {
  return 8192 + BN * 64;
}

template <int BN, class Epi>
__global__ void __launch_bounds__(288)
bw_tiled_kernel(const BwTiled g, const Epi epi) {
  extern __shared__ __align__(128) unsigned char bw_smem[];
  constexpr int kStage = bw_tiled_stage<BN>();
  using Tile = decltype(epi.stage(0, 0.f, 0.f, nullptr, 0));
  static_assert(128 * bw_tile_stride<BN>() * sizeof(Tile) <=
                    kBtStages * kStage,
                "the tile lies in the ring");
  BwRing r = bw_ring(bw_smem, kStage, 8, kBtStages);
  Tile* tile = reinterpret_cast<Tile*>(r.buf);
  float* vs = reinterpret_cast<float*>(r.buf + kBtStages * kStage);
  const int np = g.nch * BN, nst = g.kp / kBwK, c = blockIdx.y;
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid >= 256) {
    if (tid == 256) {
      const unsigned char* a =
          static_cast<const unsigned char*>(g.a) + blockIdx.x * 8192LL * nst;
      const unsigned char* w = static_cast<const unsigned char*>(g.w) +
                               (long long)c * nst * BN * 64;
      for (int i = 0; i < nst; ++i, ++r.it) {
        const int slot = r.it % r.stages;
        mbar_wait(&r.empty[slot], ((r.it / r.stages) & 1) ^ 1);
        mbar_arrive_expect_tx(&r.full[slot], kStage);
        bulk_copy(r.buf + slot * kStage, a + i * 8192LL, 8192,
                  &r.full[slot]);
        bulk_copy(r.buf + slot * kStage + 8192, w + (long long)i * BN * 64,
                  BN * 64, &r.full[slot]);
      }
    }
    return;
  }
  const long long m0 = (long long)blockIdx.x * 128;
#pragma unroll
  for (int k = 0; k < Epi::kVecs; ++k)
    bw_vector(vs + k * np, epi.vec(k), epi.n(), np, tid, 256);
  const int lane = tid & 31, wg = tid >> 7;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  bw_fence_acc(acc);
  for (int s = 0; s < nst; ++s) {
    const int slot = s % r.stages;
    mbar_wait(&r.full[slot], (s / r.stages) & 1);
    bw_fence();
    const unsigned char* st = r.buf + slot * kStage;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      bw_mma<BN>(acc, bw_desc(st + k * 4096 + wg * 2048),
                 bw_desc(st + 8192 + k * BN * 32), s > 0 || k > 0);
    bw_commit();
    if (s > 0) {  // the stage before this one is read: release it
      bw_wait<1>();
      if (lane == 0) mbar_arrive(&r.empty[(s - 1) % r.stages]);
    }
  }
  bw_wait<0>();
  bw_fence_acc(acc);
  bw_sync(256);  // every product done: the ring is free for the tile
  bw_epilogue<128, 256, BN>(acc, tile, epi, vs, np, m0, c, tid);
}

template <int BN, class Epi>
cudaError_t bw_tiled(const BwTiled& g, const Epi& epi, cudaStream_t stream) {
  static int allowed[64] = {};
  const int bytes =
      kBwHead + kBtStages * bw_tiled_stage<BN>() + Epi::kVecs * g.nch * BN * 4;
  const long long blocks = (g.M + 127) / 128;
  if (g.kp % kBwK || bytes > 227 * 1024 || blocks > 0x7fffffffLL ||
      g.nch > 65535 ||
      (reinterpret_cast<size_t>(g.w) | reinterpret_cast<size_t>(g.a)) % 16)
    return cudaErrorInvalidValue;
  if (blocks <= 0) return cudaSuccess;
  cudaError_t err = bw_allow(bw_tiled_kernel<BN, Epi>, bytes, allowed);
  if (err != cudaSuccess) return err;
  bw_tiled_kernel<BN, Epi>
      <<<dim3(unsigned(blocks), unsigned(g.nch)), 288, bytes, stream>>>(g,
                                                                          epi);
  return cudaGetLastError();
}

}  // namespace
