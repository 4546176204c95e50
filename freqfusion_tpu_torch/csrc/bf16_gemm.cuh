// bf16 products on the tensor cores for the bf16 token attention
// (token_attention.cu, TPU #13). It keeps the JAX kernel's rounding points:
// a product takes bf16 operands and accumulates in fp32 (one mma.sync
// m16n8k16 from bf16_mma.cuh), and every other step runs in fp32, rounded
// to bf16 only where the JAX kernel casts.
//
// bg_gemm_kernel<A, Epi>: out = Epi(A W), a simple multistage GEMM. A block
// is 128 rows x 64 columns, 4 warps of 64 x 32 (4 x 4 m16n8 tiles); K goes
// 32 columns a stage through a three-stage cp.async ring (16-byte copies,
// zero-filled where A has no value). Shared memory rows are padded (A 40,
// W 72 bf16: 80 and 144 bytes), so ldmatrix's eight row reads of a phase
// fall in distinct banks. W is the weight zero-padded to [kp][np] bf16 (kp
// a multiple of 32, np of 64; #13 lays its weights out itself). A comes
// through #13's loader (rows whose starts are 16-byte multiples).
//
// What bounds these products on the H100: the tensor cores (989 TFLOP/s
// bf16, dense); this first version is simple (mma.sync, no TMA or wgmma,
// intermediates through device memory), and chip_smoke.py phase 2 prints
// its time beside that bound. #1, #11, #12, #14, #15 and #16 in bf16 run
// on bf16_wgmma.cuh's wgmma instead.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBgM = 128, kBgN = 64, kBgK = 32, kBgStages = 3;
constexpr int kBgThreads = 128;
constexpr int kBgLdA = kBgK + 8, kBgLdB = kBgN + 8;  // padded smem rows

__device__ __forceinline__ void bg_cp16(bf16* dst, const bf16* src,
                                        bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   bf16_smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void bg_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bg_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float bg_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bg_f(float v) { return v; }

__device__ __forceinline__ bf16 bg_round(float v) {
  return __float2bfloat16_rn(v);
}

// Epi(m, n, v0, v1) gets the fp32 sums of row m, columns n and n + 1 (n
// even) of every 128 x 64 tile, padding rows and columns included: it
// stores what is real.
template <class A, class Epi>
__global__ void __launch_bounds__(kBgThreads)
bg_gemm_kernel(A la, const bf16* __restrict__ w, int ldw, int kp,
               int nblocks, Epi epi) {
  __shared__ __align__(16) bf16 as[kBgStages][kBgM * kBgLdA];
  __shared__ __align__(16) bf16 bs[kBgStages][kBgK * kBgLdB];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;
  const long long m0 = (long long)(blockIdx.x / nblocks) * kBgM;
  const int n0 = int(blockIdx.x % nblocks) * kBgN;
  const int stages = kp / kBgK;

  auto load = [&](int buf, int s) {
    const int k0 = s * kBgK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // A: 128 rows x 4 pieces of 8
      const int id = tid + kBgThreads * i, r = id / 4, q = id % 4;
      const bf16* src = la.src(m0 + r, k0 + 8 * q);
      bg_cp16(&as[buf][r * kBgLdA + 8 * q], src ? src : w, src != nullptr);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // W: 32 rows x 8 pieces of 8
      const int id = tid + kBgThreads * i, r = id / 8, q = id % 8;
      bg_cp16(&bs[buf][r * kBgLdB + 8 * q],
              w + (long long)(k0 + r) * ldw + n0 + 8 * q, true);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kBgStages - 1; ++s) {
    if (s < stages) load(s, s);
    bg_commit();
  }
  for (int s = 0; s < stages; ++s) {
    bg_wait<kBgStages - 2>();  // stage s has landed (this thread's part)
    __syncthreads();           // ... everyone's; stage s - 1 is read
    if (s + kBgStages - 1 < stages)
      load((s + kBgStages - 1) % kBgStages, s + kBgStages - 1);
    bg_commit();
    const bf16* a_s = as[s % kBgStages];
    const bf16* b_s = bs[s % kBgStages];
#pragma unroll
    for (int kk = 0; kk < kBgK / 16; ++kk) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_a(a[mt], a_s + (64 * wr + 16 * mt) * kBgLdA + 16 * kk, kBgLdA);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t pair[2][2];
        ldsm_b_kn(pair, b_s + 16 * kk * kBgLdB + 32 * wc + 16 * np, kBgLdB);
        b[2 * np][0] = pair[0][0];
        b[2 * np][1] = pair[0][1];
        b[2 * np + 1][0] = pair[1][0];
        b[2 * np + 1][1] = pair[1][1];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }
  bg_wait<0>();

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + 32 * wc + 8 * nt + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(m0 + 64 * wr + 16 * mt + g + 8 * h, n, acc[mt][nt][2 * h],
            acc[mt][nt][2 * h + 1]);
    }
}

// Epi(A W) over M rows; W [kp][np] bf16 (rows of ldw, 16-byte aligned).
template <class A, class Epi>
cudaError_t bg_gemm(const A& la, long long M, const bf16* w, int ldw, int kp,
                    int np, const Epi& epi, cudaStream_t stream) {
  if (kp % kBgK || np % kBgN || ldw < np || ldw % 8 ||
      reinterpret_cast<size_t>(w) % 16)
    return cudaErrorInvalidValue;
  const int nblocks = np / kBgN;
  const long long blocks = (M + kBgM - 1) / kBgM * nblocks;
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bg_gemm_kernel<A, Epi><<<unsigned(blocks), kBgThreads, 0, stream>>>(
      la, w, ldw, kp, nblocks, epi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// Epilogues

// out[s][m, c] = bf16(v + bias[n]) for n = s width + c < segs width: a
// product's columns cut into `segs` (at most 3) contiguous [M, width] bf16
// tensors, width even (q | k | v of the qkv projections, or one output).
struct BgSegEpi {
  const bf16* bias;
  bf16* out[3];
  long long M;
  int width, segs;
  __device__ __forceinline__ void operator()(long long m, int n, float v0,
                                             float v1) const {
    if (m >= M || n >= segs * width) return;
    const int s = n / width, c = n - s * width;
    *reinterpret_cast<uint32_t*>(out[s] + m * width + c) =
        pack_bf16(v0 + bg_f(bias[n]), v1 + bg_f(bias[n + 1]));
  }
};

// Bytes a scratch piece takes, rounded up to 256 so the next one is
// aligned for 16-byte copies.
inline long long bg_piece(long long bytes) {
  return (bytes + 255) / 256 * 256;
}

inline int bg_up(int v, int m) { return (v + m - 1) / m * m; }

}  // namespace
