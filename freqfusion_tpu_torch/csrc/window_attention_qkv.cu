// DRCT window attention with its qkv and output projections, fp32:
//     out = (softmax(q k^T * scale + bias + mask) v) Wproj + bproj,
//     q | k | v = x Wqkv + bqkv
// per ws x ws window and head, straight from NHWC x.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_attention.py:
// fused_window_attention_qkv_nhwc (:709), which FREQFUSION_ATTN_QKV=1
// routes DRCT-L's 60 Swin blocks through
// (freqfusion_tpu/models/drct.py:116).
//
// What bounds it on the H100: operations. At DRCT-L's widths (C = 180..308,
// window 16) a pixel costs 8 C^2 FLOPs of projections and 4 * 256 C of
// attention, 9.5 ms a call at 336x512 on the fp32 cores (67 TFLOP/s);
// the bytes of x and out are 0.3 ms of it at 3.35 TB/s.
//
// Design: three launches on the caller's stream, each written here or in
// window_attention.cuh, with no library call:
//   1. qkv = x Wqkv + bqkv, a register-tiled SGEMM into a [B, H, W, 3C]
//      scratch;
//   2. the window attention of window_attention.cuh (3xTF32 on the
//      tensor cores, a cp.async K/V ring), reading q, k and v as the
//      column thirds of that scratch (row stride 3 C), into a
//      [B, H, W, C] scratch;
//   3. out = attn Wproj + bproj, the same SGEMM.
// The TPU kernel keeps q/k/v in VMEM to save their HBM round trip; here
// that round trip (write and re-read 4 C floats a pixel, about 0.5 ms a
// call at C = 308) is a twentieth of the operations' bound, while fusing
// the projections into the attention block would cost it the shared
// memory its Q tile and K/V ring hold (one head's K/V at hd 122 alone is
// 250 KB, over a block's 227 KB; one window's x at C 308 is 315 KB). So the projections stay separate launches, and the GEMM is
// the part to make fast.
//
// The SGEMM: 128 x 128 output tiles, 256 threads, each thread 8 x 8
// outputs as two 4 x 4 quadrants (rows 4 ty + {0..3, 64..67}, columns
// 4 tx + {0..3, 64..67}), so a depth step reads four float4s from shared
// memory for 64 FMAs. Depth tiles of 8 are double-buffered through
// registers, one barrier a tile; A is stored transposed with a row stride
// of 132 so the transposing stores hit distinct banks. Ragged M, N and K
// are zero-filled on load and masked on store. Tensor cores for the
// SGEMM (wgmma, TF32 or bf16) are left to later versions.

#include "window_attention.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8;
constexpr int kGThreads = 256;
constexpr int kGLd = kBM + 4;

// c[m][n] = sum_k a[m][k] b[k][n] + bias[n] for m < M, n < N; row-major
// with leading dimensions lda, ldb, ldc.
__global__ void __launch_bounds__(kGThreads, 2)
gemm_bias_kernel(const float* __restrict__ a, int lda,
                 const float* __restrict__ b, int ldb,
                 const float* __restrict__ bias, float* __restrict__ c,
                 int ldc, int M, int N, int K) {
  __shared__ __align__(16) float As[2][kBK][kGLd];
  __shared__ __align__(16) float Bs[2][kBK][kGLd];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  // loads: A as (row tid / 8 + 32 q, depth tid % 8), B as (depth
  // tid / 128 + 2 q, column tid % 128): 8 and 128 consecutive floats
  const int ar = tid >> 3, ak = tid & 7;
  const int bk = tid >> 7, bn = tid & 127;
  float ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long row = m0 + ar + 32 * q;
      const int kk = k0 + ak;
      ra[q] = row < M && kk < K ? a[row * lda + kk] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = k0 + bk + 2 * q, col = n0 + bn;
      rb[q] = kk < K && col < N ? b[(long long)kk * ldb + col] : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 4; ++q) As[buf][ak][ar + 32 * q] = ra[q];
#pragma unroll
    for (int q = 0; q < 4; ++q) Bs[buf][bk + 2 * q][bn] = rb[q];
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // buf ^ 1 was last read before the previous barrier
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (col < N) c[row * ldc + col] = acc[i][j] + bias[col];
    }
  }
}

cudaError_t gemm_bias(const float* a, int lda, const float* b, int ldb,
                      const float* bias, float* c, int ldc, long long M,
                      int N, int K, cudaStream_t stream) {
  const long long mt = (M + kBM - 1) / kBM;
  if (mt > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(unsigned(mt), unsigned((N + kBN - 1) / kBN));
  gemm_bias_kernel<<<grid, kGThreads, 0, stream>>>(a, lda, b, ldb, bias, c,
                                                   ldc, int(M), N, K);
  return cudaGetLastError();
}

}  // namespace

// x [B, H, W, Cin]; wqkv [Cin, 3C] (q | k | v columns), bqkv [3C];
// wproj [C, C] ([in, out]), bproj [C]; bias [heads, N, N]; mask [nW, N, N]
// or null; qkv [B, H, W, 3C] and attn [B, H, W, C] scratch; out
// [B, H, W, C]. All fp32 contiguous; H % ws == 0 == W % ws. hdp and vec:
// the attention's plan (ops/attention.py:plan_window_attention, row
// stride 3 C).
extern "C" int ff_window_attention_qkv_nhwc(
    const float* x, const float* wqkv, const float* bqkv, const float* wproj,
    const float* bproj, const float* bias, const float* mask, float* qkv,
    float* attn, float* out, int B, int H, int W, int Cin, int C,
    int num_heads, int ws, float scale, int hdp, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * H * W;
  cudaError_t err = gemm_bias(x, Cin, wqkv, 3 * C, bqkv, qkv, 3 * C, M,
                              3 * C, Cin, s);
  if (err != cudaSuccess) return int(err);
  err = window_attention_launch(qkv, qkv + C, qkv + 2 * C, 3 * C, bias, mask,
                                attn, B, H, W, C, num_heads, ws, scale,
                                hdp, vec, s);
  if (err != cudaSuccess) return int(err);
  return int(gemm_bias(attn, C, wproj, C, bproj, out, C, M, C, C, s));
}
