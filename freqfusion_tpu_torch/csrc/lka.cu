// The fusion net's eval LKABlock over NHWC, fp32, with every BatchNorm
// folded into a per-channel affine (s, b) on the host:
//   t   = x s1 + b1
//   a   = dw21x1(dw1x21(dw5x5(t)))              depthwise, zero padded
//   x1  = x + scale1 * t * sigmoid((a Wpw) sbn + bbn)
//   out = x1 + scale2 * (gelu((x1 s2 + b2) F0 + c0) F2 + c2)   hidden 2C
// with exact (erf) GELU.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_lka.py:
// lka_block_fused (:153), which FREQFUSION_LKA=1 routes the fusion net's
// 13 LKABlocks through (freqfusion_tpu/models/fusion/lka.py:80): 9 per-band
// calls at C 64 in phase 3, 4 per-expert calls at C 128 in phase 4.
//
// What bounds it on the H100: the three products, 10 C^2 FLOPs per pixel
// (pw C x C, the FFN C x 2C and 2C x C), and the 67 depthwise taps, 134 C:
// at 336x512 7.9 GFLOP a call at C 64 (0.12 ms at 67 TFLOP/s fp32) against
// 8 C bytes of x and out (88 MB, 0.03 ms at 3.35 TB/s). fp32 FMA issue.
//
// The TPU kernel runs the block in one halo-12 pass. On this card a block
// cannot hold a halo block of all channels ((32+24)^2 x 128 x 4 B is 1.6 MB
// at C 128), and only the 1x1 products mix channels, so the call is two
// kernels:
//  1. dw: the depthwise chain per 4-channel slice of a 32 x 32 tile. The
//     slice's 56 x 56 halo of t (zeroed outside the image: the 5x5's
//     padding), the 5x5 output at margin 10 (zeroed outside the image: the
//     1x21's padding) and the 1x21 output at row margin 10 (zeroed outside:
//     the 21x1's padding) sit in shared memory, 93 KB; the 21x1 output a
//     goes to a scratch in device memory. The masks are anisotropic: the
//     5x5 output keeps margin 10 in both axes, the 1x21 output in H only.
//  2. mix: per 64 pixels, the chain of products with fused epilogues, the
//     row tile in shared memory and the C-wide output in registers (each
//     thread 4 rows x C/16 columns): a Wpw, then the gate and the first
//     residual (x1 kept in registers, BN2(x1) back to shared memory), then
//     the FFN with its hidden walked in 64-unit chunks, as csrc/fused_mlp.cu
//     does. The scratch a is 4 C bytes a pixel each way (88 MB at C 64,
//     0.03 ms): a tenth of the compute bound.
// No cuDNN, no cuBLAS: the taps and the products are loops over shared
// memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

// ---- 1. the depthwise chain ----
constexpr int kT = 32;        // output tile, rows and columns
constexpr int kCC = 4;        // channels per block (one float4 of NHWC)
constexpr int kS1 = kT + 24;  // t, halo 12
constexpr int kS2 = kT + 20;  // 5x5 output, margin 10
constexpr int kTaps = 25 + 21 + 21;
constexpr size_t kDwSmem =
    sizeof(float) * (size_t(kCC) * kS1 * kS1 + size_t(kCC) * kS2 * kS2 +
                     kTaps * kCC);

struct DwArgs {
  const float* x;     // [B, H, W, C]
  const float* s1;    // [C] folded norm1
  const float* b1;
  const float* w5;    // [25, C]
  const float* wh;    // [21, C] (1x21, along W)
  const float* wv;    // [21, C] (21x1, along H)
  float* a;           // [B, H, W, C]
  int H, W, C;
};

__global__ void __launch_bounds__(kThreads) lka_dw_kernel(DwArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* s1 = smem;                     // [kCC][kS1][kS1]; then s3
  float* s2 = s1 + kCC * kS1 * kS1;     // [kCC][kS2][kS2]
  float* wk = s2 + kCC * kS2 * kS2;     // [kTaps][kCC]
  float* s3 = s1;                       // [kCC][kS2][kT]
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCC;
  const int tiles_x = (p.W + kT - 1) / kT;
  const int y0 = (blockIdx.y / tiles_x) * kT, x0 = (blockIdx.y % tiles_x) * kT;
  const int b = blockIdx.z;
  const long long img = (long long)b * p.H * p.W;

  for (int e = tid; e < kTaps * kCC; e += kThreads) {
    const int k = e / kCC, c = c0 + e % kCC;
    wk[e] = k < 25 ? p.w5[k * p.C + c]
           : k < 46 ? p.wh[(k - 25) * p.C + c]
                    : p.wv[(k - 46) * p.C + c];
  }
  float sc[kCC], sh[kCC];
#pragma unroll
  for (int cc = 0; cc < kCC; ++cc) {
    sc[cc] = p.s1[c0 + cc];
    sh[cc] = p.b1[c0 + cc];
  }
  // t = BN1(x) at halo 12, zero outside the image
  for (int q = tid; q < kS1 * kS1; q += kThreads) {
    const int gy = y0 - 12 + q / kS1, gx = x0 - 12 + q % kS1;
    float v[kCC] = {0.f, 0.f, 0.f, 0.f};
    if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
      const float4 x4 = *reinterpret_cast<const float4*>(
          p.x + (img + (long long)gy * p.W + gx) * p.C + c0);
      v[0] = fmaf(x4.x, sc[0], sh[0]);
      v[1] = fmaf(x4.y, sc[1], sh[1]);
      v[2] = fmaf(x4.z, sc[2], sh[2]);
      v[3] = fmaf(x4.w, sc[3], sh[3]);
    }
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) s1[cc * kS1 * kS1 + q] = v[cc];
  }
  __syncthreads();
  // 5x5 at margin 10, zero outside the image
#pragma unroll 1
  for (int cc = 0; cc < kCC; ++cc) {
    float w[25];
#pragma unroll
    for (int k = 0; k < 25; ++k) w[k] = wk[k * kCC + cc];
    for (int q = tid; q < kS2 * kS2; q += kThreads) {
      const int r = q / kS2, c = q % kS2;
      const int gy = y0 - 10 + r, gx = x0 - 10 + c;
      float acc = 0.f;
      if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
        const float* src = s1 + cc * kS1 * kS1 + r * kS1 + c;
#pragma unroll
        for (int di = 0; di < 5; ++di)
#pragma unroll
          for (int dj = 0; dj < 5; ++dj)
            acc = fmaf(src[di * kS1 + dj], w[di * 5 + dj], acc);
      }
      s2[cc * kS2 * kS2 + q] = acc;
    }
  }
  __syncthreads();
  // 1x21 along W at row margin 10, zero outside the image
#pragma unroll 1
  for (int cc = 0; cc < kCC; ++cc) {
    float w[21];
#pragma unroll
    for (int k = 0; k < 21; ++k) w[k] = wk[(25 + k) * kCC + cc];
    for (int q = tid; q < kS2 * kT; q += kThreads) {
      const int r = q / kT, c = q % kT;
      const int gy = y0 - 10 + r, gx = x0 + c;
      float acc = 0.f;
      if (gy >= 0 && gy < p.H && gx < p.W) {
        const float* src = s2 + cc * kS2 * kS2 + r * kS2 + c;
#pragma unroll
        for (int dj = 0; dj < 21; ++dj) acc = fmaf(src[dj], w[dj], acc);
      }
      s3[cc * kS2 * kT + q] = acc;
    }
  }
  __syncthreads();
  // 21x1 along H -> a
  for (int q = tid; q < kT * kT; q += kThreads) {
    const int r = q / kT, c = q % kT;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= p.H || gx >= p.W) continue;
    float o[kCC];
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) {
      const float* src = s3 + cc * kS2 * kT + r * kT + c;
      float acc = 0.f;
#pragma unroll
      for (int di = 0; di < 21; ++di)
        acc = fmaf(src[di * kT], wk[(46 + di) * kCC + cc], acc);
      o[cc] = acc;
    }
    *reinterpret_cast<float4*>(p.a + (img + (long long)gy * p.W + gx) * p.C +
                               c0) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// ---- 2. the per-pixel chain of products ----
constexpr int kRows = 64;       // pixels per block
constexpr int kLd = kRows + 4;  // row stride of the transposed tiles
constexpr int kHid = 64;        // hidden units per chunk
constexpr int kDepth = 16;      // weight rows staged at a time

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][4 g + j] += sum_k At[k][4 ty + i] Wg[k][64 g + 4 tx + j] over k < K
// and the first N columns of Wg (row stride ldw). At is a transposed row
// tile in shared memory; Wg is staged kDepth rows at a time through Ws.
template <int NC>
__device__ __forceinline__ void gemm_acc(const float* At, int K,
                                         const float* __restrict__ Wg, int ldw,
                                         int N, float* Ws, float (&acc)[4][NC],
                                         int tid) {
  constexpr int CP = 16 * NC;
  const int tx = tid & 15, ty = tid >> 4;
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    __syncthreads();  // Ws (and the caller's tiles) are free / written
    for (int e = tid; e < kDepth * CP; e += kThreads) {
      const int k = k0 + e / CP, n = e % CP;
      Ws[e] = (k < K && n < N) ? Wg[(long long)k * ldw + n] : 0.f;
    }
    __syncthreads();
    const int depth = min(kDepth, K - k0);
    for (int kk = 0; kk < depth; ++kk) {
      const float4 a = ld4(At + (k0 + kk) * kLd + 4 * ty);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < NC / 4; ++g) {
        const float4 w = ld4(Ws + kk * CP + 64 * g + 4 * tx);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][4 * g + j] = fmaf(av[i], wv[j], acc[i][4 * g + j]);
      }
    }
  }
}

struct MixArgs {
  const float* x;      // [M, C]
  const float* a;      // [M, C] the depthwise chain's output
  const float* s1;     // [C] folded norm1
  const float* b1;
  const float* pw;     // [C, C]
  const float* sbn;    // [C] folded lka.bn
  const float* bbn;
  const float* s2;     // [C] folded norm2
  const float* b2;
  const float* f0;     // [C, Ch]
  const float* c0;     // [Ch]
  const float* f2;     // [Ch, C]
  const float* c2;     // [C]
  const float* scale1;  // scalar
  const float* scale2;  // scalar
  float* out;          // [M, C]
  long long M;
  int C, Ch;
};

template <int NC>
constexpr size_t mix_smem() {
  return sizeof(float) *
         (size_t(16 * NC) * kLd + size_t(kHid) * kLd +
          size_t(kDepth) * (16 * NC > kHid ? 16 * NC : kHid));
}

// Thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and columns 64 g + 4 tx + j
// (C <= 16 NC).
template <int NC>
__global__ void __launch_bounds__(kThreads) lka_mix_kernel(MixArgs p) {
  constexpr int CP = 16 * NC;
  extern __shared__ __align__(16) float smem[];
  float* At = smem;             // [CP][kLd]: a, then BN2(x1), transposed
  float* Ht = At + CP * kLd;    // [kHid][kLd]: hidden chunk, transposed
  float* Ws = Ht + kHid * kLd;  // [kDepth][max(CP, kHid)]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int C = p.C;

  for (int e = tid; e < kRows * C; e += kThreads) {
    const int r = e % kRows, c = e / kRows;
    const long long m = row0 + r;
    At[c * kLd + r] = m < p.M ? p.a[m * C + c] : 0.f;
  }
  float x1[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k) x1[i][k] = 0.f;
  gemm_acc<NC>(At, C, p.pw, C, C, Ws, x1, tid);

  // gate and first residual; BN2(x1) into At
  const float sc1 = *p.scale1, sc2 = *p.scale2;
  __syncthreads();  // every thread is done reading At
#pragma unroll
  for (int g = 0; g < NC / 4; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = 64 * g + 4 * tx + j;
      if (co >= C) continue;
      const float s1 = p.s1[co], b1 = p.b1[co], sbn = p.sbn[co],
                  bbn = p.bbn[co], s2 = p.s2[co], b2 = p.b2[co];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long m = row0 + 4 * ty + i;
        const float xv = m < p.M ? p.x[m * C + co] : 0.f;
        const float t = fmaf(xv, s1, b1);
        const float attn = fmaf(x1[i][4 * g + j], sbn, bbn);
        const float v = xv + sc1 * (t * sigmoidf(attn));
        x1[i][4 * g + j] = v;
        At[co * kLd + 4 * ty + i] = fmaf(v, s2, b2);
      }
    }

  float f[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k) f[i][k] = 0.f;
  for (int j0 = 0; j0 < p.Ch; j0 += kHid) {
    const int nh = min(kHid, p.Ch - j0);
    float h[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) h[i][k] = 0.f;
    gemm_acc<4>(At, C, p.f0 + j0, p.Ch, nh, Ws, h, tid);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int u = 4 * tx + k;
      const float bias = u < nh ? p.c0[j0 + u] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Ht[u * kLd + 4 * ty + i] = u < nh ? gelu_erf(h[i][k] + bias) : 0.f;
    }
    gemm_acc<NC>(Ht, nh, p.f2 + (long long)j0 * C, C, C, Ws, f, tid);
  }

#pragma unroll
  for (int g = 0; g < NC / 4; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = 64 * g + 4 * tx + j;
      if (co >= C) continue;
      const float c2 = p.c2[co];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long m = row0 + 4 * ty + i;
        if (m < p.M) p.out[m * C + co] = x1[i][4 * g + j] +
                                         sc2 * (f[i][4 * g + j] + c2);
      }
    }
}

template <int NC>
int launch_mix(const MixArgs& p, cudaStream_t stream) {
  constexpr size_t smem = mix_smem<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      lka_mix_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const unsigned blocks = unsigned((p.M + kRows - 1) / kRows);
  lka_mix_kernel<NC><<<blocks, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// x, a (scratch), out [B, H, W, C], C a multiple of 4 and <= 128, x 16-byte
// aligned; the per-channel vectors [C]; w5 [25, C], wh / wv [21, C];
// pw [C, C]; f0 [C, Ch]; c0 [Ch]; f2 [Ch, C]; scale1 / scale2 one float
// each on the card. All fp32 contiguous.
extern "C" int ff_lka_block(const float* x, const float* s1, const float* b1,
                            const float* w5, const float* wh, const float* wv,
                            const float* pw, const float* sbn,
                            const float* bbn, const float* s2,
                            const float* b2, const float* f0, const float* c0,
                            const float* f2, const float* c2,
                            const float* scale1, const float* scale2,
                            float* a, float* out, int B, int H, int W, int C,
                            int Ch, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (C % kCC != 0 || C > 128) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      lka_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(kDwSmem));
  if (err != cudaSuccess) return int(err);
  const int tiles = ((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  DwArgs d{x, s1, b1, w5, wh, wv, a, H, W, C};
  lka_dw_kernel<<<dim3(unsigned(C / kCC), unsigned(tiles), unsigned(B)),
                  kThreads, kDwSmem, stream>>>(d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  MixArgs m{x,  a,  s1, b1, pw, sbn, bbn, s2,     b2,     f0,
            c0, f2, c2, scale1, scale2, out, (long long)B * H * W, C, Ch};
  return C <= 64 ? launch_mix<4>(m, stream) : launch_mix<8>(m, stream);
}
