// The fusion net's eval LKABlock over NHWC, fp32, with every BatchNorm an
// eval affine (s, b) (running statistics, eps 1e-5):
//   t   = x s1 + b1
//   a   = dw21x1(dw1x21(dw5x5(t)))              depthwise, zero padded
//   x1  = x + scale1 * t * sigmoid((a Wpw) sbn + bbn)
//   out = x1 + scale2 * (gelu((x1 s2 + b2) F0 + c0) F2 + c2)   hidden Ch
// with exact (erf) GELU.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_lka.py:
// lka_block_fused (:153), which FREQFUSION_LKA=1 routes the fusion net's
// 13 LKABlocks through (freqfusion_tpu/models/fusion/lka.py:80): 9 per-band
// calls at C 64 in phase 3, 4 per-expert calls at C 128 in phase 4, at
// 336x512.
//
// What bounds it on the H100: the three products, 10 C^2 FLOPs per pixel
// (pw C x C, the FFN C x 2C and 2C x C; at 336x512 7.0 GFLOP at C 64 and
// 28.2 at C 128: 0.043 and 0.171 ms as three TF32 products at 495
// TFLOP/s), beside the 67 depthwise taps, 134 C FLOPs per pixel on the
// fp32 cores (0.022 and 0.044 ms), and 8 C bytes of x and out (0.026 and
// 0.053 ms). The old body ran the products as fp32 FMA loops over shared
// memory (0.38 and 1.44 ms on an H100 at 700 W) and the taps from one
// shared load each (0.32 and 0.64 ms). This body takes 0.47-0.50 ms at C
// 64 and 1.17-1.22 at C 128 there: the mix 0.21 and 0.66 (at C 128 one
// block of 12 warps an SM, whose GELU and sigmoid epilogues idle the
// tensor cores), the depthwise pass 0.20 and 0.39 (instruction issue, with
// 1.8x the output's taps for its halo), and the wrapper's host time.
//
// The TPU kernel runs the block in one halo-12 pass. On this card a block
// cannot hold a halo block of all channels ((32+24)^2 x 128 x 4 B is 1.6 MB
// at C 128), and only the 1x1 products mix channels, so the call is three
// launches, no library call:
//  1. prep: the BN affines from their running statistics, folded where a
//     product can take them (sbn into Wpw's columns, s2 into F0's rows, b2
//     into c0: c0' = c0 + b2 F0), and the five C x C products' weights
//     split into hi/lo fragment order (tf32_gemm.cuh's frag_unit) in the
//     order the mix streams them: Wpw', then per hidden chunk j (Cp
//     columns) F0'[:, j] and F2[j, :]; the weights are read through their
//     strides, so the module's views need no copy;
//  2. dw: the depthwise chain per 4-channel slice of a 32 x 32 tile, the
//     slice's 56 x 56 halo of t (zeroed outside the image: the 5x5's
//     padding), the 5x5 output at margin 10 (zeroed outside the image: the
//     1x21's padding) and the 1x21 output at row margin 10 (zeroed
//     outside: the 21x1's padding) in shared memory, each pass
//     register-blocked (a thread slides its window along one filter's
//     axis: 26 outputs of the 5x5 from 30 x 5 loads, 8 of a 1-D filter
//     from 28), padded rows so that a warp's loads hit 32 banks; a goes
//     out channel-quad-major ([C / 4][M][4]), so a warp's stores and the
//     mix's tile copies are contiguous runs;
//  3. mix: per 32 WR rows (8 or 12 warps), the chain of products on the
//     tensor cores in 3xTF32 (tf32_mma.cuh), A from shared memory split
//     in registers as it is read, the weights streamed through a ring of
//     16-row stages by bulk copies on mbarriers: a Wpw', the gate and the
//     first residual in its epilogue (x1 to shared memory), then per
//     hidden chunk gelu(x1 F0'_j + c0'_j) to shared memory and the down
//     product accumulating in registers, and out = x1 + scale2 (f + c2).
//     Shared memory rows are padded to Cp + 8 floats, so a lane's 8-byte
//     fragment reads hit 32 banks.

//
// bf16 (ff_lka_block_bf16, the JAX kernel on bf16 x and parameters): the
// BN affines from the bf16 statistics in fp32, the 67 taps in fp32 on x
// read as bf16, and the three products on bf16 operands with fp32 sums
// (mma.sync m16n8k16, bf16_mma.cuh), rounded where the JAX kernel rounds:
// a before pw, BN2(x1) before F0, the GELU output before F2, and the
// output. So nothing folds into the weights (a fold would change what is
// rounded): the prep writes the weights in bf16 fragment order unscaled
// and the affines as vectors, the depthwise pass writes a as bf16 (it feeds
// only pw), and the mix keeps x1 in fp32 (it feeds the second residual)
// beside BN2(x1) and the hidden chunk as bf16 tiles. At 336x512 the
// products are 7.0 and 28.2 GFLOP (0.007 and 0.029 ms at 989 TFLOP/s),
// below the taps on the fp32 cores (0.022 and 0.044 ms) and the bytes
// (0.013 and 0.026 ms of x and out at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_gemm.cuh"

namespace {

constexpr float kBnEps = 1e-5f;

// Element i of a parameter: fp32, or (kBf) bf16 widened to fp32.
template <bool kBf>
__device__ __forceinline__ float elem(const float* p, long long i) {
  if constexpr (kBf)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  else
    return p[i];
}

// A 2-D weight [K, N] read through its strides: p[k s0 + n s1] (bf16
// values where kBf).
template <bool kBf = false>
struct W2T {
  const float* p;
  int s0, s1;
  __device__ __forceinline__ float operator()(int k, int n) const {
    return elem<kBf>(p, (long long)k * s0 + (long long)n * s1);
  }
};
using W2 = W2T<false>;

// An eval BatchNorm: s = scale / sqrt(var + eps), b = bias - mean s, in
// the plain version's order of fp32 operations (bf16 statistics where
// kBf, widened first, as the JAX wrapper's _affine does).
template <bool kBf = false>
struct BnT {
  const float *scale, *bias, *mean, *var;
  __device__ __forceinline__ float s(int c) const {
    return __fdiv_rn(elem<kBf>(scale, c),
                     __fsqrt_rn(__fadd_rn(elem<kBf>(var, c), kBnEps)));
  }
  __device__ __forceinline__ float b(int c, float sc) const {
    return __fsub_rn(elem<kBf>(bias, c), __fmul_rn(elem<kBf>(mean, c), sc));
  }
};
using Bn = BnT<false>;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// ---- 1. prep ----

struct PrepArgs {
  Bn n1, bn, n2;
  W2 pw, f0, f2;
  const float* c0;  // [Ch]
  float* w;         // 5 split [Cp, Cp] matrices, fragment order
  float* vec;       // s1 [Cp], b1 [Cp], bbn [Cp], c0' [2 Cp]
  int C, Ch, Cp;
};

// Matrix m of the stream: 0 Wpw', 1 + 2j F0'[:, j Cp ..], 2 + 2j F2[j Cp .., :]
__device__ __forceinline__ float stream_value(const PrepArgs& p, int m, int k,
                                              int n) {
  if (m == 0)
    return k < p.C && n < p.C ? __fmul_rn(p.pw(k, n), p.bn.s(n)) : 0.f;
  const int j = (m - 1) / 2;
  if (m % 2)  // F0'
    return k < p.C && j * p.Cp + n < p.Ch
               ? __fmul_rn(p.f0(k, j * p.Cp + n), p.n2.s(k))
               : 0.f;
  return j * p.Cp + k < p.Ch && n < p.C ? p.f2(j * p.Cp + k, n) : 0.f;
}

__global__ void __launch_bounds__(256) lka_prep_kernel(PrepArgs p) {
  const long long per = (long long)p.Cp * p.Cp / 2;  // units a matrix
  const long long units = 5 * per, total = units + 5LL * p.Cp;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += gridDim.x * 256LL) {
    if (i < units) {
      const int m = int(i / per);
      const long long u = i % per;
      int k, n;
      frag_unit(u, p.Cp, k, n);
      store_split_unit(p.w + m * per * 4, u, stream_value(p, m, k, n),
                       stream_value(p, m, k + 1, n));
      continue;
    }
    const int e = int(i - units), c = e % p.Cp;
    float v = 0.f;
    if (e < 2 * p.Cp) {  // s1, b1
      if (c < p.C) {
        const float s = p.n1.s(c);
        v = e < p.Cp ? s : p.n1.b(c, s);
      }
    } else if (e < 3 * p.Cp) {  // bbn
      if (c < p.C) v = p.bn.b(c, p.bn.s(c));
    } else {  // c0' = c0 + b2 F0 over the hidden unit e - 3 Cp
      const int n = e - 3 * p.Cp;
      if (n < p.Ch) {
        v = p.c0[n];
        for (int k = 0; k < p.C; ++k)
          v = fmaf(p.n2.b(k, p.n2.s(k)), p.f0(k, n), v);
      }
    }
    p.vec[e] = v;
  }
}

// ---- 2. the depthwise chain ----
constexpr int kT = 32;        // output tile, rows and columns
constexpr int kCC = 4;        // channels per block (one float4 of NHWC)
constexpr int kS1 = kT + 24;  // t, halo 12: 56 x 56
constexpr int kS2 = kT + 20;  // 5x5 output, margin 10: 52 x 52
constexpr int kLd2 = 65;      // its row stride: = 1 mod 32
constexpr int kLd3 = 33;      // the 1x21 output's ([52][32]) row stride
constexpr int kTaps = 25 + 21 + 21;
constexpr int kP1 = 26;       // 5x5 outputs a thread slides over (a column)
constexpr int kP2 = 8;        // 1x21 outputs a thread slides over (a row)
constexpr int kP3 = 4;        // 21x1 outputs a thread slides over (a column)
constexpr size_t kDwSmem =
    sizeof(float) * (size_t(kCC) * kS1 * kS1 + size_t(kCC) * kS2 * kLd2 +
                     kTaps * kCC);

// kBf: x and the taps bf16, a written as bf16 (it feeds only pw's bf16
// product), the taps' sums fp32 either way.
template <bool kBf = false>
struct DwArgs {
  const float* x;     // [B, H, W, C]
  const float* s1;    // [C] folded norm1 (prep)
  const float* b1;
  W2T<kBf> w5;        // [25, C]
  W2T<kBf> wh;        // [21, C] (1x21, along W)
  W2T<kBf> wv;        // [21, C] (21x1, along H)
  float* a;           // [C / 4][M][4], M = B H W
  int H, W, C;
  long long M;
};

template <bool kBf = false>
__global__ void __launch_bounds__(256, 2) lka_dw_kernel(DwArgs<kBf> p) {
  extern __shared__ __align__(16) float smem[];
  float* s1 = smem;                     // [kCC][kS1][kS1]; then s3
  float* s2 = s1 + kCC * kS1 * kS1;     // [kCC][kS2][kLd2]
  float* wk = s2 + kCC * kS2 * kLd2;    // [kTaps][kCC]
  float* s3 = s1;                       // [kCC][kS2][kLd3]
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCC;
  const int tiles_x = (p.W + kT - 1) / kT;
  const int y0 = (blockIdx.y / tiles_x) * kT, x0 = (blockIdx.y % tiles_x) * kT;
  const int b = blockIdx.z;
  const long long img = (long long)b * p.H * p.W;

  for (int e = tid; e < kTaps * kCC; e += 256) {
    const int k = e / kCC, c = c0 + e % kCC;
    wk[e] = k < 25 ? p.w5(k, c) : k < 46 ? p.wh(k - 25, c) : p.wv(k - 46, c);
  }
  float sc[kCC], sh[kCC];
#pragma unroll
  for (int cc = 0; cc < kCC; ++cc) {
    sc[cc] = p.s1[c0 + cc];
    sh[cc] = p.b1[c0 + cc];
  }
  // t = BN1(x) at halo 12, zero outside the image; unrolled, so that a
  // thread's loads are all in flight at once
#pragma unroll
  for (int i = 0; i < (kS1 * kS1 + 255) / 256; ++i) {
    const int q = tid + 256 * i;
    if (q >= kS1 * kS1) continue;
    const int gy = y0 - 12 + q / kS1, gx = x0 - 12 + q % kS1;
    float v[kCC] = {0.f, 0.f, 0.f, 0.f};
    if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
      const long long o = (img + (long long)gy * p.W + gx) * p.C + c0;
      float4 x4;
      if constexpr (kBf) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            reinterpret_cast<const __nv_bfloat16*>(p.x) + o);
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.y));
        x4 = make_float4(lo.x, lo.y, hi.x, hi.y);
      } else {
        x4 = *reinterpret_cast<const float4*>(p.x + o);
      }
      v[0] = fmaf(x4.x, sc[0], sh[0]);
      v[1] = fmaf(x4.y, sc[1], sh[1]);
      v[2] = fmaf(x4.z, sc[2], sh[2]);
      v[3] = fmaf(x4.w, sc[3], sh[3]);
    }
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) s1[cc * kS1 * kS1 + q] = v[cc];
  }
  __syncthreads();
  // 5x5 at margin 10, zero outside the image: item (channel, strip of
  // kP1 rows, column), neighbouring threads on neighbouring columns
  for (int i = tid; i < kCC * (kS2 / kP1) * kS2; i += 256) {
    const int c = i % kS2, strip = (i / kS2) % (kS2 / kP1);
    const int cc = i / (kS2 * (kS2 / kP1)), r0 = strip * kP1;
    const float* src = s1 + cc * kS1 * kS1 + r0 * kS1 + c;
    float acc[kP1];
#pragma unroll
    for (int r = 0; r < kP1; ++r) acc[r] = 0.f;
#pragma unroll
    for (int dx = 0; dx < 5; ++dx) {
      float v[kP1 + 4];
#pragma unroll
      for (int r = 0; r < kP1 + 4; ++r) v[r] = src[r * kS1 + dx];
#pragma unroll
      for (int dy = 0; dy < 5; ++dy) {
        const float w = wk[(dy * 5 + dx) * kCC + cc];
#pragma unroll
        for (int r = 0; r < kP1; ++r) acc[r] = fmaf(v[r + dy], w, acc[r]);
      }
    }
    const int gx = x0 - 10 + c;
    const bool col_in = gx >= 0 && gx < p.W;
#pragma unroll
    for (int r = 0; r < kP1; ++r) {
      const int gy = y0 - 10 + r0 + r;
      s2[(cc * kS2 + r0 + r) * kLd2 + c] =
          col_in && gy >= 0 && gy < p.H ? acc[r] : 0.f;
    }
  }
  __syncthreads();
  // 1x21 along W at row margin 10, zero outside the image: item (channel,
  // row, strip of kP2 columns)
  for (int i = tid; i < kCC * kS2 * (kT / kP2); i += 256) {
    const int strip = i % (kT / kP2), r = (i / (kT / kP2)) % kS2;
    const int cc = i / (kS2 * (kT / kP2)), cs = strip * kP2;
    const float* src = s2 + (cc * kS2 + r) * kLd2 + cs;
    float v[kP2 + 20];
#pragma unroll
    for (int k = 0; k < kP2 + 20; ++k) v[k] = src[k];
    float acc[kP2];
#pragma unroll
    for (int k = 0; k < kP2; ++k) acc[k] = 0.f;
#pragma unroll
    for (int dj = 0; dj < 21; ++dj) {
      const float w = wk[(25 + dj) * kCC + cc];
#pragma unroll
      for (int k = 0; k < kP2; ++k) acc[k] = fmaf(v[k + dj], w, acc[k]);
    }
    const int gy = y0 - 10 + r;
    const bool in = gy >= 0 && gy < p.H;
#pragma unroll
    for (int k = 0; k < kP2; ++k)
      s3[(cc * kS2 + r) * kLd3 + cs + k] = in ? acc[k] : 0.f;
  }
  __syncthreads();
  // 21x1 along H -> a: thread (strip of kP3 rows, column), all kCC
  // channels, one float4 a pixel
  {
    const int c = tid % kT, r0 = (tid / kT) * kP3;
    float o[kP3][kCC];
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) {
      const float* src = s3 + (cc * kS2 + r0) * kLd3 + c;
      float v[kP3 + 20];
#pragma unroll
      for (int k = 0; k < kP3 + 20; ++k) v[k] = src[k * kLd3];
#pragma unroll
      for (int k = 0; k < kP3; ++k) o[k][cc] = 0.f;
#pragma unroll
      for (int di = 0; di < 21; ++di) {
        const float w = wk[(46 + di) * kCC + cc];
#pragma unroll
        for (int k = 0; k < kP3; ++k) o[k][cc] = fmaf(v[k + di], w, o[k][cc]);
      }
    }
    const int gx = x0 + c;
#pragma unroll
    for (int k = 0; k < kP3; ++k) {
      const int gy = y0 + r0 + k;
      if (gy >= p.H || gx >= p.W) continue;
      const long long e =
          ((c0 / kCC) * p.M + img + (long long)gy * p.W + gx) * kCC;
      if constexpr (kBf)
        *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(p.a) + e) =
            make_uint2(pack_bf16(o[k][0], o[k][1]),
                       pack_bf16(o[k][2], o[k][3]));
      else
        *reinterpret_cast<float4*>(p.a + e) =
            make_float4(o[k][0], o[k][1], o[k][2], o[k][3]);
    }
  }
}

// ---- 3. the chain of products ----

// A block of 4 WR warps takes 32 WR rows: warp (wr, wc) owns rows 32 wr ..
// (two m-tiles) and columns Cp / 4 wc .. (NT = Cp / 32 n-tiles) of every
// C-wide product. R stages of 16 weight rows ring through shared memory.
template <int CP, int WR, int R>
struct Mix {
  static constexpr int kThreads = 128 * WR, kBM = 32 * WR;
  static constexpr int kNT = CP / 32;
  static constexpr int kLd = CP + 8;              // A, X row stride
  static constexpr int kStage = 2 * (CP / 8) * 128;  // floats: 16 rows
  static constexpr int kStages = 5 * CP / 16;     // the stream's stages
  static constexpr size_t kSmem =
      sizeof(float) * (2 * size_t(kBM) * kLd + size_t(R) * kStage) +
      R * sizeof(uint64_t);
};

struct MixArgs {
  const float* x;       // [M, C]
  const float* a;       // [C / 4][M][4]
  const float* w;       // the prep's split stream
  const float* vec;     // s1, b1, bbn, c0' (prep)
  const float* c2;      // [C]
  const float* scale1;  // scalar
  const float* scale2;  // scalar
  float* out;           // [M, C]
  long long M;
  int C;
};

template <int CP, int WR, int R>
__global__ void __launch_bounds__(Mix<CP, WR, R>::kThreads, WR == 2 ? 2 : 1)
lka_mix_kernel(MixArgs p) {
  using S = Mix<CP, WR, R>;
  constexpr int NT = S::kNT, LD = S::kLd, BM = S::kBM;
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);  // [BM][LD]: a, then hidden
  float* X = A + BM * LD;                      // [BM][LD]: x1
  float* ring = X + BM * LD;                   // [R][kStage]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R * S::kStage);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, wr = warp / 4, wc = warp % 4;
  const long long row0 = (long long)blockIdx.x * BM;
  const int C = p.C;

  auto issue = [&](int s) {  // thread 0: stage s of the weight stream
    const int b = s % R;
    constexpr uint32_t kBytes = 4 * S::kStage;
    fence_proxy_async();
    mbar_arrive_expect_tx(&full[b], kBytes);
    bulk_copy(ring + b * S::kStage, p.w + (long long)s * S::kStage, kBytes,
              &full[b]);
  };
  if (tid == 0) {
    for (int b = 0; b < R; ++b) mbar_init(&full[b], 1);
    mbar_init_fence();
    for (int s = 0; s < R - 1; ++s) issue(s);
  }
  // the a tile, rows past M zero
  for (int e = tid; e < BM * (CP / 4); e += S::kThreads) {
    const int r = e % BM, c4 = e / BM;
    const long long m = row0 + r;
    const bool ok = m < p.M && 4 * c4 < C;
    cp_async16(A + r * LD + 4 * c4, ok ? p.a + (c4 * p.M + m) * 4 : p.a, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  int s = 0;  // the stream's next stage
  // acc += As W, the next Cp / 16 stages of the stream; As [BM][LD]
  auto product = [&](float (&acc)[NT][2][4], const float* As) {
    for (int ks = 0; ks < CP / 16; ++ks, ++s) {
      if (s + R - 1 < S::kStages) {
        if (s > 0) __syncthreads();  // stage s - 1's buffer is read
        if (tid == 0) issue(s + R - 1);
      }
      mbar_wait(&full[s % R], (s / R) & 1);
      const float* ws = ring + (s % R) * S::kStage;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // lane (g, t): rows g and g + 8, columns 2t and 2t + 1 of the k8
        // block (fragment columns t and t + 4), split here
        uint32_t fh[2][4], fl[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int o = (32 * wr + 16 * mt + g) * LD + 16 * ks + 8 * kk + 2 * t;
          const float2 r0 = *reinterpret_cast<const float2*>(As + o);
          const float2 r1 = *reinterpret_cast<const float2*>(As + o + 8 * LD);
          split_tf32(r0.x, fh[mt][0], fl[mt][0]);
          split_tf32(r1.x, fh[mt][1], fl[mt][1]);
          split_tf32(r0.y, fh[mt][2], fl[mt][2]);
          split_tf32(r1.y, fh[mt][3], fl[mt][3]);
        }
        const float* wk = ws + (kk * (CP / 8) + wc * NT) * 128 + 4 * lane;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const uint4 f =
                *reinterpret_cast<const uint4*>(wk + 128 * (j + q));
            bh[q][0] = f.x, bh[q][1] = f.y, bl[q][0] = f.z, bl[q][1] = f.w;
          }
          mma_3xtf32_split(*reinterpret_cast<float(*)[2][2][4]>(&acc[j]), fh,
                           fl, bh, bl);
        }
      }
    }
  };
  auto zero = [](float (&acc)[NT][2][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.f;
  };
  // lane (g, t) holds row 32 wr + 16 mt + g + 8 h, column col(j) + e at
  // acc[j][mt][2 h + e]
  auto col = [&](int j) { return (CP / 4) * wc + 8 * j + 2 * t; };
  auto row = [&](int mt, int h) { return 32 * wr + 16 * mt + g + 8 * h; };
  const float* s1 = p.vec;
  const float* b1 = p.vec + CP;
  const float* bbn = p.vec + 2 * CP;
  const float* c0 = p.vec + 3 * CP;

  // a Wpw', then the gate and the first residual: x1 into X
  {
    float acc[NT][2][4];
    zero(acc);
    product(acc, A);
    const float sc1 = *p.scale1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = col(j);
      const float2 sv = *reinterpret_cast<const float2*>(s1 + c);
      const float2 bv = *reinterpret_cast<const float2*>(b1 + c);
      const float2 nv = *reinterpret_cast<const float2*>(bbn + c);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row(mt, h);
          const long long m = row0 + r;
          float2 xv = make_float2(0.f, 0.f);
          if (m < p.M && c < C)
            xv = *reinterpret_cast<const float2*>(p.x + m * C + c);
          const float t0 = fmaf(xv.x, sv.x, bv.x), t1 = fmaf(xv.y, sv.y, bv.y);
          const float v0 =
              xv.x + sc1 * (t0 * sigmoidf(acc[j][mt][2 * h] + nv.x));
          const float v1 =
              xv.y + sc1 * (t1 * sigmoidf(acc[j][mt][2 * h + 1] + nv.y));
          *reinterpret_cast<float2*>(X + r * LD + c) = make_float2(v0, v1);
        }
    }
  }
  __syncthreads();  // X is whole; A is free

  float f[NT][2][4];
  zero(f);
#pragma unroll 1
  for (int ch = 0; ch < 2; ++ch) {
    {  // hidden chunk ch: gelu(x1 F0'_ch + c0') into A
      float hid[NT][2][4];
      zero(hid);
      product(hid, X);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = col(j);
        const float2 bv = *reinterpret_cast<const float2*>(c0 + ch * CP + c);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(A + row(mt, h) * LD + c) = make_float2(
                gelu_erf(hid[j][mt][2 * h] + bv.x),
                gelu_erf(hid[j][mt][2 * h + 1] + bv.y));
      }
    }
    __syncthreads();  // the chunk is whole
    product(f, A);
    __syncthreads();  // A is read: free for the next chunk
  }

  // out = x1 + scale2 (f + c2)
  const float sc2 = *p.scale2;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = col(j);
    if (c >= C) continue;
    const float cv0 = p.c2[c], cv1 = p.c2[c + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row(mt, h);
        const long long m = row0 + r;
        if (m >= p.M) continue;
        const float2 x1 = *reinterpret_cast<const float2*>(X + r * LD + c);
        *reinterpret_cast<float2*>(p.out + m * C + c) =
            make_float2(x1.x + sc2 * (f[j][mt][2 * h] + cv0),
                        x1.y + sc2 * (f[j][mt][2 * h + 1] + cv1));
      }
  }
}

template <int CP, int WR, int R>
int launch_mix(const MixArgs& p, cudaStream_t stream) {
  using S = Mix<CP, WR, R>;
  cudaError_t err = cudaFuncSetAttribute(
      lka_mix_kernel<CP, WR, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(S::kSmem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (p.M + S::kBM - 1) / S::kBM;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  lka_mix_kernel<CP, WR, R><<<unsigned(blocks), S::kThreads, S::kSmem,
                              stream>>>(p);
  return int(cudaGetLastError());
}

// ---- bf16: the prep and the chain of products ----

struct PrepBf16Args {
  BnT<true> n1, bn, n2;
  W2T<true> pw, f0, f2;
  const float* c0;  // [Ch] bf16
  const float* c2;  // [C] bf16
  uint32_t* w;      // 5 [Cp, Cp] matrices, bf16 fragment order
  float* vec;       // s1, b1, sbn, bbn, s2, b2 [Cp each], c0 [2 Cp], c2 [Cp]
  int C, Ch, Cp;
};

// Matrix m of the bf16 stream, unscaled: 0 Wpw, 1 + 2j F0[:, j Cp ..],
// 2 + 2j F2[j Cp .., :]; zero past the real rows and columns.
__device__ __forceinline__ float stream_value_bf16(const PrepBf16Args& p,
                                                   int m, int k, int n) {
  if (m == 0) return k < p.C && n < p.C ? p.pw(k, n) : 0.f;
  const int j = (m - 1) / 2;
  if (m % 2) return k < p.C && j * p.Cp + n < p.Ch ? p.f0(k, j * p.Cp + n) : 0.f;
  return j * p.Cp + k < p.Ch && n < p.C ? p.f2(j * p.Cp + k, n) : 0.f;
}

// Unit u of a matrix (Cp / 16 stages of [Cp / 8 n-tiles][32 lanes][2
// words]) is lane (g, t) of a (k16 block, n-tile): b0 = W[2t, 2t + 1][g],
// b1 = W[2t + 8, 2t + 9][g] as bf16 pairs.
__global__ void __launch_bounds__(256) lka_prep_bf16_kernel(PrepBf16Args p) {
  const long long per = (long long)p.Cp * p.Cp / 4;  // units a matrix
  const long long units = 5 * per, total = units + 9LL * p.Cp;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += gridDim.x * 256LL) {
    if (i < units) {
      const int m = int(i / per);
      const long long u = i % per;
      const int lane = int(u % 32), nt = int((u / 32) % (p.Cp / 8));
      const int ks = int(u / 32 / (p.Cp / 8));
      const int k = 16 * ks + 2 * (lane % 4), n = 8 * nt + lane / 4;
      *reinterpret_cast<uint2*>(p.w + 2 * (m * per + u)) = make_uint2(
          pack_bf16(stream_value_bf16(p, m, k, n),
                    stream_value_bf16(p, m, k + 1, n)),
          pack_bf16(stream_value_bf16(p, m, k + 8, n),
                    stream_value_bf16(p, m, k + 9, n)));
      continue;
    }
    const int e = int(i - units), c = e % p.Cp, which = e / p.Cp;
    float v = 0.f;
    if (which < 6) {  // s1, b1, sbn, bbn, s2, b2
      if (c < p.C) {
        const BnT<true>& bn = which < 2 ? p.n1 : which < 4 ? p.bn : p.n2;
        const float sc = bn.s(c);
        v = which % 2 ? bn.b(c, sc) : sc;
      }
    } else if (which < 8) {  // c0 over the hidden unit e - 6 Cp
      const int n = e - 6 * p.Cp;
      if (n < p.Ch) v = elem<true>(p.c0, n);
    } else if (c < p.C) {  // c2
      v = elem<true>(p.c2, c);
    }
    p.vec[e] = v;
  }
}

// As Mix, with A (a, then the hidden chunk) and T (BN2(x1)) bf16 tiles of
// rows padded to Cp + 8 (16-byte multiples, so ldmatrix's row reads fall
// in distinct banks), x1 fp32, and one 16-row weight stage 8 Cp words.
template <int CP, int WR, int R>
struct MixBf16 {
  static constexpr int kThreads = 128 * WR, kBM = 32 * WR;
  static constexpr int kNT = CP / 32;
  static constexpr int kLd = CP + 8;
  static constexpr int kStage = 8 * CP;
  static constexpr int kStages = 5 * CP / 16;
  static constexpr size_t kSmem =
      2 * sizeof(__nv_bfloat16) * size_t(kBM) * kLd +
      sizeof(float) * (size_t(kBM) * kLd + size_t(R) * kStage) +
      R * sizeof(uint64_t);
};

struct MixBf16Args {
  const void* x;         // [M, C] bf16
  const void* a;         // [C / 4][M][4] bf16
  const uint32_t* w;     // the prep's stream
  const float* vec;      // the prep's vectors
  const void* scale1;    // bf16 scalars
  const void* scale2;
  void* out;             // [M, C] bf16
  long long M;
  int C;
};

template <int CP, int WR, int R>
__global__ void __launch_bounds__(MixBf16<CP, WR, R>::kThreads,
                                  WR == 2 ? 2 : 1)
lka_mix_bf16_kernel(MixBf16Args p) {
  using S = MixBf16<CP, WR, R>;
  using bf16 = __nv_bfloat16;
  constexpr int NT = S::kNT, LD = S::kLd, BM = S::kBM;
  extern __shared__ float4 smem4[];
  bf16* A = reinterpret_cast<bf16*>(smem4);      // [BM][LD]
  bf16* T = A + BM * LD;                         // [BM][LD]
  float* X = reinterpret_cast<float*>(T + BM * LD);  // [BM][LD]: x1
  uint32_t* ring = reinterpret_cast<uint32_t*>(X + BM * LD);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R * S::kStage);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, wr = warp / 4, wc = warp % 4;
  const long long row0 = (long long)blockIdx.x * BM;
  const int C = p.C;
  const bf16* x = static_cast<const bf16*>(p.x);

  auto issue = [&](int s) {  // thread 0: stage s of the weight stream
    const int b = s % R;
    constexpr uint32_t kBytes = 4 * S::kStage;
    fence_proxy_async();
    mbar_arrive_expect_tx(&full[b], kBytes);
    bulk_copy(ring + b * S::kStage, p.w + (long long)s * S::kStage, kBytes,
              &full[b]);
  };
  if (tid == 0) {
    for (int b = 0; b < R; ++b) mbar_init(&full[b], 1);
    mbar_init_fence();
    for (int s = 0; s < R - 1; ++s) issue(s);
  }
  // the a tile, rows past M and channels past C zero
  for (int e = tid; e < BM * (CP / 4); e += S::kThreads) {
    const int r = e % BM, c4 = e / BM;
    const long long m = row0 + r;
    uint2 v = make_uint2(0u, 0u);
    if (m < p.M && 4 * c4 < C)
      v = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(p.a) +
                                          (c4 * p.M + m) * 4);
    *reinterpret_cast<uint2*>(A + r * LD + 4 * c4) = v;
  }
  __syncthreads();

  int s = 0;  // the stream's next stage
  // acc += As W, the next Cp / 16 stages of the stream; As [BM][LD] bf16
  auto product = [&](float (&acc)[NT][2][4], const bf16* As) {
    for (int ks = 0; ks < CP / 16; ++ks, ++s) {
      if (s + R - 1 < S::kStages) {
        if (s > 0) __syncthreads();  // stage s - 1's buffer is read
        if (tid == 0) issue(s + R - 1);
      }
      mbar_wait(&full[s % R], (s / R) & 1);
      const uint32_t* ws = ring + (s % R) * S::kStage;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_a(a[mt], As + (32 * wr + 16 * mt) * LD + 16 * ks, LD);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint2 f = *reinterpret_cast<const uint2*>(
            ws + (wc * NT + j) * 64 + 2 * lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[j][mt], a[mt], f.x, f.y);
      }
    }
  };
  auto zero = [](float (&acc)[NT][2][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.f;
  };
  auto col = [&](int j) { return (CP / 4) * wc + 8 * j + 2 * t; };
  auto row = [&](int mt, int h) { return 32 * wr + 16 * mt + g + 8 * h; };
  auto pair = [](const float* v, int c) {
    return *reinterpret_cast<const float2*>(v + c);
  };
  const float* s1 = p.vec;
  const float* b1 = p.vec + CP;
  const float* sbn = p.vec + 2 * CP;
  const float* bbn = p.vec + 3 * CP;
  const float* s2 = p.vec + 4 * CP;
  const float* b2 = p.vec + 5 * CP;
  const float* c0 = p.vec + 6 * CP;
  const float* c2 = p.vec + 8 * CP;

  // a Wpw, its BN, the gate and the first residual: x1 into X, BN2(x1)
  // rounded into T
  {
    float acc[NT][2][4];
    zero(acc);
    product(acc, A);
    const float sc1 = elem<true>(static_cast<const float*>(p.scale1), 0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = col(j);
      const float2 sv = pair(s1, c), bv = pair(b1, c), sn = pair(sbn, c),
                   bn = pair(bbn, c), s2v = pair(s2, c), b2v = pair(b2, c);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row(mt, h);
          const long long m = row0 + r;
          float2 xv = make_float2(0.f, 0.f);
          if (m < p.M && c < C)
            xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(x + m * C + c));
          const float t0 = fmaf(xv.x, sv.x, bv.x), t1 = fmaf(xv.y, sv.y, bv.y);
          const float v0 = xv.x + sc1 * (t0 * sigmoidf(fmaf(
                                             acc[j][mt][2 * h], sn.x, bn.x)));
          const float v1 = xv.y + sc1 * (t1 * sigmoidf(fmaf(
                                             acc[j][mt][2 * h + 1], sn.y,
                                             bn.y)));
          *reinterpret_cast<float2*>(X + r * LD + c) = make_float2(v0, v1);
          *reinterpret_cast<uint32_t*>(T + r * LD + c) =
              pack_bf16(fmaf(v0, s2v.x, b2v.x), fmaf(v1, s2v.y, b2v.y));
        }
    }
  }
  __syncthreads();  // X and T are whole; A is free

  float f[NT][2][4];
  zero(f);
#pragma unroll 1
  for (int ch = 0; ch < 2; ++ch) {
    {  // hidden chunk ch: gelu(T F0_ch + c0), rounded, into A
      float hid[NT][2][4];
      zero(hid);
      product(hid, T);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = col(j);
        const float2 bv = pair(c0, ch * CP + c);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(A + row(mt, h) * LD + c) =
                pack_bf16(gelu_erf(hid[j][mt][2 * h] + bv.x),
                          gelu_erf(hid[j][mt][2 * h + 1] + bv.y));
      }
    }
    __syncthreads();  // the chunk is whole
    product(f, A);
    __syncthreads();  // A is read: free for the next chunk
  }

  // out = x1 + scale2 (f + c2), rounded
  const float sc2 = elem<true>(static_cast<const float*>(p.scale2), 0);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = col(j);
    if (c >= C) continue;
    const float2 cv = pair(c2, c);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row(mt, h);
        const long long m = row0 + r;
        if (m >= p.M) continue;
        const float2 x1 = pair(X + r * LD, c);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) +
                                           m * C + c) =
            __floats2bfloat162_rn(x1.x + sc2 * (f[j][mt][2 * h] + cv.x),
                                  x1.y + sc2 * (f[j][mt][2 * h + 1] + cv.y));
      }
  }
}

template <int CP, int WR, int R>
int launch_mix_bf16(const MixBf16Args& p, cudaStream_t stream) {
  using S = MixBf16<CP, WR, R>;
  cudaError_t err = cudaFuncSetAttribute(
      lka_mix_bf16_kernel<CP, WR, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(S::kSmem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (p.M + S::kBM - 1) / S::kBM;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  lka_mix_bf16_kernel<CP, WR, R><<<unsigned(blocks), S::kThreads, S::kSmem,
                                   stream>>>(p);
  return int(cudaGetLastError());
}

// C padded to the mix's width: 64 or 128.
int padded(int C) { return C <= 64 ? 64 : 128; }

}  // namespace

// Floats of scratch a call needs: the split weights (10 Cp^2), the folded
// vectors (5 Cp) and a (C M, M = B H W); -1 for a width the kernel does not
// take (C a multiple of 4 <= 128, Ch <= 2 Cp).
extern "C" long long ff_lka_scratch_floats(long long M, int C, int Ch) {
  if (C <= 0 || C % 4 || C > 128 || Ch <= 0 || Ch > 2 * padded(C)) return -1;
  const long long cp = padded(C);
  return 10 * cp * cp + 5 * cp + (long long)C * M;
}

// x, out [B, H, W, C] (x 16-byte aligned); the three BNs' scale, bias,
// mean and var [C]; w5 [25, C], wh / wv [21, C], pw [C, C], f0 [C, Ch],
// f2 [Ch, C], each given by its pointer and the strides of its two axes;
// c0 [Ch], c2 [C]; scale1 / scale2 one float each on the card; scratch of
// ff_lka_scratch_floats(B H W, C, Ch) floats, 16-byte aligned. All fp32.
extern "C" int ff_lka_block(
    const float* x, const float* n1s, const float* n1b, const float* n1m,
    const float* n1v, const float* bns, const float* bnb, const float* bnm,
    const float* bnv, const float* n2s, const float* n2b, const float* n2m,
    const float* n2v, const float* w5, int w5s0, int w5s1, const float* wh,
    int whs0, int whs1, const float* wv, int wvs0, int wvs1, const float* pw,
    int pws0, int pws1, const float* f0, int f0s0, int f0s1, const float* c0,
    const float* f2, int f2s0, int f2s1, const float* c2, const float* scale1,
    const float* scale2, float* scratch, long long scratch_floats, float* out,
    int B, int H, int W, int C, int Ch, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long M = (long long)B * H * W;
  const long long need = ff_lka_scratch_floats(M, C, Ch);
  if (need < 0 || scratch_floats < need ||
      reinterpret_cast<size_t>(scratch) % 16 ||
      reinterpret_cast<size_t>(x) % 16 || B > 65535)
    return int(cudaErrorInvalidValue);
  const int cp = padded(C);
  float* wsplit = scratch;
  float* vec = wsplit + 10LL * cp * cp;
  float* a = vec + 5 * cp;
  const Bn n1{n1s, n1b, n1m, n1v}, bn{bns, bnb, bnm, bnv},
      n2{n2s, n2b, n2m, n2v};
  PrepArgs pa{n1, bn, n2, W2{pw, pws0, pws1}, W2{f0, f0s0, f0s1},
              W2{f2, f2s0, f2s1}, c0, wsplit, vec, C, Ch, cp};
  lka_prep_kernel<<<132, 256, 0, stream>>>(pa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  err = cudaFuncSetAttribute(lka_dw_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kDwSmem));
  if (err != cudaSuccess) return int(err);
  const int tiles = ((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  DwArgs<false> d{x, vec, vec + cp, W2{w5, w5s0, w5s1}, W2{wh, whs0, whs1},
                  W2{wv, wvs0, wvs1}, a, H, W, C, M};
  lka_dw_kernel<false><<<dim3(unsigned(C / kCC), unsigned(tiles),
                              unsigned(B)), 256, kDwSmem, stream>>>(d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const MixArgs m{x, a, wsplit, vec, c2, scale1, scale2, out, M, C};
  return cp == 64 ? launch_mix<64, 2, 4>(m, stream)
                  : launch_mix<128, 3, 4>(m, stream);
}

// Floats (4-byte words) of scratch ff_lka_block_bf16 needs: the bf16
// weights (2.5 Cp^2), the vectors (9 Cp) and a (C M / 2); -1 for a width
// the kernel does not take.
extern "C" long long ff_lka_bf16_scratch_floats(long long M, int C, int Ch) {
  if (C <= 0 || C % 4 || C > 128 || Ch <= 0 || Ch > 2 * padded(C)) return -1;
  const long long cp = padded(C);
  return 5 * cp * cp / 2 + 9 * cp + ((long long)C * M + 1) / 2;
}

// The bf16 version: x, out [B, H, W, C] bf16 (x 8-byte aligned) and every
// parameter bf16 (shapes and strides as ff_lka_block's); scratch of
// ff_lka_bf16_scratch_floats(B H W, C, Ch) words, 16-byte aligned.
extern "C" int ff_lka_block_bf16(
    const void* x, const float* n1s, const float* n1b, const float* n1m,
    const float* n1v, const float* bns, const float* bnb, const float* bnm,
    const float* bnv, const float* n2s, const float* n2b, const float* n2m,
    const float* n2v, const float* w5, int w5s0, int w5s1, const float* wh,
    int whs0, int whs1, const float* wv, int wvs0, int wvs1, const float* pw,
    int pws0, int pws1, const float* f0, int f0s0, int f0s1, const float* c0,
    const float* f2, int f2s0, int f2s1, const float* c2, const void* scale1,
    const void* scale2, float* scratch, long long scratch_floats, void* out,
    int B, int H, int W, int C, int Ch, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long M = (long long)B * H * W;
  const long long need = ff_lka_bf16_scratch_floats(M, C, Ch);
  if (need < 0 || scratch_floats < need ||
      reinterpret_cast<size_t>(scratch) % 16 ||
      reinterpret_cast<size_t>(x) % 8 || B > 65535)
    return int(cudaErrorInvalidValue);
  const int cp = padded(C);
  uint32_t* w = reinterpret_cast<uint32_t*>(scratch);
  float* vec = scratch + 5LL * cp * cp / 2;
  float* a = vec + 9 * cp;
  const BnT<true> n1{n1s, n1b, n1m, n1v}, bn{bns, bnb, bnm, bnv},
      n2{n2s, n2b, n2m, n2v};
  PrepBf16Args pa{n1, bn, n2, W2T<true>{pw, pws0, pws1},
                  W2T<true>{f0, f0s0, f0s1}, W2T<true>{f2, f2s0, f2s1},
                  c0, c2, w, vec, C, Ch, cp};
  lka_prep_bf16_kernel<<<132, 256, 0, stream>>>(pa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  err = cudaFuncSetAttribute(lka_dw_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kDwSmem));
  if (err != cudaSuccess) return int(err);
  const int tiles = ((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  DwArgs<true> d{static_cast<const float*>(x), vec, vec + cp,
                 W2T<true>{w5, w5s0, w5s1}, W2T<true>{wh, whs0, whs1},
                 W2T<true>{wv, wvs0, wvs1}, a, H, W, C, M};
  lka_dw_kernel<true><<<dim3(unsigned(C / kCC), unsigned(tiles),
                             unsigned(B)), 256, kDwSmem, stream>>>(d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const MixBf16Args m{x, a, w, vec, scale1, scale2, out, M, C};
  return cp == 64 ? launch_mix_bf16<64, 2, 4>(m, stream)
                  : launch_mix_bf16<128, 3, 4>(m, stream);
}
