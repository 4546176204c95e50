// A whole NAFBlock over NHWC rows, fp32 (NAFNet-SIDD-64, widths 64..1024):
//   u   = LN1(x) W1 + b1                         C -> 2C    (eps 1e-6)
//   g   = (dw3x3(u)[:C] + d[:C]) * (dw3x3(u)[C:] + d[C:])   SimpleGate
//   s   = Wsca mean_hw(g) + bsca                  SCA, [B, C]
//   y   = x + beta * ((g * s) W3 + b3)
//   g2  = (LN2(y) W4 + b4)[:C] * (LN2(y) W4 + b4)[C:]
//   out = y + gamma * (g2 W5 + b5)
// with zero padding for the depthwise conv at the image edges.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_nafblock.py:
// nafblock_fused (:231), which FREQFUSION_NAFBLOCK=1 routes all 36
// NAFBlocks through (freqfusion_tpu/models/nafnet.py:108).
//
// What bounds it on the H100: the five 1x1 products, 12 C^2 FLOPs a pixel,
// 1.35e11 per block at every level (C 64 at 1344x2048 up to C 1024 at
// 84x128), 2.0 ms at 67 TFLOP/s fp32. The byte floor (read x, write out:
// 8 C bytes a pixel) is 0.42 ms at level 1 and less below it, so the
// block is bound by fp32 FMA issue at every level, and the fused TPU
// design (one pass per side of the SCA pool, g recomputed in pass B) would
// only trade bytes this card can afford for FLOPs it cannot: recomputing
// g costs another 4 C^2 (1 + halo) FLOPs a pixel (0.67 ms at peak for
// level 1), spilling g costs 2 C 4 bytes a pixel (0.42 ms). So g is
// spilled, and so is u (0.84 ms at level 1), which keeps the 1x1 products
// plain tiled GEMMs instead of halo-recomputed ones.
//
// Design: five launches over [P, C] rows (P = B H W), none of them a
// library call:
//   1. gemm: LN1 prologue (row stats per block), + b1          -> u [P, 2C]
//   2. gate: depthwise 3x3 on both halves, SimpleGate, and per-tile
//      channel sums of g (the SCA pool's partials)               -> g [P, C]
//   (the [B, C] SCA product runs between the two entries, in PyTorch)
//   3. gemm: g * s prologue, beta residual epilogue               -> y [P, C]
//   4. gemm: LN2 prologue, both gate halves in one block, product  -> g2
//   5. gemm: gamma residual epilogue                              -> out
// The gemm is a 64 x 64 output tile per block of 256 threads, each thread
// 4 x 4 (4 x 8 for the gate), over K in steps of 16 staged in shared
// memory (A transposed so a thread reads its 4 rows as one float4).
// Device-memory traffic is about 14 C 4 bytes a pixel, against ~25 C for
// the plain PyTorch composition.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64, BN = 64, BK = 16;
constexpr int kGateRun = 8;   // output rows per thread in the gate kernel
constexpr int kGateCols = 8;  // tile columns per gate block
constexpr int kGateCh = 32;   // channels per gate block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct GemmArgs {
  const float* A;         // [M, K]
  const float* W;         // [K, ldw]
  float* out;             // [M, N]
  int M, K, N, ldw;
  const float* ln_s;      // [K] or null: LayerNorm each row of A first
  const float* ln_b;
  float eps;
  const float* colscale;  // [M / rows_per_batch, K] or null: A * colscale
  int rows_per_batch;
  const float* bias;      // [ldw]
  const float* res;       // [M, N] or null: out = res + res_scale * value
  const float* res_scale; // [N]
};

// GATE: value[n] = (acc(W[:, n]) + bias[n]) * (acc(W[:, N + n]) + bias[N + n])
template <bool GATE>
__global__ void __launch_bounds__(kThreads) naf_gemm_kernel(GemmArgs p) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Ws[GATE ? 2 : 1][BK][BN];
  __shared__ float mu[BM], rs[BM];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  if (p.ln_s) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < BM; r += kThreads / 32) {
      const int m = m0 + r;
      float mean = 0.f, rstd = 0.f;
      if (m < p.M) {
        const float* a = p.A + (long long)m * p.K;
        float s = 0.f;
        for (int k = lane; k < p.K; k += 32) s += a[k];
        mean = warp_sum(s) / p.K;
        float q = 0.f;
        for (int k = lane; k < p.K; k += 32) {
          const float d = a[k] - mean;
          q += d * d;
        }
        rstd = rsqrtf(warp_sum(q) / p.K + p.eps);
      }
      if (lane == 0) {
        mu[r] = mean;
        rs[r] = rstd;
      }
    }
    __syncthreads();
  }

  float acc[4][4], acc2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = acc2[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, kk = e % BK;
      const int m = m0 + r, k = k0 + kk;
      float v = 0.f;
      if (m < p.M && k < p.K) {
        v = p.A[(long long)m * p.K + k];
        if (p.ln_s) v = (v - mu[r]) * rs[r] * p.ln_s[k] + p.ln_b[k];
        if (p.colscale)
          v *= p.colscale[(long long)(m / p.rows_per_batch) * p.K + k];
      }
      As[kk][r] = v;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, j = e % BN;
      const int k = k0 + kk, n = n0 + j;
      const bool ok = k < p.K && n < p.N;
      Ws[0][kk][j] = ok ? p.W[(long long)k * p.ldw + n] : 0.f;
      if (GATE) Ws[GATE ? 1 : 0][kk][j] = ok ? p.W[(long long)k * p.ldw + p.N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Ws[0][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      if (GATE) {
        const float4 c = *reinterpret_cast<const float4*>(&Ws[GATE ? 1 : 0][kk][tx * 4]);
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc2[i][j] = fmaf(av[i], cv[j], acc2[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= p.N) continue;
      float v = acc[i][j] + p.bias[n];
      if (GATE) v *= acc2[i][j] + p.bias[p.N + n];
      const long long o = (long long)m * p.N + n;
      if (p.res) v = fmaf(p.res_scale[n], v, p.res[o]);
      p.out[o] = v;
    }
  }
}

int gemm(const GemmArgs& a, bool gate, cudaStream_t stream) {
  const dim3 grid(unsigned((a.M + BM - 1) / BM), unsigned((a.N + BN - 1) / BN));
  if (gate)
    naf_gemm_kernel<true><<<grid, kThreads, 0, stream>>>(a);
  else
    naf_gemm_kernel<false><<<grid, kThreads, 0, stream>>>(a);
  return int(cudaGetLastError());
}

// g = (dw(u_a) + d_a) * (dw(u_b) + d_b) for a tile of kGateRun rows x
// kGateCols columns x kGateCh channels; threads: channel fastest, then
// column. Each thread walks its column down the tile with a 3 x 3 window
// of both halves in registers. partials [B, tiles, C] get the tile's
// channel sums of g.
__global__ void __launch_bounds__(kThreads)
naf_gate_kernel(const float* __restrict__ u, const float* __restrict__ dk,
                const float* __restrict__ db, float* __restrict__ g,
                float* __restrict__ partials, int H, int W, int C) {
  __shared__ float red[kThreads / kGateCh][kGateCh];
  const int cl = threadIdx.x % kGateCh, col = threadIdx.x / kGateCh;
  const int c = blockIdx.y * kGateCh + cl;
  const int tiles_x = (W + kGateCols - 1) / kGateCols;
  const int tile = blockIdx.x;
  const int y0 = (tile / tiles_x) * kGateRun;
  const int xx = (tile % tiles_x) * kGateCols + col;
  const int b = blockIdx.z;
  const int C2 = 2 * C;
  const float* ub = u + (long long)b * H * W * C2;
  float sum = 0.f;
  if (c < C && xx < W) {
    float ka[9], kb[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      ka[t] = dk[t * C2 + c];
      kb[t] = dk[t * C2 + C + c];
    }
    const float da = db[c], dbb = db[C + c];
    float wa[3][3], wb[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int d = 0; d < 3; ++d) wa[r][d] = wb[r][d] = 0.f;
#pragma unroll
    for (int r = 1; r < 3; ++r)
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int yy = y0 - 2 + r, xd = xx - 1 + d;
        if (yy >= 0 && yy < H && xd >= 0 && xd < W) {
          const float* px = ub + ((long long)yy * W + xd) * C2;
          wa[r][d] = px[c];
          wb[r][d] = px[C + c];
        }
      }
    for (int i = 0; i < kGateRun; ++i) {
      const int y = y0 + i;
      if (y >= H) break;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        wa[0][d] = wa[1][d];
        wa[1][d] = wa[2][d];
        wb[0][d] = wb[1][d];
        wb[1][d] = wb[2][d];
        const int xd = xx - 1 + d;
        float va = 0.f, vb = 0.f;
        if (y + 1 < H && xd >= 0 && xd < W) {
          const float* px = ub + ((long long)(y + 1) * W + xd) * C2;
          va = px[c];
          vb = px[C + c];
        }
        wa[2][d] = va;
        wb[2][d] = vb;
      }
      float sa = da, sb = dbb;
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          sa = fmaf(wa[r][d], ka[r * 3 + d], sa);
          sb = fmaf(wb[r][d], kb[r * 3 + d], sb);
        }
      const float v = sa * sb;
      g[(((long long)b * H + y) * W + xx) * C + c] = v;
      sum += v;
    }
  }
  red[col][cl] = sum;
  __syncthreads();
  if (col == 0 && c < C) {
    float s = 0.f;
    for (int k = 0; k < kThreads / kGateCh; ++k) s += red[k][cl];
    partials[((long long)b * gridDim.x + tile) * C + c] = s;
  }
}

}  // namespace

// Tiles per image of the gate kernel (the partials' middle axis).
extern "C" int ff_nafblock_tiles(int H, int W) {
  return ((H + kGateRun - 1) / kGateRun) * ((W + kGateCols - 1) / kGateCols);
}

// Pass A. x [B, H, W, C]; ln1 [C] x2; w1 [C, 2C]; b1 [2C]; u [B, H, W, 2C]
// (scratch); dk [3, 3, 2C]; db [2C]; g [B, H, W, C]; partials [B,
// ff_nafblock_tiles(H, W), C]. All fp32 contiguous.
extern "C" int ff_nafblock_gate(const float* x, const float* ln1_s,
                                const float* ln1_b, const float* w1,
                                const float* b1, float* u, const float* dk,
                                const float* db, float* g, float* partials,
                                int B, int H, int W, int C, float eps,
                                void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int M = B * H * W;
  GemmArgs a{x, w1, u, M, C, 2 * C, 2 * C, ln1_s, ln1_b, eps, nullptr, 1,
             b1, nullptr, nullptr};
  int err = gemm(a, false, stream);
  if (err) return err;
  const dim3 grid(unsigned(ff_nafblock_tiles(H, W)),
                  unsigned((C + kGateCh - 1) / kGateCh), unsigned(B));
  naf_gate_kernel<<<grid, kThreads, 0, stream>>>(u, dk, db, g, partials, H, W,
                                                 C);
  return int(cudaGetLastError());
}

// Pass B. g, x [B, H, W, C]; s [B, C]; w3 [C, C]; b3, beta [C]; y, g2
// (scratch) and out [B, H, W, C]; ln2 [C] x2; w4 [C, 2C]; b4 [2C]; w5 [C,
// C]; b5, gamma [C].
extern "C" int ff_nafblock_apply(const float* g, const float* s,
                                 const float* x, const float* w3,
                                 const float* b3, const float* beta, float* y,
                                 const float* ln2_s, const float* ln2_b,
                                 const float* w4, const float* b4, float* g2,
                                 const float* w5, const float* b5,
                                 const float* gamma, float* out, int B, int H,
                                 int W, int C, float eps, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int M = B * H * W;
  GemmArgs a3{g, w3, y, M, C, C, C, nullptr, nullptr, eps, s, H * W,
              b3, x, beta};
  int err = gemm(a3, false, stream);
  if (err) return err;
  GemmArgs a4{y, w4, g2, M, C, C, 2 * C, ln2_s, ln2_b, eps, nullptr, 1,
              b4, nullptr, nullptr};
  err = gemm(a4, true, stream);
  if (err) return err;
  GemmArgs a5{g2, w5, out, M, C, C, C, nullptr, nullptr, eps, nullptr, 1,
              b5, y, gamma};
  return gemm(a5, false, stream);
}
