// CAB, the conv-attention branch of GRL-B and MambaIR, over NHWC, fp32:
//   t   = LN(x) (optional, eps given) or x
//   u   = gelu(conv3x3(t) + b1)                 C -> C / cr
//   y   = conv3x3(u) + b2                       C / cr -> C
//   a   = sigmoid(W3 relu(W1 mean_hw(y) + c1) + c3)
//   out = y * a  (+ x * skip, optional)
// with exact (erf) GELU and zero padding at the image edges.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_cab.py: cab_fused
// (:174), which FREQFUSION_CAB=1 routes GRL-B's 40 CABs (C 180 -> 45,
// freqfusion_tpu/models/grl.py:340) and MambaIR's 36 ln_2 + CAB +
// skip_scale2 half-blocks (C 180 -> 60, freqfusion_tpu/models/mambair.py:423)
// through.
//
// What bounds it on the H100: the two convolutions, 36 C (C/cr) FLOPs per
// pixel (GRL: 5.0e10 at 336x512, 0.75 ms at 67 TFLOP/s fp32) against 8 C
// bytes of x and out (0.25 GB, 0.07 ms at 3.35 TB/s). fp32 FMA issue bounds
// it, as the two 3x3 products are implicit GEMMs with K = 9 Cin.
//
// The global pool makes it two passes, as on the TPU. The TPU kernel's pass
// B recomputes y from x; on this card that recomputation (another 0.75 ms
// of FMAs at peak) costs ten times what writing y and reading it back
// does (2 P C 4 bytes = 0.25 GB, 0.07 ms), so pass A stores y. The same
// count decides the intermediate u: it is a quarter of x's width, so the
// first conv writes it (2 P C/cr 4 bytes, 0.02 ms) rather than fusing both
// convs behind a 2-pixel halo, which would recompute the first conv on
// (8+2)(16+2)/(8 x 16) = 1.4x the pixels (+0.3 ms). So the call is three
// kernels: conv1 (LN prologue, GELU epilogue), conv2 (+ per-tile channel
// sums of y), then an elementwise pass that applies a and the skip. The
// squeeze MLP between the passes is [B, C]-sized plain PyTorch, as it is
// plain XLA in the JAX wrapper.
//
// Conv design: one block of 256 threads per TH x 16 output pixels and all
// output channels (<= 16 NC). Input channels are walked in chunks of 8: the
// chunk's (TH+2) x (16+2) halo and its 9 x 8 x Cout weights sit in shared
// memory; each thread accumulates TH pixels (one column of the tile) x NC
// channels (co = 64 g + 4 tc + j, read as float4s) in registers over the 9
// taps. TH is 16 for the narrow first conv (Cout <= 64, so a thread's 4
// channels meet 16 pixels per weight load) and 8 for the wide second. With
// LN, the halo pixels' mean and 1/std are computed first and applied as
// the chunks are staged. No cuDNN: the products are register-tiled loops.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 16;          // output tile columns (rows: TH)
constexpr int kHW = kTW + 2;     // input halo tile columns
constexpr int kCin = 8;          // input channels per chunk

// Output tile rows for Cout output channels.
__host__ __device__ constexpr int tile_rows(int nc) { return nc <= 4 ? 16 : 8; }
int rows_for(int cout) { return tile_rows((cout + 15) / 16); }

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct ConvArgs {
  const float* x;      // [B, H, W, Cin]
  const float* w;      // [3, 3, Cin, Cout]
  const float* bias;   // [Cout]
  const float* ln_s;   // [Cin] or null: LayerNorm the input first
  const float* ln_b;
  float* out;          // [B, H, W, Cout]
  float* partials;     // [B, tiles, Cout] or null: per-tile channel sums
  int H, W, Cin, Cout, gelu;
  float eps;
};

template <int NC>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(ConvArgs p) {
  constexpr int CP = 16 * NC, NG = NC / 4;
  constexpr int kTH = tile_rows(NC);
  constexpr int kHalo = (kTH + 2) * kHW;
  extern __shared__ __align__(16) float smem[];
  float* Wt = smem;                   // [9][kCin][CP]
  float* In = Wt + 9 * kCin * CP;     // [kHalo][kCin]
  float* mu = In + kHalo * kCin;      // [kHalo]
  float* rs = mu + kHalo;             // [kHalo]
  const int tid = threadIdx.x, tc = tid & 15, tp = tid >> 4;
  const int tiles_x = (p.W + kTW - 1) / kTW;
  const int tile = blockIdx.x;
  const int y0 = (tile / tiles_x) * kTH, x0 = (tile % tiles_x) * kTW;
  const int b = blockIdx.z;
  const float* xb = p.x + (long long)b * p.H * p.W * p.Cin;

  if (p.ln_s) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int q = warp; q < kHalo; q += kThreads / 32) {
      const int gy = y0 - 1 + q / kHW, gx = x0 - 1 + q % kHW;
      float m = 0.f, r = 0.f;
      if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
        const float* px = xb + ((long long)gy * p.W + gx) * p.Cin;
        float s = 0.f;
        for (int c = lane; c < p.Cin; c += 32) s += px[c];
        m = warp_sum(s) / p.Cin;
        float v = 0.f;
        for (int c = lane; c < p.Cin; c += 32) {
          const float d = px[c] - m;
          v += d * d;
        }
        r = rsqrtf(warp_sum(v) / p.Cin + p.eps);
      }
      if (lane == 0) {
        mu[q] = m;
        rs[q] = r;
      }
    }
  }

  float acc[kTH][NC];
#pragma unroll
  for (int i = 0; i < kTH; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[i][k] = 0.f;

  for (int c0 = 0; c0 < p.Cin; c0 += kCin) {
    __syncthreads();  // the previous chunk is consumed (and the LN stats are in)
    for (int e = tid; e < kHalo * kCin; e += kThreads) {
      const int q = e / kCin, kc = e % kCin, ci = c0 + kc;
      const int gy = y0 - 1 + q / kHW, gx = x0 - 1 + q % kHW;
      float v = 0.f;
      if (ci < p.Cin && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
        v = xb[((long long)gy * p.W + gx) * p.Cin + ci];
        if (p.ln_s) v = (v - mu[q]) * rs[q] * p.ln_s[ci] + p.ln_b[ci];
      }
      In[e] = v;
    }
    for (int e = tid; e < 9 * kCin * CP; e += kThreads) {
      const int co = e % CP, r = e / CP, kc = r % kCin, tap = r / kCin;
      const int ci = c0 + kc;
      Wt[e] = (ci < p.Cin && co < p.Cout)
                  ? p.w[((long long)tap * p.Cin + ci) * p.Cout + co] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll 1
      for (int kc = 0; kc < kCin; ++kc) {
        float a[kTH];
#pragma unroll
        for (int i = 0; i < kTH; ++i)
          a[i] = In[((i + dy) * kHW + tp + dx) * kCin + kc];
        const float* wrow = Wt + (tap * kCin + kc) * CP + 4 * tc;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 w4 = *reinterpret_cast<const float4*>(wrow + 64 * g);
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int i = 0; i < kTH; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][4 * g + j] = fmaf(a[i], wv[j], acc[i][4 * g + j]);
        }
      }
    }
  }

  const int gx = x0 + tp;
  float colsum[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int co = 64 * (k / 4) + 4 * tc + k % 4;
    const float bias = co < p.Cout ? p.bias[co] : 0.f;
    colsum[k] = 0.f;
#pragma unroll
    for (int i = 0; i < kTH; ++i) {
      const int gy = y0 + i;
      float v = acc[i][k] + bias;
      if (p.gelu) v = gelu_erf(v);
      if (co < p.Cout && gy < p.H && gx < p.W) {
        p.out[(((long long)b * p.H + gy) * p.W + gx) * p.Cout + co] = v;
        colsum[k] += v;
      }
    }
  }
  if (p.partials) {
    // sum over the 16 tile columns: the two of a warp by shuffle, the
    // eight warps through shared memory (the weight tile is free now)
    __syncthreads();
    float* red = Wt;  // [8][CP]
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const float s = colsum[k] + __shfl_xor_sync(0xffffffffu, colsum[k], 16);
      if ((tp & 1) == 0) red[(tp >> 1) * CP + 64 * (k / 4) + 4 * tc + k % 4] = s;
    }
    __syncthreads();
    const int tiles = gridDim.x;
    for (int co = tid; co < p.Cout; co += kThreads) {
      float s = 0.f;
      for (int w8 = 0; w8 < kThreads / 32; ++w8) s += red[w8 * CP + co];
      p.partials[((long long)b * tiles + tile) * p.Cout + co] = s;
    }
  }
}

template <int NC>
int launch_conv(const ConvArgs& a, int B, cudaStream_t stream) {
  constexpr int kTH = tile_rows(NC);
  constexpr int kHalo = (kTH + 2) * kHW;
  const size_t smem =
      (size_t(kHalo) * kCin + size_t(9) * kCin * 16 * NC + 2 * kHalo) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned(((a.H + kTH - 1) / kTH) * ((a.W + kTW - 1) / kTW)),
                  1, unsigned(B));
  conv3x3_kernel<NC><<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

int conv(const ConvArgs& a, int B, cudaStream_t stream) {
  const int nc = (a.Cout + 15) / 16;
  if (nc <= 4) return launch_conv<4>(a, B, stream);
  if (nc <= 8) return launch_conv<8>(a, B, stream);
  if (nc <= 12) return launch_conv<12>(a, B, stream);
  if (nc <= 16) return launch_conv<16>(a, B, stream);
  return int(cudaErrorInvalidValue);
}

// out = y * a[b, c] (+ x * skip[c])
__global__ void __launch_bounds__(kThreads)
cab_scale_kernel(const float* __restrict__ y, const float* __restrict__ a,
                 const float* __restrict__ x, const float* __restrict__ skip,
                 float* __restrict__ out, long long per_batch, int C,
                 long long total) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const int c = int(e % C);
    const long long b = e / per_batch;
    float v = y[e] * a[b * C + c];
    if (skip) v = fmaf(x[e], skip[c], v);
    out[e] = v;
  }
}

}  // namespace

// Tiles per image of the conv kernel with C output channels (the
// partials' middle axis).
extern "C" int ff_cab_tiles(int H, int W, int C) {
  const int th = rows_for(C);
  return ((H + th - 1) / th) * ((W + kTW - 1) / kTW);
}

// Pass A. x [B, H, W, C]; w1 [3, 3, C, Cr]; b1 [Cr]; ln_s/ln_b [C] or
// null; u [B, H, W, Cr] (scratch); w2 [3, 3, Cr, C]; b2 [C]; y [B, H, W,
// C]; partials [B, ff_cab_tiles(H, W, C), C]. C, Cr <= 256. All fp32
// contiguous.
extern "C" int ff_cab_pool(const float* x, const float* w1, const float* b1,
                           const float* ln_s, const float* ln_b, float* u,
                           const float* w2, const float* b2, float* y,
                           float* partials, int B, int H, int W, int C, int Cr,
                           float eps, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  ConvArgs a1{x, w1, b1, ln_s, ln_b, u, nullptr, H, W, C, Cr, 1, eps};
  int err = conv(a1, B, stream);
  if (err) return err;
  ConvArgs a2{u, w2, b2, nullptr, nullptr, y, partials, H, W, Cr, C, 0, eps};
  return conv(a2, B, stream);
}

// Pass B. y, x, out [B, H, W, C]; a [B, C]; skip [C] or null (x unused).
extern "C" int ff_cab_apply(const float* y, const float* a, const float* x,
                            const float* skip, float* out, int B, int H, int W,
                            int C, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long per_batch = (long long)H * W * C;
  const long long total = per_batch * B;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  cab_scale_kernel<<<unsigned(blocks), kThreads, 0, stream>>>(
      y, a, x, skip, out, per_batch, C, total);
  return int(cudaGetLastError());
}
