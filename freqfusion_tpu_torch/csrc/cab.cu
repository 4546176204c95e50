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
// pixel (GRL: 5.0e10 at 336x512, 0.75 ms on the fp32 cores at 67 TFLOP/s)
// against 8 C bytes of x and out (0.25 GB, 0.07 ms at 3.35 TB/s). The old
// register-tiled FMA body took 7.31 ms over chip_smoke.py's two shapes
// (fp32-core bound 1.75), held by FMA issue. So both convolutions run on
// the tensor cores in 3xTF32 (tf32_mma.cuh), as implicit GEMMs: M a tile
// of output pixels, N the output channels, K = 9 Cin taken tap by tap
// (3 x 117 GFLOP / 495 TFLOP/s = 0.71 ms over the two shapes). This body
// takes 3.27-3.29 ms there on an H100 at 700 W, the convs at ~120-180
// TFLOP/s of tensor work: a stage's halo copy, LayerNorm and split run
// in step across the block between its barriers, MambaIR's first conv
// (Cout 60) repeats them for its two 32-channel blocks, and each block's
// LN prologue and epilogue are exposed. Tried and not kept (phase 2, two
// shapes): one block of 8 warps an SM with 48- or 64-channel blocks and
// the halo split from a raw buffer into padded planes (3.85 ms), a
// three-stage ring split in place (3.55), the weights copied 16 bytes a
// thread (3.51, two blocks an SM).
//
// The global pool makes it two passes, as on the TPU. The TPU kernel's pass
// B recomputes y from x; on this card writing y and reading it back (2 P C
// 4 bytes, 0.07 ms) costs less than the second conv again, so pass A
// stores y. The same count decides the intermediate u: it is a quarter of
// x's width, so the first conv writes it rather than fusing both convs
// behind a 2-pixel halo. So pass A is three launches (the weights split,
// conv1 with the LN prologue and the GELU epilogue, conv2 with per-tile
// channel sums of y), then the squeeze MLP on [B, C] in PyTorch, then pass
// B, an elementwise kernel that applies a and the skip.
//
// Conv design: a block of 8 warps takes a 16 x 16 tile of output pixels
// and 8 NT output channels (NT 4 or 6: 32 or 48; wider convs take several
// blocks), two blocks an SM; warp w owns output rows 2w and 2w + 1 (one
// m-tile each: the tile's 16 columns are an m-tile's 16 rows) and all the
// block's n-tiles. Input channels go 8 a stage (one k8 step a tap) through
// a two-stage ring, one barrier a stage: the stage's 18 x 18 halo lands in
// its hi plane by cp.async (zeros outside the image and past Cin), then
// each thread normalises (LN) and splits in place the pieces it copied
// itself, hi over the copy and lo in a plane beside it; the stage's
// weights for all 9 taps, split once a call by the first launch into
// fragment order (a lane's B fragment, hi and lo, is one 16-byte load; a
// block's stage one contiguous piece), land by one bulk copy on the
// stage's mbarrier. A tap's A fragment is the halo shifted by (dy, dx).
// The k8 block's channels are permuted (fragment column t is channel 2t,
// t + 4 is 2t + 1, in the weights' split as in the halo's read), so a
// lane reads a pixel's two channels as one 8-byte load, free of bank
// conflicts at a pixel stride of 8 floats. With LN, each halo pixel's
// mean and 1/std are computed first, one warp a pixel from registers,
// while stage 0's copies are in flight. No cuDNN.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_wgmma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 16, kTW = 16;          // output tile rows, columns
constexpr int kHW = kTW + 2;               // halo columns
constexpr int kHalo = (kTH + 2) * kHW;     // halo pixels (324)
constexpr int kCK = 8;                     // input channels a stage
constexpr int kLdH = kCK;                  // halo hi/lo pixel stride
constexpr int kHaloPieces = kHalo * kCK / 4;  // 4-float pieces a stage
constexpr int kMaxCin = 256;               // the LN prologue's registers
constexpr int kStages = 2;                 // the cp.async ring

// n-tiles a block for Cout output channels: 4 or 6 (32 or 48 channels),
// whichever pads Cout less, 6 on a tie.
__host__ __device__ inline int conv_tiles(int cout) {
  return (cout + 31) / 32 * 32 < (cout + 47) / 48 * 48 ? 4 : 6;
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// HWIO weights [3, 3, cin, cout], zero-padded, split into fragment order
// over [coutp / (8 nt) blocks][cinp / 8][9 taps][nt][32 lanes][4]: unit u
// is lane (g, t) of a (block, k8 block, tap, n-tile), its hi W[2t][g], hi
// W[2t + 1][g], then the two lo, so a product reads a lane's B fragment
// with one 16-byte load and a block's stage is one contiguous piece.
// The k8 block's channels go in the order 0, 2, 4, 6, 1, 3, 5, 7
// (fragment row t is channel 2t, row t + 4 channel 2t + 1), the order in
// which a lane reads the halo: two adjacent channels, one 8-byte load.
__device__ __forceinline__ void split_conv_weight(const float* __restrict__ w,
                                                  float* __restrict__ fr,
                                                  int cin, int cout, int cinp,
                                                  int nt, long long u) {
  const int lane = int(u % 32), g = lane / 4, t = lane % 4;
  long long blk = u / 32;
  const int ntl = int(blk % nt);
  blk /= nt;
  const int tap = int(blk % 9);
  blk /= 9;
  const int kb = int(blk % (cinp / 8)), nb = int(blk / (cinp / 8));
  const int ci = 8 * kb + 2 * t, co = 8 * (nb * nt + ntl) + g;
  const float* wt = w + (long long)tap * cin * cout;
  const float v0 = ci < cin && co < cout ? wt[(long long)ci * cout + co] : 0.f;
  const float v1 =
      ci + 1 < cin && co < cout ? wt[(long long)(ci + 1) * cout + co] : 0.f;
  uint4 o;
  split_tf32(v0, o.x, o.z);
  split_tf32(v1, o.y, o.w);
  *reinterpret_cast<uint4*>(fr + 4 * u) = o;
}

__global__ void __launch_bounds__(kThreads)
cab_split_weights(const float* __restrict__ w1, const float* __restrict__ w2,
                  float* __restrict__ fr1, float* __restrict__ fr2, int C,
                  int Cr, int cinp1, int coutp1, int cinp2, int coutp2) {
  const long long n1 = 9LL * cinp1 * coutp1 / 2;  // units: 64 floats / 8 x 8
  const long long n2 = 9LL * cinp2 * coutp2 / 2;
  for (long long u = blockIdx.x * (long long)kThreads + threadIdx.x;
       u < n1 + n2; u += (long long)gridDim.x * kThreads) {
    if (u < n1)
      split_conv_weight(w1, fr1, C, Cr, cinp1, conv_tiles(Cr), u);
    else
      split_conv_weight(w2, fr2, Cr, C, cinp2, conv_tiles(C), u - n1);
  }
}

struct ConvArgs {
  const float* x;      // [B, H, W, Cin]
  const float* w;      // split weights, fragment order (above)
  const float* bias;   // [Cout]
  const float* ln_s;   // [Cin] or null: LayerNorm the input first
  const float* ln_b;
  float* out;          // [B, H, W, Cout]
  float* partials;     // [B, tiles, Cout] or null: per-tile channel sums
  int H, W, Cin, Cout, cinp, coutp, gelu, vec;
  float eps;
};

template <int NT>
struct ConvShape {
  static constexpr int kN = 8 * NT;            // output channels a block
  static constexpr int kPlaneH = kHalo * kLdH;  // the halo's hi (or lo)
  static constexpr int kW = 9 * NT * 128;      // 9 taps' B fragments
  static constexpr int kStage = 2 * kPlaneH + kW;
  static constexpr size_t smem_bytes() {  // + an mbarrier a stage
    return (kStages * size_t(kStage) + 2 * kHalo) * sizeof(float) +
           kStages * sizeof(uint64_t);
  }
};

template <int NT>
__global__ void __launch_bounds__(kThreads, 2) cab_conv_kernel(ConvArgs p) {
  using S = ConvShape<NT>;
  constexpr int kN = S::kN;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* mu = smem + kStages * S::kStage;  // [kHalo]
  float* rs = mu + kHalo;            // [kHalo]
  uint64_t* full = reinterpret_cast<uint64_t*>(rs + kHalo);  // [kStages]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tiles_x = (p.W + kTW - 1) / kTW;
  const int tile = blockIdx.x;
  const int y0 = (tile / tiles_x) * kTH, x0 = (tile % tiles_x) * kTW;
  const int n0 = blockIdx.y * kN;
  const int b = blockIdx.z;
  const float* xb = p.x + (long long)b * p.H * p.W * p.Cin;
  auto hh = [&](int b) { return smem + b * S::kStage; };
  auto wh = [&](int b) { return smem + b * S::kStage + 2 * S::kPlaneH; };
  auto in_image = [&](int q, int& gy, int& gx) {
    gy = y0 - 1 + q / kHW;
    gx = x0 - 1 + q % kHW;
    return gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
  };

  // Stage s: the halo's channels [8 s, 8 s + 8) into the hi plane (thread
  // tid owns the pieces tid + i kThreads: pixel q / 2, channels 4 (q % 2)
  // + 0..3), and (thread 0, one bulk copy on the stage's mbarrier) the
  // block's B fragments of all 9 taps.
  auto copy_stage = [&](int s) {
    const int c0 = s * kCK;
    float* r = hh(s % kStages);
    for (int q = tid; q < kHaloPieces; q += kThreads) {
      const int px = q / 2, c = 4 * (q % 2);
      int gy, gx;
      const bool in = in_image(px, gy, gx);
      const float* src = xb + ((long long)gy * p.W + gx) * p.Cin + c0 + c;
      if (p.vec) {
        const bool ok = in && c0 + c < p.Cin;
        cp_async16(r + px * kLdH + c, ok ? src : p.x, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = in && c0 + c + j < p.Cin;
          cp_async4(r + px * kLdH + c + j, ok ? src + j : p.x, ok);
        }
      }
    }
    if (tid == 0) {
      constexpr uint32_t kBytes = 4 * S::kW;
      uint64_t* bar = &full[s % kStages];
      fence_proxy_async();
      mbar_arrive_expect_tx(bar, kBytes);
      bulk_copy(wh(s % kStages),
                p.w + ((long long)blockIdx.y * (p.cinp / kCK) + s) * S::kW,
                kBytes, bar);
    }
  };

  // This thread's pieces of stage s, normalised (LN) and split in place:
  // hi over the copy, lo in the plane beside it.
  auto split_stage = [&](int s) {
    const int c0 = s * kCK;
    float* h = hh(s % kStages);
    for (int q = tid; q < kHaloPieces; q += kThreads) {
      const int px = q / 2, c = 4 * (q % 2);
      float v[4];
      *reinterpret_cast<float4*>(v) =
          *reinterpret_cast<const float4*>(h + px * kLdH + c);
      if (p.ln_s) {
        int gy, gx;
        const bool in = in_image(px, gy, gx);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = c0 + c + j;
          v[j] = in && ci < p.Cin
                     ? fmaf((v[j] - mu[px]) * rs[px], p.ln_s[ci], p.ln_b[ci])
                     : 0.f;
        }
      }
      uint4 hi, lo;
      split_tf32(v[0], hi.x, lo.x);
      split_tf32(v[1], hi.y, lo.y);
      split_tf32(v[2], hi.z, lo.z);
      split_tf32(v[3], hi.w, lo.w);
      *reinterpret_cast<uint4*>(h + px * kLdH + c) = hi;
      *reinterpret_cast<uint4*>(h + S::kPlaneH + px * kLdH + c) = lo;
    }
  };

  const int stages = p.cinp / kCK;
  if (tid == 0) {
    for (int b = 0; b < kStages; ++b) mbar_init(&full[b], 1);
    mbar_init_fence();
  }
  __syncthreads();
  copy_stage(0);
  cp_async_commit();
  if (p.ln_s) {  // each halo pixel's mean and 1/std, one warp a pixel
    for (int q = warp; q < kHalo; q += kThreads / 32) {
      int gy, gx;
      float m = 0.f, r = 0.f;
      if (in_image(q, gy, gx)) {
        const float* px = xb + ((long long)gy * p.W + gx) * p.Cin;
        float v[kMaxCin / 32];
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxCin / 32; ++i) {
          const int c = lane + 32 * i;
          v[i] = c < p.Cin ? px[c] : 0.f;
          s += v[i];
        }
        m = warp_sum(s) / p.Cin;
        float d2 = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxCin / 32; ++i) {
          const float d = lane + 32 * i < p.Cin ? v[i] - m : 0.f;
          d2 += d * d;
        }
        r = rsqrtf(warp_sum(d2) / p.Cin + p.eps);
      }
      if (lane == 0) {
        mu[q] = m;
        rs[q] = r;
      }
    }
    __syncthreads();
  }

  float acc[NT][2][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.f;

  for (int s = 0; s < stages; ++s) {
    cp_async_wait<0>();  // this thread's copies of stage s
    split_stage(s);
    mbar_wait(&full[s % kStages], (s / kStages) & 1);  // its weights
    __syncthreads();  // stage s is in; stage s - 1's products are done
    if (s + 1 < stages) copy_stage(s + 1);
    cp_async_commit();
    const float* ah = hh(s % kStages);
    const float* al = ah + S::kPlaneH;
    const float* w = wh(s % kStages);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // lane (g, t): pixels g and g + 8 of the m-tile's row, channels
      // 2t and 2t + 1 (fragment columns t and t + 4)
      uint32_t fh[2][4], fl[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int o = ((2 * warp + mt + dy) * kHW + g + dx) * kLdH + 2 * t;
        const uint2 h0 = *reinterpret_cast<const uint2*>(ah + o);
        const uint2 h1 = *reinterpret_cast<const uint2*>(ah + o + 8 * kLdH);
        const uint2 l0 = *reinterpret_cast<const uint2*>(al + o);
        const uint2 l1 = *reinterpret_cast<const uint2*>(al + o + 8 * kLdH);
        fh[mt][0] = h0.x, fh[mt][1] = h1.x, fh[mt][2] = h0.y, fh[mt][3] = h1.y;
        fl[mt][0] = l0.x, fl[mt][1] = l1.x, fl[mt][2] = l0.y, fl[mt][3] = l1.y;
      }
      const float* wt = w + tap * NT * 128 + 4 * lane;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint4 f = *reinterpret_cast<const uint4*>(wt + 128 * (j + q));
          bh[q][0] = f.x, bh[q][1] = f.y, bl[q][0] = f.z, bl[q][1] = f.w;
        }
        mma_3xtf32_split(*reinterpret_cast<float(*)[2][2][4]>(&acc[j]), fh,
                         fl, bh, bl);
      }
    }
  }

  // epilogue: + bias (GELU), store, and the columns' sums for the pool
  float colsum[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = n0 + 8 * j + 2 * t + e;
      const float bias = co < p.Cout ? p.bias[co] : 0.f;
      colsum[j][e] = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gy = y0 + 2 * warp + mt, gx = x0 + g + 8 * h;
          float v = acc[j][mt][2 * h + e] + bias;
          if (p.gelu) v = gelu_erf(v);
          if (co < p.Cout && gy < p.H && gx < p.W) {
            p.out[(((long long)b * p.H + gy) * p.W + gx) * p.Cout + co] = v;
            colsum[j][e] += v;
          }
        }
    }
  if (p.partials) {
    // over the warp's pixels (the 8 lanes of a t) by shuffles, over the
    // 8 warps through shared memory (the stage buffers are free now)
    __syncthreads();
    float* red = smem;  // [8][kN]
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = colsum[j][e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (g == 0) red[warp * kN + 8 * j + 2 * t + e] = s;
      }
    __syncthreads();
    for (int c = tid; c < kN && n0 + c < p.Cout; c += kThreads) {
      float s = 0.f;
      for (int w8 = 0; w8 < kThreads / 32; ++w8) s += red[w8 * kN + c];
      p.partials[((long long)b * gridDim.x + tile) * p.Cout + n0 + c] = s;
    }
  }
}

template <int NT>
int launch_conv(const ConvArgs& a, int B, cudaStream_t stream) {
  const size_t smem = ConvShape<NT>::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      cab_conv_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned(((a.H + kTH - 1) / kTH) * ((a.W + kTW - 1) / kTW)),
                  unsigned(a.coutp / (8 * NT)), unsigned(B));
  cab_conv_kernel<NT><<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

int conv(const ConvArgs& a, int B, cudaStream_t stream) {
  if (conv_tiles(a.Cout) == 4) return launch_conv<4>(a, B, stream);
  return launch_conv<6>(a, B, stream);
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

// The padded extents of both convs' split weights.
struct CabPlan {
  int cinp1, coutp1, cinp2, coutp2;
};

CabPlan cab_plan(int C, int Cr) {
  return {round_up(C, kCK), round_up(Cr, 8 * conv_tiles(Cr)),
          round_up(Cr, kCK), round_up(C, 8 * conv_tiles(C))};
}

}  // namespace

// Tiles per image of the conv kernels (the partials' middle axis); C is
// not used (every width takes 16 x 16 tiles).
extern "C" int ff_cab_tiles(int H, int W, int C) {
  (void)C;
  return ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
}

// Floats of scratch ff_cab_pool needs: both convs' weights split, 18 cinp
// coutp floats each.
extern "C" long long ff_cab_scratch_floats(int C, int Cr) {
  const CabPlan q = cab_plan(C, Cr);
  return 18LL * q.cinp1 * q.coutp1 + 18LL * q.cinp2 * q.coutp2;
}

// Pass A. x [B, H, W, C]; w1 [3, 3, C, Cr]; b1 [Cr]; ln_s/ln_b [C] or
// null; u [B, H, W, Cr] (scratch); w2 [3, 3, Cr, C]; b2 [C]; y [B, H, W,
// C]; partials [B, ff_cab_tiles(H, W, C), C]; scratch of
// ff_cab_scratch_floats(C, Cr) floats, 16-byte aligned. C, Cr <= 256. All
// fp32 contiguous.
extern "C" int ff_cab_pool(const float* x, const float* w1, const float* b1,
                           const float* ln_s, const float* ln_b, float* u,
                           const float* w2, const float* b2, float* y,
                           float* partials, float* scratch,
                           long long scratch_floats, int B, int H, int W,
                           int C, int Cr, float eps, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (C > kMaxCin || Cr > kMaxCin || C <= 0 || Cr <= 0 ||
      scratch_floats < ff_cab_scratch_floats(C, Cr) ||
      reinterpret_cast<size_t>(scratch) % 16 || B > 65535)
    return int(cudaErrorInvalidValue);
  const CabPlan q = cab_plan(C, Cr);
  float* hl1 = scratch;
  float* hl2 = scratch + 18LL * q.cinp1 * q.coutp1;
  cab_split_weights<<<132, kThreads, 0, stream>>>(
      w1, w2, hl1, hl2, C, Cr, q.cinp1, q.coutp1, q.cinp2, q.coutp2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  auto vec = [](const float* t, int c) {
    return c % 4 == 0 && reinterpret_cast<size_t>(t) % 16 == 0;
  };
  ConvArgs a1{x, hl1, b1, ln_s, ln_b, u, nullptr, H, W, C, Cr,
              q.cinp1, q.coutp1, 1, vec(x, C), eps};
  int err = conv(a1, B, stream);
  if (err) return err;
  ConvArgs a2{u, hl2, b2, nullptr, nullptr, y, partials, H, W, Cr, C,
              q.cinp2, q.coutp2, 0, vec(u, Cr), eps};
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

// ---------------------------------------------------------------------
// The bf16 version (FREQFUSION_EXPERT_DTYPE=bf16): x, the weights and the
// vectors bf16, with the JAX kernel's rounding points (pallas_cab.py:
// _conv_bank :62, _y_tile :74-86, _apply_kernel :99-110): the conv input
// (LN(x) in fp32, or x) rounded to bf16 before conv1's nine taps, zero
// outside the image after the LN (:80-81), the GELU of conv1 + b1 (fp32)
// rounded before conv2's, y = conv2 + b2 kept in fp32 (JAX recomputes it
// in fp32 in its apply pass), the pool and the squeeze MLP in fp32, the
// output y a + x skip rounded once.
//
// What bounds it on the H100: the two convs, 18 C Cr FLOPs a pixel each
// (25 GFLOP at GRL-B's 336x512, 33 at MambaIR's: ~0.03 ms each at 989
// TFLOP/s), and the bytes: x in, U out and in, y out and in (fp32), out.
// Both convs run on bf16_wgmma.cuh's wgmma from the input side, as the
// JAX kernel runs nine dots of one resident operand (_conv_bank :56-71):
// a block stages the halo of its output rows once, [8-channel group]
// [halo pixel][8 values], so that eight consecutive pixels of a halo row
// are one core matrix (128 contiguous bytes); the A operand of tap (dy,
// dx) for 64 consecutive output pixels of one row is then the same
// staged halo seen through a descriptor whose start moves by (dy (64 + 2)
// + dx) 16 bytes (lbo the halo's pixels x 16, sbo 128): no im2col, no
// gather. The weights are laid out once per module
// (ops/wgmma.py:conv_layout: [Cout chunk][Cin / 16][tap][core matrices])
// and streamed by bulk copies through an mbarrier ring. One consumer
// warpgroup a block, two blocks an SM:
//   conv1  4 output rows x 64 columns a block at N 48, 3 at N 64 (halo
//          6 x 66 or 5 x 66: 1.55 or 1.72 reads a pixel; 96 sums a thread
//          either way, and more leave no room for the staging warpgroup's
//          registers at two blocks an SM). The halo goes 16 channels at a
//          time through a ring of three slices that a staging warpgroup
//          fills (x's 16 channels, LN'd with each pixel's statistics,
//          taken first by every thread, eight a pixel), its registers
//          given to the consumers by setmaxnreg, while the consumer
//          warpgroup's wgmmas run; N is Cr padded to 16 (wgmma n48 for
//          GRL-B's 45, n64 for
//          MambaIR's 60); epilogue + b1, GELU, rounded, into shared tiles
//          (the drained ring) and out by one bulk store an output row: U
//          [M][48 or 64] bf16, rows of 16-byte multiples;
//   conv2  6 output rows x 64 columns a block (halo 8 x 66, 1.375 reads a
//          pixel; a producer warp streams the weights), the whole halo of
//          U staged once by 16-byte cp.async
//          (zeros outside the image); two rows at a time x 96 output
//          channels a pass (96 sums a thread), the weights' three taps of
//          one dy and 16 channels a stage; epilogue + b2, y in fp32 (whole
//          32-byte sectors from the fragments) and the block's channel
//          sums, deterministic partials [B, tiles, C], no atomics;
//   the [B, C] squeeze MLP in PyTorch, as for fp32;
//   apply  out = bf16(y a + x skip), an elementwise pass.

namespace {

constexpr int kCabSeg = 64;             // output pixels an m-tile: a row's
constexpr int kCabHw = kCabSeg + 2;     // halo columns
// conv1's output rows (m-tiles) a block: 4 at N 48, 3 at N 64, so that the
// sums stay at 96 a thread
template <int BN>
__host__ __device__ constexpr int c1_rows() { return BN == 64 ? 3 : 4; }
constexpr int kC2Rows = 6;              // conv2's, two at a time
constexpr int kC2Halo = (kC2Rows + 2) * kCabHw;  // 528
constexpr int kC1Stages = 3;            // a 16-channel slice of 9 taps
constexpr int kC1Slots = 3;             // staged halo slices in flight
constexpr int kC2Stages = 4;            // a 16-channel slice of 3 taps
constexpr int kC2Bn = 96;               // conv2's output channels a pass
constexpr int kCabConsumers = 128;      // one consumer warpgroup
constexpr int kCabMaxC = 256;           // the LN statistics' registers
constexpr int kCabMaxCr = 64;

// conv1's N (and conv2's K, U's row): Cr padded to 48 or 64.
inline int cab_bn1(int cr) { return cr <= 48 ? 48 : 64; }

inline int cab_c1_rows(int Cr) { return cab_bn1(Cr) == 64 ? 3 : 4; }

inline int cab_conv1_smem(int C, int Cr) {
  const int bn = cab_bn1(Cr), cinp = bw_up(C, 16);
  const int halo = (cab_c1_rows(Cr) + 2) * kCabHw;
  return kBwHead + kC1Stages * 9 * 16 * bn * 2 + kC1Slots * halo * 32 +
         2 * kC1Slots * 8 + halo * 8 + 2 * cinp * 4 + bn * 4;
}

inline int cab_conv2_smem(int C, int Cr) {
  const int np = bw_up(C, kC2Bn);
  return kBwHead + kC2Stages * 3 * 16 * kC2Bn * 2 +
         kC2Halo * cab_bn1(Cr) * 2 + 2 * np * 4 + 4 * kC2Bn * 4;
}

inline int cab_tiles(int H, int W, int rows) {
  return (H + rows - 1) / rows * ((W + kCabSeg - 1) / kCabSeg);
}

struct CabConv1Args {
  const __nv_bfloat16* x;  // [B, H, W, C]
  const void* w;           // W1's layout at BN: [cinp / 16][9][BN / 8][2][8][8]
  const __nv_bfloat16 *bias, *ln_s, *ln_b;  // [Cr]; [C] or null
  __nv_bfloat16* u;        // [B, H, W, BN]
  int H, W, C, Cr, cinp, tiles_x;
  float eps;
};

// U = bf16(gelu(conv3x3(T) + b1)), T = bf16(LN(x)) or x, zero outside.
// Every thread first takes the halo pixels' LN statistics; then two
// warpgroups: the consumers (wgmma and the epilogue; 152 registers a
// thread for 96 sums) and a producer warpgroup at 104 that stages the
// halo 16 channels a slice into a ring of kC1Slots slices
// (full/empty mbarriers), its first thread issuing each slice's weights
// (the nine taps, one bulk copy) ahead of it, so that staging runs
// beside the wgmmas, not in turn with them.
template <int BN>
__global__ void __launch_bounds__(2 * kCabConsumers, 2)
cab_conv1_kernel(const CabConv1Args a) {
  extern __shared__ __align__(128) unsigned char cab_smem[];
  constexpr int kC1Rows = c1_rows<BN>();
  constexpr int kC1Halo = (kC1Rows + 2) * kCabHw;  // 396 or 330 pixels
  constexpr int kStage = 9 * 16 * BN * 2;
  constexpr int kSlice = kC1Halo * 32;  // two 8-channel groups
  constexpr int kStagers = kCabConsumers;
  BwRing r = bw_ring(cab_smem, kStage, kCabConsumers / 32, kC1Stages);
  unsigned char* hb = r.buf + kC1Stages * kStage;
  uint64_t* sfull = reinterpret_cast<uint64_t*>(hb + kC1Slots * kSlice);
  uint64_t* sempty = sfull + kC1Slots;
  float2* stats = reinterpret_cast<float2*>(sempty + kC1Slots);
  float* lns = reinterpret_cast<float*>(stats + kC1Halo);
  float* lnb = lns + a.cinp;
  float* bs = lnb + a.cinp;
  const int tid = threadIdx.x, ns = a.cinp / 16, C = a.C;
  if (tid == 0) {
    for (int i = 0; i < kC1Slots; ++i) {
      mbar_init(&sfull[i], kStagers / 32);
      mbar_init(&sempty[i], kCabConsumers / 32);
    }
    mbar_init_fence();
  }
  bw_vector(bs, a.bias, a.Cr, BN, tid, 2 * kCabConsumers);
  if (a.ln_s) {
    bw_vector(lns, a.ln_s, C, a.cinp, tid, 2 * kCabConsumers);
    bw_vector(lnb, a.ln_b, C, a.cinp, tid, 2 * kCabConsumers);
  }
  __syncthreads();
  const int y0 = (blockIdx.x / a.tiles_x) * kC1Rows;
  const int x0 = (blockIdx.x % a.tiles_x) * kCabSeg;
  const long long img = (long long)blockIdx.y * a.H * a.W;
  auto pixel = [&](int p) -> long long {  // halo pixel p, -1 outside
    const int y = y0 - 1 + p / kCabHw, x = x0 - 1 + p % kCabHw;
    return y < 0 || y >= a.H || x < 0 || x >= a.W
               ? -1LL
               : img + (long long)y * a.W + x;
  };
  if (a.ln_s) {
    // each halo pixel's mean and 1 / std, all threads, eight a pixel
    // (groups of 8 channels sub, sub + 8, ...), two passes over the raw
    // bf16 kept in registers; two rounds of 32 pixels' loads in flight
    constexpr int kRounds = 2, kG = kCabMaxC / 64;
    constexpr int kPer = 2 * kCabConsumers / 8;
    const int sub = tid & 7;
    for (int p0 = 0; p0 < kC1Halo; p0 += kRounds * kPer) {
      uint4 raw[kRounds][kG];
#pragma unroll
      for (int rr = 0; rr < kRounds; ++rr) {
        const int p = p0 + rr * kPer + (tid >> 3);
        const long long px = p < kC1Halo ? pixel(p) : -1LL;
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          const int q = sub + 8 * i;
          raw[rr][i] = px < 0 ? make_uint4(0, 0, 0, 0)
                              : bw_load8(a.x + px * C + 8 * q, C - 8 * q);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRounds; ++rr) {
        const int p = p0 + rr * kPer + (tid >> 3);
        float v[8];
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          bw_get8(v, &raw[rr][i]);
#pragma unroll
          for (int k = 0; k < 8; ++k) sum += v[k];
        }
        sum += __shfl_xor_sync(~0u, sum, 1);
        sum += __shfl_xor_sync(~0u, sum, 2);
        sum += __shfl_xor_sync(~0u, sum, 4);
        const float mu = sum / C;
        float d2 = 0.f;
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          bw_get8(v, &raw[rr][i]);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float d = 8 * (sub + 8 * i) + k < C ? v[k] - mu : 0.f;
            d2 += d * d;
          }
        }
        d2 += __shfl_xor_sync(~0u, d2, 1);
        d2 += __shfl_xor_sync(~0u, d2, 2);
        d2 += __shfl_xor_sync(~0u, d2, 4);
        if (sub == 0 && p < kC1Halo && pixel(p) >= 0)
          stats[p] = make_float2(mu, rsqrtf(d2 / C + a.eps));
      }
    }
    __syncthreads();
  }
  if (tid >= kCabConsumers) {
    bw_regs_dec<104>();
    const int st = tid - kCabConsumers;  // a stager
    // slice s (channels 16 s .. + 15) into its slot: item e is group e /
    // kC1Halo, pixel e % kC1Halo (consecutive threads, consecutive 16
    // bytes); LN'd and rounded, zero outside the image and past C
    constexpr int kItems = 2 * kC1Halo, kBatch = 4;
    for (int s = 0; s < ns; ++s) {
      if (st == 0)  // this slice's nine taps of the weights
        bw_produce(r, static_cast<const unsigned char*>(a.w) +
                          (long long)s * kStage, 1);
      const int slot = s % kC1Slots;
      mbar_wait(&sempty[slot], ((s / kC1Slots) & 1) ^ 1);
      unsigned char* buf = hb + slot * kSlice;
      for (int e0 = st; e0 < kItems; e0 += kStagers * kBatch) {
        uint4 raw[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int e = e0 + kStagers * k;
          const int c0 = 16 * s + 8 * (e / kC1Halo);
          const long long px = e < kItems ? pixel(e % kC1Halo) : -1LL;
          raw[k] = px < 0 ? make_uint4(0, 0, 0, 0)
                          : bw_load8(a.x + px * C + c0, C - c0);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int e = e0 + kStagers * k;
          if (e >= kItems) continue;
          const int p = e % kC1Halo, c0 = 16 * s + 8 * (e / kC1Halo);
          uint4 o = raw[k];
          if (a.ln_s && pixel(p) >= 0) {
            float v[8];
            bw_get8(v, &raw[k]);
            const float2 sp = stats[p];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              v[i] = c0 + i < C ? (v[i] - sp.x) * sp.y * lns[c0 + i] +
                                      lnb[c0 + i]
                                : 0.f;
            o = bw_pack8(v);
          }
          *reinterpret_cast<uint4*>(buf + e * 16) = o;
        }
      }
      fence_proxy_async();  // the slice, before wgmma reads it
      __syncwarp();
      if ((st & 31) == 0) mbar_arrive(&sfull[slot]);
    }
    return;
  }
  bw_regs_inc<152>();
  const int lane = tid & 31, t = lane & 3;
  float acc[kC1Rows][BN / 2];  // the sums start at b1 (zero past Cr)
#pragma unroll
  for (int i = 0; i < kC1Rows; ++i) {
#pragma unroll
    for (int k = 0; k < BN / 2; ++k)
      acc[i][k] = bs[8 * (k >> 2) + 2 * t + (k & 1)];
    bw_fence_acc(acc[i]);
  }
  for (int s = 0; s < ns; ++s) {
    const int slot = s % r.stages, hs = s % kC1Slots;
    mbar_wait(&r.full[slot], (s / r.stages) & 1);
    mbar_wait(&sfull[hs], (s / kC1Slots) & 1);
    bw_fence();
    const unsigned char* buf = hb + hs * kSlice;
    const unsigned char* wst = r.buf + slot * kStage;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int i = 0; i < kC1Rows; ++i)
        bw_mma<BN>(acc[i],
                   bw_desc_at(buf + ((i + tap / 3) * kCabHw + tap % 3) * 16,
                              kC1Halo * 16, 128),
                   bw_desc(wst + tap * BN * 32), 1);
    bw_commit();
    if (s > 0) {  // slice s - 1 is read: its slot and its stage are free
      bw_wait<1>();
      if (lane == 0) {
        mbar_arrive(&r.empty[(s - 1) % r.stages]);
        mbar_arrive(&sempty[(s - 1) % kC1Slots]);
      }
    }
  }
  bw_wait<0>();
#pragma unroll
  for (int i = 0; i < kC1Rows; ++i) bw_fence_acc(acc[i]);
  // the ring is drained: each output row's [64][BN] tile lies there
#pragma unroll
  for (int i = 0; i < kC1Rows; ++i) {
    unsigned char* tile = r.buf + i * kCabSeg * BN * 2;
    bw_each<BN>(acc[i], [&](int row, int col, float v0, float v1) {
      *reinterpret_cast<uint32_t*>(tile + (row * BN + col) * 2) =
          pack_bf16(gelu_erf(v0), gelu_erf(v1));
    });
  }
  fence_proxy_async();
  bw_sync(kCabConsumers);
  if (tid == 0) {
    const int n = min(kCabSeg, a.W - x0);
    for (int i = 0; i < kC1Rows && y0 + i < a.H; ++i)
      bw_store(a.u + (img + (long long)(y0 + i) * a.W + x0) * BN,
               r.buf + i * kCabSeg * BN * 2, n * BN * 2);
    bw_store_commit();
    bw_store_wait<0>();
  }
}

struct CabConv2Args {
  const __nv_bfloat16* u;  // [B, H, W, cinp]
  const void* w;           // W2's layout at 96: [nch][cinp / 16][9][12][2][8][8]
  const __nv_bfloat16* bias;  // [C]
  float* y;                // [B, H, W, C]
  float* partials;         // [B, tiles, C]
  int H, W, C, cinp, nch, tiles_x;
};

// y = conv3x3(U) + b2 (fp32) and the block's channel sums.
__global__ void __launch_bounds__(kCabConsumers + 32, 2)
cab_conv2_kernel(const CabConv2Args a) {
  extern __shared__ __align__(128) unsigned char cab_smem[];
  constexpr int kStage = 3 * 16 * kC2Bn * 2;  // one dy's three taps
  constexpr int kPairs = kC2Rows / 2;
  BwRing r = bw_ring(cab_smem, kStage, kCabConsumers / 32, kC2Stages);
  unsigned char* halo = r.buf + kC2Stages * kStage;  // [cinp / 8][528][16]
  float* bs = reinterpret_cast<float*>(halo + kC2Halo * a.cinp * 2);
  float* sums = bs + a.nch * kC2Bn;
  float* red = sums + a.nch * kC2Bn;  // [4 warps][96]
  __syncthreads();
  const int tid = threadIdx.x, nst = 3 * (a.cinp / 16);  // stages a pass
  if (tid >= kCabConsumers) {
    if (tid == kCabConsumers)
      for (int pp = 0; pp < kPairs; ++pp)
        for (int c = 0; c < a.nch; ++c)
          bw_produce(r, static_cast<const unsigned char*>(a.w) +
                            (long long)c * nst * kStage, nst);
    return;
  }
  const int y0 = (blockIdx.x / a.tiles_x) * kC2Rows;
  const int x0 = (blockIdx.x % a.tiles_x) * kCabSeg;
  const long long img = (long long)blockIdx.y * a.H * a.W;
  const int groups = a.cinp / 8;
  for (int e = tid; e < groups * kC2Halo; e += kCabConsumers) {
    const int p = e % kC2Halo;
    const int y = y0 - 1 + p / kCabHw, x = x0 - 1 + p % kCabHw;
    const bool in = y >= 0 && y < a.H && x >= 0 && x < a.W;
    const __nv_bfloat16* src =
        in ? a.u + (img + (long long)y * a.W + x) * a.cinp + 8 * (e / kC2Halo)
           : a.u;
    cp_async16(reinterpret_cast<float*>(halo + e * 16),
               reinterpret_cast<const float*>(src), in);
  }
  cp_async_commit();
  bw_vector(bs, a.bias, a.C, a.nch * kC2Bn, tid, kCabConsumers);
  for (int i = tid; i < a.nch * kC2Bn; i += kCabConsumers) sums[i] = 0.f;
  cp_async_wait<0>();
  fence_proxy_async();  // the halo, before wgmma reads it
  bw_sync(kCabConsumers);
  const int lane = tid & 31, warp = tid >> 5, t = lane & 3;
  for (int pp = 0; pp < kPairs; ++pp)
    for (int c = 0; c < a.nch; ++c) {
      float acc[2][kC2Bn / 2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int k = 0; k < kC2Bn / 2; ++k) acc[i][k] = 0.f;
        bw_fence_acc(acc[i]);
      }
      for (int s = 0; s < nst; ++s) {
        const int it = r.it + s, slot = it % r.stages;
        mbar_wait(&r.full[slot], (it / r.stages) & 1);
        bw_fence();
        const int kk = s / 3, dy = s % 3;
        const unsigned char* wst = r.buf + slot * kStage;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            bw_mma<kC2Bn>(
                acc[i],
                bw_desc_at(halo + (2 * kk * kC2Halo +
                                   (2 * pp + i + dy) * kCabHw + dx) * 16,
                           kC2Halo * 16, 128),
                bw_desc(wst + dx * kC2Bn * 32), s > 0 || dx > 0);
        bw_commit();
        if (s > 0) {
          bw_wait<1>();
          if (lane == 0) mbar_arrive(&r.empty[(it - 1) % r.stages]);
        }
      }
      bw_wait<0>();
#pragma unroll
      for (int i = 0; i < 2; ++i) bw_fence_acc(acc[i]);
      if (lane == 0) mbar_arrive(&r.empty[(r.it + nst - 1) % r.stages]);
      r.it += nst;
      float cs[kC2Bn / 8][2];
#pragma unroll
      for (int j = 0; j < kC2Bn / 8; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int y = y0 + 2 * pp + i;
        bw_frag<kC2Bn>([&](int j, int hh, int row, int col) {
          const int co = c * kC2Bn + col, x = x0 + row;
          const float v0 = acc[i][4 * j + 2 * hh] + bs[co];
          const float v1 = acc[i][4 * j + 2 * hh + 1] + bs[co + 1];
          if (y < a.H && x < a.W && co < a.C) {  // C even: co + 1 too
            *reinterpret_cast<float2*>(
                a.y + (img + (long long)y * a.W + x) * a.C + co) =
                make_float2(v0, v1);
            cs[j][0] += v0;
            cs[j][1] += v1;
          }
        });
      }
      // over the warp's pixels (the lanes of one t), then the four warps
#pragma unroll
      for (int j = 0; j < kC2Bn / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = cs[j][e];
          v += __shfl_xor_sync(~0u, v, 4);
          v += __shfl_xor_sync(~0u, v, 8);
          v += __shfl_xor_sync(~0u, v, 16);
          if (lane < 4) red[warp * kC2Bn + 8 * j + 2 * t + e] = v;
        }
      bw_sync(kCabConsumers);
      if (tid < kC2Bn)
        sums[c * kC2Bn + tid] += (red[tid] + red[kC2Bn + tid]) +
                                 (red[2 * kC2Bn + tid] + red[3 * kC2Bn + tid]);
      bw_sync(kCabConsumers);
    }
  for (int co = tid; co < a.C; co += kCabConsumers)
    a.partials[((long long)blockIdx.y * gridDim.x + blockIdx.x) * a.C + co] =
        sums[co];
}

// out = bf16(y a[b] + x skip) (skip given) or bf16(y a[b])
__global__ void __launch_bounds__(256)
cab_apply_bf16_kernel(const float* __restrict__ y, const float* __restrict__ a,
                      const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ skip,
                      __nv_bfloat16* __restrict__ out, long long per_batch,
                      int C, long long total) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += gridDim.x * 256LL) {
    const int c = int(i % C);
    float v = y[i] * a[(i / per_batch) * C + c];
    if (skip) v = v + bw_f(x[i]) * bw_f(skip[c]);
    out[i] = __float2bfloat16_rn(v);
  }
}

bool cab_bf16_refused(long long M, int C, int Cr) {
  return M <= 0 || C <= 0 || Cr <= 0 || C % 2 || C > kCabMaxC ||
         Cr > kCabMaxCr || cab_conv2_smem(C, Cr) > 227 * 1024 ||
         cab_conv1_smem(C, Cr) > 227 * 1024;
}

template <int BN>
cudaError_t cab_conv1(const CabConv1Args& a, int B, cudaStream_t stream) {
  static int allowed[64] = {};
  const int smem = cab_conv1_smem(a.C, a.Cr);
  cudaError_t err = bw_allow(cab_conv1_kernel<BN>, smem, allowed);
  if (err != cudaSuccess) return err;
  cab_conv1_kernel<BN>
      <<<dim3(unsigned(cab_tiles(a.H, a.W, c1_rows<BN>())), unsigned(B)),
         2 * kCabConsumers, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// conv2's tiles an image of the bf16 kernels (the partials' middle axis).
extern "C" int ff_cab_bf16_tiles(int H, int W) {
  return cab_tiles(H, W, kC2Rows);
}

// Dynamic shared memory of a conv1 (conv2 = 0) or a conv2 block
// (ops/wgmma.py:plan_cab_bf16 computes the same).
extern "C" int ff_cab_bf16_smem(int C, int Cr, int conv2) {
  return conv2 ? cab_conv2_smem(C, Cr) : cab_conv1_smem(C, Cr);
}

// Bytes of scratch ff_cab_pool_bf16 needs on B H W = M pixels: U, [M][48
// or 64] bf16; -1 for widths the kernels refuse (C odd or above 256, Cr
// above 64).
extern "C" long long ff_cab_bf16_scratch_bytes(long long M, int C, int Cr) {
  if (cab_bf16_refused(M, C, Cr)) return -1;
  return M * cab_bn1(Cr) * 2;
}

// Pass A, bf16. x [B, H, W, C]; b1 [Cr]; ln_s/ln_b [C] or null; b2 [C]:
// bf16; w1l, w2l: W1 [3, 3, C, Cr] and W2 [3, 3, Cr, C] in the conv layout
// (ops/wgmma.py:conv_layout at cab_bn1(Cr) and 96), 16-byte aligned. y
// [B, H, W, C] fp32; partials [B, ff_cab_bf16_tiles(H, W), C] fp32;
// scratch of ff_cab_bf16_scratch_bytes(B H W, C, Cr) bytes, 16-byte
// aligned.
extern "C" int ff_cab_pool_bf16(const void* x, const void* w1l,
                                const void* b1, const void* ln_s,
                                const void* ln_b, const void* w2l,
                                const void* b2, float* y, float* partials,
                                void* scratch, long long scratch_bytes,
                                int B, int H, int W, int C, int Cr, float eps,
                                void* stream_) {
  using bf = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long M = (long long)B * H * W;
  if (cab_bf16_refused(M, C, Cr) || B > 65535 ||
      scratch_bytes < ff_cab_bf16_scratch_bytes(M, C, Cr) ||
      (reinterpret_cast<size_t>(scratch) | reinterpret_cast<size_t>(w1l) |
       reinterpret_cast<size_t>(w2l)) % 16 ||
      reinterpret_cast<size_t>(y) % 8)
    return int(cudaErrorInvalidValue);
  const int bn = cab_bn1(Cr), tiles_x = (W + kCabSeg - 1) / kCabSeg;
  bf* u = static_cast<bf*>(scratch);
  const CabConv1Args a1{static_cast<const bf*>(x), w1l,
                        static_cast<const bf*>(b1),
                        static_cast<const bf*>(ln_s),
                        static_cast<const bf*>(ln_b), u, H, W, C, Cr,
                        bw_up(C, 16), tiles_x, eps};
  cudaError_t err = bn == 48 ? cab_conv1<48>(a1, B, stream)
                             : cab_conv1<64>(a1, B, stream);
  if (err != cudaSuccess) return int(err);
  static int allowed[64] = {};
  const int smem = cab_conv2_smem(C, Cr);
  err = bw_allow(cab_conv2_kernel, smem, allowed);
  if (err != cudaSuccess) return int(err);
  const CabConv2Args a2{u, w2l, static_cast<const bf*>(b2), y, partials,
                        H, W, C, bn, (C + kC2Bn - 1) / kC2Bn, tiles_x};
  cab_conv2_kernel<<<dim3(unsigned(cab_tiles(H, W, kC2Rows)), unsigned(B)),
                     kCabConsumers + 32, smem, stream>>>(a2);
  return int(cudaGetLastError());
}

// Pass B, bf16. y [B, H, W, C] and a [B, C] fp32; x, out [B, H, W, C] and
// skip [C] (or null: x unused) bf16.
extern "C" int ff_cab_apply_bf16(const float* y, const float* a,
                                 const void* x, const void* skip, void* out,
                                 int B, int H, int W, int C, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long per_batch = (long long)H * W * C;
  const long long total = per_batch * B;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks <= 0) return 0;
  cab_apply_bf16_kernel<<<unsigned(blocks), 256, 0, stream>>>(
      y, a, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(skip),
      static_cast<__nv_bfloat16*>(out), per_batch, C, total);
  return int(cudaGetLastError());
}
