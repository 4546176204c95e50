// A 3x3 convolution over [B, H, W, C] tensors of any layout, fp32, zero
// padded, on the tensor cores in 3xTF32 (tf32_mma.cuh): the building block
// of the fusion net's hierarchical stage 3 (csrc/hier.cu). Each tensor is
// read through its element strides (b, y, x, c), so an NCHW tensor and an
// NHWC scratch mix in one call.
//
// out = act(conv + bias), then optionally out = r1 + alpha out and out +=
// beta r2 (residuals read at the same pixel), or the SpatialGate out = v *
// sigmoid(gelu(v G0 + g0) g2 + g2b) over the pixel's Cout channels v. A
// residual may be the output itself: each thread reads it at its own
// pixels before writing them.
//
// Design, #15's convolution (csrc/cab.cu) without its LayerNorm and
// channel sums: an implicit GEMM, M a tile of output pixels, N the output
// channels, K = 9 Cin taken tap by tap. A block of 8 warps takes a (8 MT)
// x 16 tile of output pixels and 8 NT output channels (wider convs take
// several blocks); warp w owns output rows MT w .. MT w + MT - 1, one
// m-tile each (the tile's 16 columns are an m-tile's 16 rows), and all the
// block's n-tiles. Input
// channels go 8 a stage (one k8 step a tap) through a two-stage ring, one
// barrier a stage: the stage's (8 MT + 2) x 18 halo lands by cp.async
// (zeros outside the image and past Cin; a pixel's 4 channels a thread,
// one 16-byte copy from an NHWC source, else four 4-byte copies), and a
// lane splits its A fragment in registers as it reads it, as
// tf32_gemm.cuh's Product does (#15 splits its halo in place once a
// stage: twice the shared-memory reads a tap, and a split pass in step
// across the block); the stage's weights for all 9 taps, split once a call
// into fragment order (a lane's B fragment, hi and lo, is one 16-byte
// load; a block's stage one contiguous piece), land by one bulk copy on
// the stage's mbarrier. A tap's A fragment is the halo shifted by (dy,
// dx). The k8 block's channels are permuted (fragment column t is channel
// 2t, t + 4 is 2t + 1, in the weights' split as in the halo's read), so a
// lane reads a pixel's two channels as one 8-byte load, free of bank
// conflicts at a pixel stride of 8 floats. Zero padding needs no masks:
// every conv of a chain reads a tensor of the image's size from device
// memory and stages zeros outside it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace conv3x3_tf32 {

constexpr int kTW = 16;        // output tile columns: an m-tile's rows
constexpr int kHW = kTW + 2;   // halo columns
constexpr int kCK = 8;         // input channels a stage: one k8 block
constexpr int kStages = 2;     // the ring

struct T4 {
  const float* p;
  long long sb, sy, sx, sc;
};

__host__ __device__ inline long long at(const T4& t, int b, int y, int x,
                                        int c) {
  return b * t.sb + y * t.sy + x * t.sx + c * t.sc;
}

// A [B, H, W, C] tensor, NHWC-contiguous or (nchw) NCHW-contiguous.
inline T4 tensor(const float* p, int H, int W, int C, int nchw) {
  if (nchw) return T4{p, (long long)C * H * W, W, 1, (long long)H * W};
  return T4{p, (long long)H * W * C, (long long)W * C, C, 1};
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

enum Act { kNone = 0, kGelu = 1, kSigmoid = 2 };

struct Conv {
  T4 src;               // the input
  int Cin, cinp, vec;   // its channels, padded to kCK; 16-byte copies
  const float* w;       // split weights, fragment order (split_unit)
  const float* bias;    // [Cout] or null
  int Cout, coutp, act;
  float* out;           // output, strides of `o`
  T4 o;
  T4 r1;                // residual or null: out = r1 + alpha * out
  const float* alpha;
  T4 r2;                // residual or null: out += beta * r2
  const float* beta;
  const float* g0;      // SpatialGate or null: G0 [Cout, 8], g0 [8],
  const float* g0b;     // g2 [8], g2b [1]; the block holds all of Cout
  const float* g2;
  const float* g2b;
  int H, W;
};

// (8 MT) x 16 output pixels and 8 NT output channels a block of 8 warps.
template <int NT, int MT>
struct Shape {
  static constexpr int kThreads = 256;
  static constexpr int kN = 8 * NT;                   // output channels
  static constexpr int kTH = 8 * MT;                  // output tile rows
  static constexpr int kHalo = (kTH + 2) * kHW;       // halo pixels
  static constexpr int kPlane = kHalo * kCK;          // the halo's floats
  static constexpr int kW = 9 * NT * 128;             // 9 taps' B fragments
  static constexpr int kStage = kPlane + kW;          // floats
  static constexpr size_t kSmem =
      kStages * size_t(kStage) * sizeof(float) + kStages * sizeof(uint64_t);
};

// HWIO weights [3, 3, cin, cout], zero-padded, split into fragment order
// over [coutp / (8 nt) blocks][cinp / 8][9 taps][nt][32 lanes][4]: unit u
// is lane (g, t) of a (block, k8 block, tap, n-tile), its hi W[2t][g], hi
// W[2t + 1][g], then the two lo. The k8 block's channels go in the order
// 0, 2, 4, 6, 1, 3, 5, 7, the order in which a lane reads the halo.
__device__ __forceinline__ void split_unit(const float* __restrict__ w,
                                           float* __restrict__ fr, int cin,
                                           int cout, int cinp, int nt,
                                           long long u) {
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

// One conv's weights to split: 9 cinp coutp / 2 units.
struct SplitJob {
  const float* w;
  float* fr;
  int cin, cout, cinp, coutp, nt;
};

template <int J>
struct SplitJobs {
  SplitJob job[J];
};

template <int J>
__global__ void __launch_bounds__(256) split_kernel(SplitJobs<J> jobs) {
  long long base[J + 1];
  base[0] = 0;
#pragma unroll
  for (int j = 0; j < J; ++j)
    base[j + 1] = base[j] + 9LL * jobs.job[j].cinp * jobs.job[j].coutp / 2;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < base[J];
       i += gridDim.x * 256LL) {
    int j = 0;
#pragma unroll
    for (int q = 1; q < J; ++q) j += i >= base[q];
    const SplitJob& s = jobs.job[j];
    split_unit(s.w, s.fr, s.cin, s.cout, s.cinp, s.nt, i - base[j]);
  }
}

template <int J>
cudaError_t split(const SplitJobs<J>& jobs, cudaStream_t stream) {
  split_kernel<J><<<264, 256, 0, stream>>>(jobs);
  return cudaGetLastError();
}

// kGate: the SpatialGate in the epilogue (p.g0 set), an instantiation of
// its own: its sums would crowd the registers of the other convs.
template <int NT, int MT, bool kGate>
__global__ void __launch_bounds__(256, 2) conv_kernel(Conv p) {
  using S = Shape<NT, MT>;
  constexpr int kThreads = S::kThreads;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * S::kStage);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tiles_x = (p.W + kTW - 1) / kTW;
  const int y0 = (blockIdx.x / tiles_x) * S::kTH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const int n0 = blockIdx.y * S::kN;
  const int b = blockIdx.z;
  const float* xb = p.src.p + b * p.src.sb;
  auto in_image = [&](int q, int& gy, int& gx) {
    gy = y0 - 1 + q / kHW;
    gx = x0 - 1 + q % kHW;
    return gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
  };
  auto plane = [&](int s) { return smem + (s % kStages) * S::kStage; };

  // Stage s: the halo's channels [8 s, 8 s + 8) (thread tid owns the
  // pieces tid + i kThreads: pixel q / 2, channels 4 (q % 2) + 0..3; one
  // 16-byte copy from an NHWC source, else four 4-byte copies, neighbouring
  // threads on neighbouring pixels of a channel plane), and (thread 0, one
  // bulk copy on the stage's mbarrier) the block's B fragments of all 9
  // taps.
  auto copy_stage = [&](int s) {
    const int c0 = s * kCK;
    float* r = plane(s);
    for (int q = tid; q < S::kHalo * 2; q += kThreads) {
      const int px = q / 2, c = c0 + 4 * (q % 2);
      int gy, gx;
      const bool in = in_image(px, gy, gx);
      const float* src = xb + gy * p.src.sy + gx * p.src.sx;
      if (p.vec) {
        const bool ok = in && c < p.Cin;
        cp_async16(r + 4 * q, ok ? src + c : p.w, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = in && c + j < p.Cin;
          cp_async4(r + 4 * q + j, ok ? src + (c + j) * p.src.sc : p.w, ok);
        }
      }
    }
    if (tid == 0) {
      constexpr uint32_t kBytes = 4 * S::kW;
      uint64_t* bar = &full[s % kStages];
      fence_proxy_async();
      mbar_arrive_expect_tx(bar, kBytes);
      bulk_copy(r + S::kPlane,
                p.w + ((long long)blockIdx.y * (p.cinp / kCK) + s) * S::kW,
                kBytes, bar);
    }
  };

  const int stages = p.cinp / kCK;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  copy_stage(0);
  cp_async_commit();

  float acc[NT][MT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.f;

  for (int s = 0; s < stages; ++s) {
    cp_async_wait<0>();  // this thread's copies of stage s
    mbar_wait(&full[s % kStages], (s / kStages) & 1);  // its weights
    __syncthreads();  // stage s is in; stage s - 1's products are done
    if (s + 1 < stages) copy_stage(s + 1);
    cp_async_commit();
    const float* ah = plane(s);
    const float* w = ah + S::kPlane;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // lane (g, t): pixels g and g + 8 of the m-tile's row, channels
      // 2t and 2t + 1 (fragment columns t and t + 4), split here
      uint32_t fh[MT][4], fl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int o = ((MT * warp + mt + dy) * kHW + g + dx) * kCK + 2 * t;
        const float2 r0 = *reinterpret_cast<const float2*>(ah + o);
        const float2 r1 = *reinterpret_cast<const float2*>(ah + o + 8 * kCK);
        split_tf32(r0.x, fh[mt][0], fl[mt][0]);
        split_tf32(r1.x, fh[mt][1], fl[mt][1]);
        split_tf32(r0.y, fh[mt][2], fl[mt][2]);
        split_tf32(r1.y, fh[mt][3], fl[mt][3]);
      }
      const float* wt = w + tap * NT * 128 + 4 * lane;
      constexpr int kWhole = NT / 2 * 2;
#pragma unroll
      for (int j = 0; j < kWhole; j += 2) {
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint4 f = *reinterpret_cast<const uint4*>(wt + 128 * (j + q));
          bh[q][0] = f.x, bh[q][1] = f.y, bl[q][0] = f.z, bl[q][1] = f.w;
        }
        mma_3xtf32_split(*reinterpret_cast<float(*)[2][MT][4]>(&acc[j]), fh,
                         fl, bh, bl);
      }
      if constexpr (kWhole < NT) {  // an odd last n-tile
        const uint4 f = *reinterpret_cast<const uint4*>(wt + 128 * kWhole);
        const uint32_t bh[1][2] = {{f.x, f.y}}, bl[1][2] = {{f.z, f.w}};
        mma_3xtf32_split(*reinterpret_cast<float(*)[1][MT][4]>(&acc[kWhole]),
                         fh, fl, bh, bl);
      }
    }
  }

  // epilogue: lane (g, t) holds, for m-tile mt (output row y0 + MT warp +
  // mt) and n-tile j, pixels g + 8 h and channels n0 + 8 j + 2 t + e at
  // acc[j][mt][2 h + e]
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = n0 + 8 * j + 2 * t + e;
      const float bias = p.bias && co < p.Cout ? p.bias[co] : 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& v = acc[j][mt][2 * h + e];
          v += bias;
          if (p.act == kGelu) v = gelu_erf(v);
          else if (p.act == kSigmoid) v = sigmoidf(v);
        }
    }
  if constexpr (kGate) {
    // SpatialGate over the pixel's 8 NT = Cout channels, 8 a lane: squeeze
    // unit k's sum a pixel over the quad (t) by shuffles, one unit at a
    // time; lane t keeps units 2t and 2t + 1, takes them through GELU and
    // g2, and the quad sums the two
    float mine[MT][2][2] = {};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float gw[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          gw[j][e] = __ldg(p.g0 + (8 * j + 2 * t + e) * 8 + k);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v = fmaf(acc[j][mt][2 * h + e], gw[j][e], v);
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (k == 2 * t) mine[mt][h][0] = v;
          if (k == 2 * t + 1) mine[mt][h][1] = v;
        }
    }
    const float b0 = __ldg(p.g0b + 2 * t), b1 = __ldg(p.g0b + 2 * t + 1);
    const float w0 = __ldg(p.g2 + 2 * t), w1 = __ldg(p.g2 + 2 * t + 1);
    const float gb = __ldg(p.g2b);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float gs = gelu_erf(mine[mt][h][0] + b0) * w0 +
                   gelu_erf(mine[mt][h][1] + b1) * w1;
        gs += __shfl_xor_sync(0xffffffffu, gs, 1);
        gs += __shfl_xor_sync(0xffffffffu, gs, 2);
        const float gate = sigmoidf(gs + gb);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[j][mt][2 * h + e] *= gate;
      }
  }
  const float alpha = p.alpha ? *p.alpha : 1.f;
  const float beta = p.beta ? *p.beta : 1.f;
  const bool pairs = p.o.sc == 1 && (p.o.sx % 2 == 0) &&
                     (reinterpret_cast<size_t>(p.out) % 8 == 0);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int gy = y0 + MT * warp + mt;
    if (gy >= p.H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gx = x0 + g + 8 * h;
      if (gx >= p.W) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = n0 + 8 * j + 2 * t;
        if (co >= p.Cout) continue;
        const bool two = co + 1 < p.Cout;
        float v[2] = {acc[j][mt][2 * h], acc[j][mt][2 * h + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (e && !two) continue;
          if (p.r1.p) v[e] = p.r1.p[at(p.r1, b, gy, gx, co + e)] + alpha * v[e];
          if (p.r2.p) v[e] += beta * p.r2.p[at(p.r2, b, gy, gx, co + e)];
        }
        const long long o = at(p.o, b, gy, gx, co);
        if (two && pairs) {
          *reinterpret_cast<float2*>(p.out + o) = make_float2(v[0], v[1]);
        } else {
          p.out[o] = v[0];
          if (two) p.out[o + p.o.sc] = v[1];
        }
      }
    }
  }
}

template <int NT, int MT, bool kGate = false>
int launch(const Conv& p, int B, cudaStream_t stream) {
  using S = Shape<NT, MT>;
  if (p.coutp % S::kN || p.cinp % kCK || kGate != (p.g0 != nullptr) ||
      (kGate && (p.Cout != S::kN || p.coutp != S::kN)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<NT, MT, kGate>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(S::kSmem));
  if (err != cudaSuccess) return int(err);
  const long long tiles = (long long)((p.H + S::kTH - 1) / S::kTH) *
                          ((p.W + kTW - 1) / kTW);
  if (tiles > 0x7fffffffLL || B > 65535) return int(cudaErrorInvalidValue);
  conv_kernel<NT, MT, kGate>
      <<<dim3(unsigned(tiles), unsigned(p.coutp / S::kN), unsigned(B)),
         S::kThreads, S::kSmem, stream>>>(p);
  return int(cudaGetLastError());
}

// A conv with its source, weights and output set and every epilogue off.
inline Conv plain(T4 src, int Cin, int vec, const float* w, const float* bias,
                  int Cout, int coutp, int act, float* out, T4 o, int H,
                  int W) {
  Conv p{};
  p.src = src;
  p.Cin = Cin;
  p.cinp = (Cin + kCK - 1) / kCK * kCK;
  p.vec = vec;
  p.w = w;
  p.bias = bias;
  p.Cout = Cout;
  p.coutp = coutp;
  p.act = act;
  p.out = out;
  p.o = o;
  p.H = H;
  p.W = W;
  return p;
}

}  // namespace conv3x3_tf32
