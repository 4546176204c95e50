// A 3x3 convolution over [B, H, W, C] tensors of any layout, fp32, zero
// padded, with fused epilogues: the building block of the fusion net's
// hierarchical stage 3 (csrc/hier.cu) and Laplacian edge passes
// (csrc/edge.cu). Each tensor is read through its element strides
// (b, y, x, c), so an NCHW tensor and an NHWC scratch mix in one call.
//
// conv: the input is the channel concatenation of up to three sources;
// out = act(conv + bias), then optionally out = r1 + alpha out
// and out += beta r2 (residuals read at the same pixel), or, for one
// output channel v, out[..., c] = ba[..., c] + (v k) bm[..., c] for c < bC
// (a per-pixel gate applied to a bC-channel tensor), optionally clipped
// to [0, 1]. A residual or gate tensor may be the output itself: each
// thread reads it at its own pixels before writing them.
//
// Zero padding needs no masks here: every conv of a chain reads a tensor
// of the image's size from device memory and stages zeros outside it.
//
// Design: one block of 256 threads per 16-row output tile and all output
// channels (<= 64). Input channels are walked in chunks of 8: the chunk's
// halo tile ([8][18][TW + 2], channel-major so that neighbouring threads
// read neighbouring columns) and its 9 x 8 x CO weights sit in shared
// memory, in two buffers: cp.async brings chunk k + 1 (zero-filled outside
// the image) while chunk k is multiplied, so the loads' latency hides
// behind the FMAs without holding registers. A thread owns PP pixels of
// one column and CT output channels; for each input channel and column
// offset it loads the PP + 2 column values once and applies the three row
// taps from registers (PP + 2 loads and 3 CT / 4 float4 weight loads per
// 3 PP CT FMAs). At most 128 registers a thread: two blocks an SM.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace conv3x3 {

constexpr int kThreads = 256;
constexpr int kKC = 8;  // input channels per chunk

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
  T4 src[3];              // sources, concatenated along C
  int csrc[3];            // their channels
  int nsrc, Cin;
  const float* w;         // [3, 3, Cin, Cout]
  const float* bias;      // [Cout] or null
  int Cout, act;
  float* out;             // output, strides of `o`
  T4 o;
  T4 r1;                  // residual or null: out = r1 + alpha * out
  const float* alpha;
  T4 r2;                  // residual or null: out += beta * r2
  const float* beta;
  T4 bm, ba;              // gate (Cout 1): out[c] = ba[c] + v k bm[c]
  const float* bk;        // k, or null for 1
  int bC, clamp;
  int H, W;
};

// 4-byte asynchronous copy to shared memory; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int CO, int CT, int PP, int TW>
struct Tile {
  static constexpr int NCG = CO / CT;        // threads per pixel group
  static constexpr int NG = kThreads / NCG;  // pixel groups
  static constexpr int TH = PP * NG / TW;    // output tile rows
  static constexpr int HH = TH + 2, HW = TW + 2;
  static constexpr int kIn = kKC * HH * HW;  // floats of one input chunk
  static constexpr int kW = 9 * kKC * CO;    // floats of one weight chunk
  static constexpr size_t kSmem = sizeof(float) * 2 * (kIn + kW);
};

template <int CO, int CT, int PP, int TW>
__global__ void __launch_bounds__(kThreads, 2) conv3x3_kernel(Conv p) {
  using T = Tile<CO, CT, PP, TW>;
  constexpr int NCG = T::NCG, TH = T::TH, HH = T::HH, HW = T::HW;
  extern __shared__ __align__(16) float smem[];  // 2 x (In, Wt)
  const int tid = threadIdx.x, cg = tid % NCG, grp = tid / NCG;
  const int col = grp % TW, r0 = (grp / TW) * PP;
  const int tiles_x = (p.W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int b = blockIdx.z;
  const int c01 = p.csrc[0], c012 = p.csrc[0] + p.csrc[1];

  // chunk c0 into buffer buf: the halo tile (zeros outside the image and
  // past Cin) and the weights (zeros past Cin and Cout)
  auto stage = [&](int c0, int buf) {
    float* In = smem + buf * (T::kIn + T::kW);
    float* Wt = In + T::kIn;
    for (int e = tid; e < T::kIn; e += kThreads) {
      const int kc = e / (HH * HW), q = e % (HH * HW);
      const int gy = y0 - 1 + q / HW, gx = x0 - 1 + q % HW, ci = c0 + kc;
      const float* src = p.w;  // any valid address when nothing is read
      int bytes = 0;
      if (ci < p.Cin && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
        bytes = 4;
        if (ci < c01)
          src = p.src[0].p + at(p.src[0], b, gy, gx, ci);
        else if (ci < c012)
          src = p.src[1].p + at(p.src[1], b, gy, gx, ci - c01);
        else
          src = p.src[2].p + at(p.src[2], b, gy, gx, ci - c012);
      }
      cp_async4(In + e, src, bytes);
    }
    for (int e = tid; e < T::kW; e += kThreads) {
      const int co = e % CO, r = e / CO, kc = r % kKC, tap = r / kKC;
      const int ci = c0 + kc;
      const bool ok = ci < p.Cin && co < p.Cout;
      cp_async4(Wt + e,
                ok ? p.w + ((long long)tap * p.Cin + ci) * p.Cout + co : p.w,
                ok ? 4 : 0);
    }
    cp_async_commit();
  };

  float acc[PP][CT];
#pragma unroll
  for (int i = 0; i < PP; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

  stage(0, 0);
  for (int c0 = 0, buf = 0; c0 < p.Cin; c0 += kKC, buf ^= 1) {
    if (c0 + kKC < p.Cin) {
      stage(c0 + kKC, buf ^ 1);  // its buffer was freed by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c0 has landed for every thread
    const float* In = smem + buf * (T::kIn + T::kW);
    const float* Wt = In + T::kIn;
    const int kn = min(kKC, p.Cin - c0);
#pragma unroll 1
    for (int kc = 0; kc < kn; ++kc) {
      const float* in = In + kc * HH * HW + r0 * HW + col;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float a[PP + 2];
#pragma unroll
        for (int i = 0; i < PP + 2; ++i) a[i] = in[i * HW + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* wr = Wt + ((dy * 3 + dx) * kKC + kc) * CO + cg * CT;
          float wv[CT];
#pragma unroll
          for (int j4 = 0; j4 < CT / 4; ++j4) {
            const float4 w4 = *reinterpret_cast<const float4*>(wr + 4 * j4);
            wv[4 * j4] = w4.x;
            wv[4 * j4 + 1] = w4.y;
            wv[4 * j4 + 2] = w4.z;
            wv[4 * j4 + 3] = w4.w;
          }
#pragma unroll
          for (int i = 0; i < PP; ++i)
#pragma unroll
            for (int j = 0; j < CT; ++j)
              acc[i][j] = fmaf(a[i + dy], wv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // buffer buf is free for chunk c0 + 2 kKC
  }

  const int gx = x0 + col;
  if (gx >= p.W) return;
  const float alpha = p.alpha ? *p.alpha : 1.f;
  const float beta = p.beta ? *p.beta : 1.f;
  const float k = p.bk ? *p.bk : 1.f;
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const int co = cg * CT + j;
    if (co >= p.Cout) continue;
    const float bias = p.bias ? p.bias[co] : 0.f;
#pragma unroll
    for (int i = 0; i < PP; ++i) {
      const int gy = y0 + r0 + i;
      if (gy >= p.H) continue;
      float v = acc[i][j] + bias;
      if (p.act == kGelu) v = gelu_erf(v);
      else if (p.act == kSigmoid) v = sigmoidf(v);
      if (p.bC) {
        const float s = v * k;
        for (int c = 0; c < p.bC; ++c) {
          float o = p.ba.p ? p.ba.p[at(p.ba, b, gy, gx, c)] : 0.f;
          o += s * p.bm.p[at(p.bm, b, gy, gx, c)];
          if (p.clamp) o = fminf(fmaxf(o, 0.f), 1.f);
          p.out[at(p.o, b, gy, gx, c)] = o;
        }
        continue;
      }
      if (p.r1.p) v = p.r1.p[at(p.r1, b, gy, gx, co)] + alpha * v;
      if (p.r2.p) v += beta * p.r2.p[at(p.r2, b, gy, gx, co)];
      p.out[at(p.o, b, gy, gx, co)] = v;
    }
  }
}

template <int CO, int CT, int PP, int TW>
int launch(const Conv& p, int B, cudaStream_t stream) {
  using T = Tile<CO, CT, PP, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<CO, CT, PP, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::kSmem));
  if (err != cudaSuccess) return int(err);
  const unsigned tiles =
      unsigned(((p.H + T::TH - 1) / T::TH) * ((p.W + TW - 1) / TW));
  conv3x3_kernel<CO, CT, PP, TW><<<dim3(tiles, 1, unsigned(B)), kThreads,
                                   T::kSmem, stream>>>(p);
  return int(cudaGetLastError());
}

// Run one conv; Cout <= 64 (the tile's channels live in registers).
inline int run(const Conv& p, int B, cudaStream_t stream) {
  if (p.Cout <= 4) return launch<4, 4, 2, 32>(p, B, stream);
  if (p.Cout <= 16) return launch<16, 8, 4, 32>(p, B, stream);
  if (p.Cout <= 32) return launch<32, 8, 8, 32>(p, B, stream);
  if (p.Cout <= 64) return launch<64, 8, 8, 16>(p, B, stream);
  return int(cudaErrorInvalidValue);
}

// A conv with its sources and output set and every epilogue off.
inline Conv plain(const float* w, const float* bias, int Cout, int act,
                  float* out, T4 o, int H, int W) {
  Conv p{};
  p.w = w;
  p.bias = bias;
  p.Cout = Cout;
  p.act = act;
  p.out = out;
  p.o = o;
  p.H = H;
  p.W = W;
  return p;
}

inline void add_source(Conv& p, T4 t, int C) {
  p.src[p.nsrc] = t;
  p.csrc[p.nsrc] = C;
  ++p.nsrc;
  p.Cin += C;
}

// Per pixel: h = gelu(x W0 + b0) (Ch = CH units); with w1, out = x *
// sigmoid(h w1 + b1) (C channels, the SpatialGate), else out = h. `out`
// may be `x` (each thread reads its pixel before writing it).
template <int CH>
__global__ void __launch_bounds__(kThreads)
pixel_gate_kernel(T4 x, int C, const float* __restrict__ w0,
                  const float* __restrict__ b0, const float* __restrict__ w1,
                  const float* __restrict__ b1, float* out, T4 o, int H, int W,
                  long long P) {
  extern __shared__ float ws[];  // [C][CH] w0
  for (int e = threadIdx.x; e < C * CH; e += kThreads) ws[e] = w0[e];
  __syncthreads();
  const long long pix = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pix >= P) return;
  const int b = int(pix / ((long long)H * W));
  const int yx = int(pix % ((long long)H * W)), y = yx / W, xx = yx % W;
  float h[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) h[j] = b0[j];
  for (int c = 0; c < C; ++c) {
    const float v = x.p[at(x, b, y, xx, c)];
#pragma unroll
    for (int j = 0; j < CH; ++j) h[j] = fmaf(v, ws[c * CH + j], h[j]);
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) h[j] = gelu_erf(h[j]);
  if (!w1) {
#pragma unroll
    for (int j = 0; j < CH; ++j) out[at(o, b, y, xx, j)] = h[j];
    return;
  }
  float g = b1[0];
#pragma unroll
  for (int j = 0; j < CH; ++j) g = fmaf(h[j], w1[j], g);
  g = sigmoidf(g);
  for (int c = 0; c < C; ++c) {
    const long long i = at(x, b, y, xx, c);
    out[at(o, b, y, xx, c)] = x.p[i] * g;
  }
}

// Ch must be 8 (the fusion net's C / 4 at C 32).
inline int pixel_gate(T4 x, int C, const float* w0, const float* b0, int Ch,
                      const float* w1, const float* b1, float* out, T4 o,
                      int B, int H, int W, cudaStream_t stream) {
  if (Ch != 8 || C > 256) return int(cudaErrorInvalidValue);
  const long long P = (long long)B * H * W;
  const unsigned blocks = unsigned((P + kThreads - 1) / kThreads);
  pixel_gate_kernel<8><<<blocks, kThreads, sizeof(float) * C * 8, stream>>>(
      x, C, w0, b0, w1, b1, out, o, H, W, P);
  return int(cudaGetLastError());
}

}  // namespace conv3x3
