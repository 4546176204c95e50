// Fused transformer FFN half over rows of C channels, fp32:
//   pre-norm  (DRCT)  out = x + res_scale * (gelu(LN(x) W1 + b1) W2 + b2)
//   post-norm (GRL)   out = x + res_scale * LN(gelu(x W1 + b1) W2 + b2)
// with exact (erf) GELU and LayerNorm over C (biased variance, eps given).
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_mlp.py:
// fused_mlp_block (:85), which FREQFUSION_MLP=1 routes DRCT-L's 60 Swin
// FFNs (freqfusion_tpu/models/drct.py:182) and GRL-B's 40 block FFNs
// (freqfusion_tpu/models/grl.py:479) through.
//
// What bounds it on the H100: the two products, 4 C Ch FLOPs per row
// against 8 C bytes of x and out (C = 180..308, Ch = 276..976): 90 to 490
// FLOPs per byte, far above the fp32 balance point (67 TFLOP/s over
// 3.35 TB/s = 20). It is bound by fp32 FMA issue and by the shared-memory
// loads that feed it.
//
// Design: one block of 256 threads per 64 rows. The block's input tile
// (LN(x) for pre-norm, x for post-norm) stays in shared memory for the
// whole call. The hidden activation never leaves the block: Ch is walked
// in chunks of 64 units (a 64-row tile's whole hidden at Ch = 976 would be
// 250 KB, over a block's 227 KB). For each chunk, phase 1 computes
// gelu(T W1[:, chunk] + b1) into a 64 x 64 shared tile (each thread 4 rows
// x 4 units, W1 staged 32 rows at a time), and phase 2 adds chunk x
// W2[chunk, :] into the output tile of all C columns, which lives in
// registers (each thread 4 rows x NC columns, C <= 16 NC <= 384). Every
// shared-memory operand is read as a float4 (the row tiles transposed),
// so a thread issues 2 loads per 16 FMAs in phase 1 and 1 + NC/4 per 4 NC
// in phase 2. The weight tiles are double-buffered: the next tile's
// loads are in flight while the current one is multiplied, since at
// C > 192 the registers allow one block (8 warps) per SM, too few to hide
// an L2 round trip behind one tile. The post-norm LayerNorm reduces each
// output row across the 16 threads that hold it with warp shuffles; the
// residual re-reads x.
// No cuBLAS: both products are register-tiled loops over shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;       // rows of x per block
constexpr int kLd = kRows + 4;  // row stride of the transposed tiles
constexpr int kHid = 64;        // hidden units per chunk
constexpr int kDepth1 = 32;     // rows of W1 staged at a time
constexpr int kDepth2 = 16;     // rows of W2 staged at a time

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the 16 lanes of a half-warp (the threads that share ty).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The weight tiles are staged through registers into one of two shared
// buffers: the loads of tile t + 1 are issued before tile t is computed
// and stored after it, so their latency hides behind its FMAs.
constexpr int kFetch1 = kDepth1 * kHid / kThreads;  // W1 floats per thread

__device__ __forceinline__ void fetch_w1(float (&r)[kFetch1],
                                         const float* __restrict__ w1, int c0,
                                         int j0, int C, int Ch, int tid) {
#pragma unroll
  for (int q = 0; q < kFetch1; ++q) {
    const int e = tid + q * kThreads;
    const int c = c0 + e / kHid, j = j0 + e % kHid;
    r[q] = (c < C && j < Ch) ? w1[(long long)c * Ch + j] : 0.f;
  }
}

template <int NC>  // a W2 tile is kDepth2 x 16 NC = NC floats per thread
__device__ __forceinline__ void fetch_w2(float (&r)[NC],
                                         const float* __restrict__ w2, int k0,
                                         int C, int Ch, int tid) {
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int e = tid + q * kThreads;
    const int j = k0 + e / (16 * NC), c = e % (16 * NC);
    r[q] = (c < C && j < Ch) ? w2[(long long)j * C + c] : 0.f;
  }
}

template <int N>
__device__ __forceinline__ void stash(float* dst, const float (&r)[N],
                                      int tid) {
#pragma unroll
  for (int q = 0; q < N; ++q) dst[tid + q * kThreads] = r[q];
}

// Thread (ty, tx) owns rows 4 ty .. 4 ty + 3; in phase 1 the hidden units
// 4 tx .. 4 tx + 3 of the chunk, in phase 2 and the output the columns
// 64 g + 4 tx + j (g < NC / 4, j < 4), so C <= 16 NC. The input tile and
// the hidden chunk are stored transposed ([channel][row]) so that a
// thread's four rows are one float4; the weight tiles are row-major, so
// its four units or columns are one float4 too.
template <int NC>
__global__ void __launch_bounds__(kThreads, NC <= 12 ? 2 : 1)
fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, float* __restrict__ out, int M,
                 int C, int Ch, int prenorm, float res_scale, float eps) {
  constexpr int CP = 16 * NC;  // padded output width
  constexpr int NG = NC / 4;   // float4 column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* Tt = smem;              // [C][kLd]: input tile, transposed
  float* Ht = Tt + C * kLd;      // [kHid][kLd]: hidden chunk, transposed
  constexpr int kWs = kDepth1 * kHid > kDepth2 * CP ? kDepth1 * kHid
                                                      : kDepth2 * CP;
  float* Ws = Ht + kHid * kLd;   // 2 x (W1 tile [kDepth1][kHid] or W2
                                 // tile [kDepth2][CP])
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * kRows;

  // The input tile, normalised for pre-norm (one warp per row).
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const long long m = row0 + r;
    if (m < M) {
      const float* xr = x + m * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += xr[c];
      float mu = 0.f, rs = 1.f;
      if (prenorm) {
        mu = warp_sum(s) / C;
        float q = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float d = xr[c] - mu;
          q += d * d;
        }
        rs = rsqrtf(warp_sum(q) / C + eps);
      }
      for (int c = lane; c < C; c += 32)
        Tt[c * kLd + r] = prenorm ? (xr[c] - mu) * rs * ln_s[c] + ln_b[c]
                                  : xr[c];
    } else {
      for (int c = lane; c < C; c += 32) Tt[c * kLd + r] = 0.f;
    }
  }
  __syncthreads();

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[i][k] = 0.f;

  float f1[kFetch1], f2[NC];
  for (int j0 = 0; j0 < Ch; j0 += kHid) {
    // phase 1: Ht = gelu(T W1[:, j0 : j0 + kHid] + b1), transposed
    float h[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) h[i][k] = 0.f;
    fetch_w1(f1, w1, 0, j0, C, Ch, tid);
    stash(Ws, f1, tid);
    __syncthreads();
    int buf = 0;
    for (int c0 = 0; c0 < C; c0 += kDepth1) {
      const bool more = c0 + kDepth1 < C;
      if (more) fetch_w1(f1, w1, c0 + kDepth1, j0, C, Ch, tid);
      const float* W = Ws + buf * kWs;
      const int depth = min(kDepth1, C - c0);
      for (int cc = 0; cc < depth; ++cc) {
        const float4 a = ld4(Tt + (c0 + cc) * kLd + ty * 4);
        const float4 b = ld4(W + cc * kHid + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) h[i][k] = fmaf(av[i], bv[k], h[i][k]);
      }
      if (more) stash(Ws + (buf ^ 1) * kWs, f1, tid);
      __syncthreads();
      buf ^= 1;
    }
    fetch_w2(f2, w2, j0, C, Ch, tid);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + tx * 4 + k;
      const float bias = j < Ch ? b1[j] : 0.f;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < Ch)
        v = make_float4(gelu_erf(h[0][k] + bias), gelu_erf(h[1][k] + bias),
                        gelu_erf(h[2][k] + bias), gelu_erf(h[3][k] + bias));
      *reinterpret_cast<float4*>(Ht + (tx * 4 + k) * kLd + ty * 4) = v;
    }
    stash(Ws, f2, tid);
    __syncthreads();

    // phase 2: acc += H W2[j0 : j0 + kHid, :]
    buf = 0;
    for (int k0 = 0; k0 < kHid; k0 += kDepth2) {
      const bool more = k0 + kDepth2 < kHid;
      if (more) fetch_w2(f2, w2, j0 + k0 + kDepth2, C, Ch, tid);
      const float* W = Ws + buf * kWs;
#pragma unroll 4
      for (int kk = 0; kk < kDepth2; ++kk) {
        const float4 a = ld4(Ht + (k0 + kk) * kLd + ty * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 b = ld4(W + kk * CP + 64 * g + tx * 4);
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][4 * g + j] = fmaf(av[i], bv[j], acc[i][4 * g + j]);
        }
      }
      if (more) stash(Ws + (buf ^ 1) * kWs, f2, tid);
      __syncthreads();
      buf ^= 1;
    }
  }

  // epilogue: + b2, post-norm LayerNorm, residual
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = 64 * (k / 4) + tx * 4 + k % 4;
    const float bias = c < C ? b2[c] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][k] = c < C ? acc[i][k] + bias : 0.f;
  }
  if (!prenorm) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) s += acc[i][k];
      const float mu = half_warp_sum(s) / C;
      float q = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = 64 * (k / 4) + tx * 4 + k % 4;
        const float d = c < C ? acc[i][k] - mu : 0.f;
        q += d * d;
      }
      const float rs = rsqrtf(half_warp_sum(q) / C + eps);
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = 64 * (k / 4) + tx * 4 + k % 4;
        if (c < C) acc[i][k] = (acc[i][k] - mu) * rs * ln_s[c] + ln_b[c];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = row0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = 64 * (k / 4) + tx * 4 + k % 4;
      if (c < C) out[m * C + c] = x[m * C + c] + res_scale * acc[i][k];
    }
  }
}

template <int NC>
int launch(const float* x, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* ln_s, const float* ln_b, float* out,
           int M, int C, int Ch, int prenorm, float res_scale, float eps,
           cudaStream_t stream) {
  const size_t floats = size_t(C + kHid) * kLd +
                        2 * size_t(kDepth1 * kHid > kDepth2 * 16 * NC
                                       ? kDepth1 * kHid : kDepth2 * 16 * NC);
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const unsigned blocks = unsigned((M + kRows - 1) / kRows);
  fused_mlp_kernel<NC><<<blocks, kThreads, smem, stream>>>(
      x, w1, b1, w2, b2, ln_s, ln_b, out, M, C, Ch, prenorm, res_scale, eps);
  return int(cudaGetLastError());
}

}  // namespace

// x, out [M, C]; w1 [C, Ch]; b1 [Ch]; w2 [Ch, C]; b2, ln_s, ln_b [C]. All
// fp32 contiguous; C <= 384.
extern "C" int ff_fused_mlp(const float* x, const float* w1, const float* b1,
                            const float* w2, const float* b2,
                            const float* ln_s, const float* ln_b, float* out,
                            int M, int C, int Ch, int prenorm,
                            float res_scale, float eps, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int nc = (C + 15) / 16;
  if (nc <= 4)
    return launch<4>(x, w1, b1, w2, b2, ln_s, ln_b, out, M, C, Ch, prenorm,
                     res_scale, eps, stream);
  if (nc <= 8)
    return launch<8>(x, w1, b1, w2, b2, ln_s, ln_b, out, M, C, Ch, prenorm,
                     res_scale, eps, stream);
  if (nc <= 12)
    return launch<12>(x, w1, b1, w2, b2, ln_s, ln_b, out, M, C, Ch, prenorm,
                      res_scale, eps, stream);
  if (nc <= 16)
    return launch<16>(x, w1, b1, w2, b2, ln_s, ln_b, out, M, C, Ch, prenorm,
                      res_scale, eps, stream);
  if (nc <= 20)
    return launch<20>(x, w1, b1, w2, b2, ln_s, ln_b, out, M, C, Ch, prenorm,
                      res_scale, eps, stream);
  if (nc <= 24)
    return launch<24>(x, w1, b1, w2, b2, ln_s, ln_b, out, M, C, Ch, prenorm,
                      res_scale, eps, stream);
  return int(cudaErrorInvalidValue);
}
