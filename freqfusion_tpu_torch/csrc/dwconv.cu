// Depthwise 3x3 convolution over an NHWC tensor: zero padding, stride 1,
// per-channel bias; fp32, or bf16 in memory with fp32 arithmetic.
//   out[b, y, x, c] = bias[c] + sum_{dy, dx} k[dy][dx][c] x[b, y+dy-1, x+dx-1, c]
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_dwconv.py:
// dwconv3x3_pallas (:56), which FREQFUSION_DWCONV=1 routes MambaIR's SS2D
// conv2d (freqfusion_tpu/models/mambair.py:88; D = 360 at the LR size) and
// NAFNet's depthwise conv (freqfusion_tpu/models/nafnet.py:136) through.
//
// What bounds it on the H100: memory. 18 FLOPs per element against 8 bytes
// (read x once, write out once): 2.25 FLOPs per byte, a tenth of the fp32
// balance point. At 336x512x360 the call moves 0.50 GB, 0.15 ms at
// 3.35 TB/s.
//
// Design: reads NHWC directly, so the NHWC <-> NCHW permute copies that a
// cuDNN depthwise call needs on each side disappear. Each thread owns one
// (x, channel group) column and walks kRun output rows down it, keeping a
// 3 x 3 window of inputs in registers: each input row is loaded once per
// thread instead of three times. Neighbouring threads hold neighbouring
// channels, so every load is coalesced, and with C % 4 == 0 a thread moves
// float4s. The left and right taps are the neighbouring columns' data,
// which the L1 cache serves; device memory sees each input about once.
//
// bf16 (FREQFUSION_EXPERT_DTYPE=bf16): the same kernel on the memory type,
// x, the taps and the bias bf16, widened to fp32 as they are loaded; the
// sum and the bias in fp32, the output rounded once to bf16, as the JAX
// kernel rounds it (pallas_dwconv.py:_dw_kernel, :32-45). Four channels a
// thread move as one 8-byte load (C % 4 == 0); the bound halves with the
// bytes: 4 bytes an element, 0.07 ms at 336x512x360.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;  // output rows per thread

struct __align__(8) Bf16x4 {  // four bf16 channels, one 8-byte load
  __nv_bfloat162 lo, hi;
};

// The fp32 arithmetic type of a memory element and the conversions: fp32
// elements as they are, bf16 widened as loaded and rounded as stored.
template <typename M> struct Lanes;
template <> struct Lanes<float> {
  using V = float;
  __device__ __forceinline__ static V load(float m) { return m; }
  __device__ __forceinline__ static float store(V v) { return v; }
};
template <> struct Lanes<float4> {
  using V = float4;
  __device__ __forceinline__ static V load(float4 m) { return m; }
  __device__ __forceinline__ static float4 store(V v) { return v; }
};
template <> struct Lanes<__nv_bfloat16> {
  using V = float;
  __device__ __forceinline__ static V load(__nv_bfloat16 m) {
    return __bfloat162float(m);
  }
  __device__ __forceinline__ static __nv_bfloat16 store(V v) {
    return __float2bfloat16_rn(v);
  }
};
template <> struct Lanes<Bf16x4> {
  using V = float4;
  __device__ __forceinline__ static V load(Bf16x4 m) {
    const float2 a = __bfloat1622float2(m.lo), b = __bfloat1622float2(m.hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ __forceinline__ static Bf16x4 store(V v) {
    return {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
  }
};

__device__ __forceinline__ float fma_v(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ float4 fma_v(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y),
                     fmaf(a.z, b.z, c.z), fmaf(a.w, b.w, c.w));
}
template <typename V> __device__ __forceinline__ V zero_v();
template <> __device__ __forceinline__ float zero_v<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero_v<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename M>
__device__ __forceinline__ typename Lanes<M>::V load_tap(
    const M* __restrict__ xb, int y, int x, int H, int W, int Cv, int c) {
  return (y >= 0 && y < H && x >= 0 && x < W)
             ? Lanes<M>::load(xb[((long long)y * W + x) * Cv + c])
             : zero_v<typename Lanes<M>::V>();
}

// M is the memory element (float, float4, bf16 or four bf16); Cv = C /
// (channels of M).
template <typename M>
__global__ void __launch_bounds__(kThreads)
dwconv3x3_kernel(const M* __restrict__ x, const M* __restrict__ k,
                 const M* __restrict__ bias, M* __restrict__ out, int H, int W,
                 int Cv) {
  using L = Lanes<M>;
  using V = typename L::V;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= W * Cv) return;
  const int c = idx % Cv, xx = idx / Cv;
  const int y0 = blockIdx.y * kRun;
  const long long plane = (long long)H * W * Cv;
  const M* xb = x + blockIdx.z * plane;
  M* ob = out + blockIdx.z * plane;
  V w[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) w[t] = L::load(k[t * Cv + c]);
  const V b0 = L::load(bias[c]);

  // win[r][d]: input row y - 1 + r, column xx - 1 + d (zero outside)
  V win[3][3];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      win[r][d] = load_tap(xb, y0 - 1 + r, xx - 1 + d, H, W, Cv, c);
  for (int i = 0; i < kRun; ++i) {
    const int y = y0 + i;
    if (y >= H) break;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      win[2][d] = load_tap(xb, y + 1, xx - 1 + d, H, W, Cv, c);
    V acc = b0;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int d = 0; d < 3; ++d) acc = fma_v(win[r][d], w[r * 3 + d], acc);
    ob[((long long)y * W + xx) * Cv + c] = L::store(acc);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      win[0][d] = win[1][d];
      win[1][d] = win[2][d];
    }
  }
}

template <typename M>
int launch(const void* x, const void* k, const void* bias, void* out, int B,
           int H, int W, int Cv, cudaStream_t stream) {
  const dim3 grid(unsigned((W * Cv + kThreads - 1) / kThreads),
                  unsigned((H + kRun - 1) / kRun), unsigned(B));
  dwconv3x3_kernel<M><<<grid, kThreads, 0, stream>>>(
      static_cast<const M*>(x), static_cast<const M*>(k),
      static_cast<const M*>(bias), static_cast<M*>(out), H, W, Cv);
  return int(cudaGetLastError());
}

bool aligned(const void* a, const void* b, const void* c, const void* d,
             unsigned bytes) {
  return ((reinterpret_cast<unsigned long long>(a) |
           reinterpret_cast<unsigned long long>(b) |
           reinterpret_cast<unsigned long long>(c) |
           reinterpret_cast<unsigned long long>(d)) & (bytes - 1)) == 0;
}

}  // namespace

// x, out [B, H, W, C]; k [3, 3, C] (taps row-major, then channel); bias
// [C]. All fp32 contiguous. The float4 route needs C % 4 == 0 and 16-byte
// aligned pointers.
extern "C" int ff_dwconv3x3(const float* x, const float* k, const float* bias,
                            float* out, int B, int H, int W, int C,
                            void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (C % 4 == 0 && aligned(x, k, bias, out, 16))
    return launch<float4>(x, k, bias, out, B, H, W, C / 4, stream);
  return launch<float>(x, k, bias, out, B, H, W, C, stream);
}

// The same on bf16 tensors (fp32 arithmetic, the output rounded once); the
// four-channel route needs C % 4 == 0 and 8-byte aligned pointers.
extern "C" int ff_dwconv3x3_bf16(const void* x, const void* k,
                                 const void* bias, void* out, int B, int H,
                                 int W, int C, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (C % 4 == 0 && aligned(x, k, bias, out, 8))
    return launch<Bf16x4>(x, k, bias, out, B, H, W, C / 4, stream);
  return launch<__nv_bfloat16>(x, k, bias, out, B, H, W, C, stream);
}
