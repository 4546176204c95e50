// One-pass LayerNorm over the last axis, fp32 or bf16 in and out:
//     mean = sum(x) / C,  var = sum(x^2) / C - mean^2   (fp32, no clamp)
//     out  = (x - mean) * rsqrt(var + eps) * weight + bias
//
// Replaces the Pallas kernel freqfusion_tpu/ops/layernorm.py:
// fused_layernorm (:70). No model of either package calls it: the JAX
// models kept flax's LayerNorm, and the port's keep nn.LayerNorm.
//
// What bounds it on the H100: memory. About 8 operations per element
// against 8 bytes (fp32) or 4 (bf16) read and written once, far below the
// fp32 balance point of 20 operations per byte. At 172,032 rows x C 180..
// 360 (the experts' LN widths at the 336x512 bucket) a call moves 0.25 to
// 0.50 GB, 74 to 148 us at 3.35 TB/s.
//
// Design: one warp per row, eight rows per block. The first loop sums x
// and x^2 together (both moments in one pass, in fp32 registers), the
// lanes' partial sums meet through shuffles, and the second loop reads
// the row again (from L1: a warp's row is at most a few KB) to normalise
// it. With C % 4 == 0 and aligned bases each lane moves four elements at
// a time (a float4 of fp32, 8 bytes of bf16); otherwise one. bf16 output
// rounds to nearest even. Not tuned: a row of C 180 is 45 float4s, so
// the second step of each loop keeps 13 of the warp's 32 lanes busy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;  // one warp per row

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive elements as floats, and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float norm1(float x, float mean, float inv, float w,
                                       float b) {
  return fmaf((x - mean) * inv, w, b);
}

template <typename T, bool VEC>  // VEC: C % 4 == 0, aligned bases
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, T* __restrict__ out, int rows,
                 int C, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp: the shuffles below are safe
  const T* xr = x + row * C;
  T* yr = out + row * C;

  float s = 0.f, s2 = 0.f;
  if constexpr (VEC) {
    for (int c = 4 * lane; c < C; c += 128) {
      const float4 v = load4(xr + c);
      s += (v.x + v.y) + (v.z + v.w);
      s2 += fmaf(v.x, v.x, v.y * v.y) + fmaf(v.z, v.z, v.w * v.w);
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float v = to_f(xr[c]);
      s += v;
      s2 = fmaf(v, v, s2);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float inv_c = 1.f / C;
  const float mean = s * inv_c;
  const float inv = rsqrtf(s2 * inv_c - mean * mean + eps);

  if constexpr (VEC) {
    for (int c = 4 * lane; c < C; c += 128) {
      const float4 v = load4(xr + c);
      const float4 wv = load4(w + c), bv = load4(b + c);
      store4(yr + c, make_float4(norm1(v.x, mean, inv, wv.x, bv.x),
                                 norm1(v.y, mean, inv, wv.y, bv.y),
                                 norm1(v.z, mean, inv, wv.z, bv.z),
                                 norm1(v.w, mean, inv, wv.w, bv.w)));
    }
  } else {
    for (int c = lane; c < C; c += 32)
      store1(yr + c, norm1(to_f(xr[c]), mean, inv, w[c], b[c]));
  }
}

template <typename T>
cudaError_t layernorm_launch(const void* x, const float* w, const float* b,
                             void* out, int rows, int C, float eps,
                             cudaStream_t s) {
  const size_t vec_bytes = 4 * sizeof(T);
  const bool vec = C % 4 == 0 &&
                   reinterpret_cast<size_t>(x) % vec_bytes == 0 &&
                   reinterpret_cast<size_t>(out) % vec_bytes == 0 &&
                   reinterpret_cast<size_t>(w) % 16 == 0 &&
                   reinterpret_cast<size_t>(b) % 16 == 0;
  const dim3 grid((rows + kRows - 1) / kRows);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec)
    layernorm_kernel<T, true><<<grid, kThreads, 0, s>>>(xt, w, b, ot, rows,
                                                        C, eps);
  else
    layernorm_kernel<T, false><<<grid, kThreads, 0, s>>>(xt, w, b, ot, rows,
                                                         C, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: [rows, C] contiguous, fp32 (bf16 == 0) or bf16 (bf16 == 1);
// weight, bias: [C] fp32 contiguous. rows >= 1.
extern "C" int ff_layernorm(const void* x, const float* weight,
                            const float* bias, void* out, int rows, int C,
                            int bf16, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(bf16 ? layernorm_launch<__nv_bfloat16>(x, weight, bias, out,
                                                    rows, C, eps, s)
                  : layernorm_launch<float>(x, weight, bias, out, rows, C,
                                            eps, s));
}
