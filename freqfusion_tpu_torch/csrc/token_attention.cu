// Per-pixel multi-head self-attention over a short token axis, with its
// in- and out-projections, fp32 (torch nn.MultiheadAttention in eval, no
// residual):
//     q | k | v = x Win + bin                          x [P, T, E]
//     o_h       = softmax(q_h k_h^T / sqrt(hd)) v_h    per pixel and head
//     out       = o Wout + bout
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_token_attention.py:
// fused_token_attention (:78), which FREQFUSION_TOKEN_ATTN=1 routes the
// fusion net's two token attentions through
// (freqfusion_tpu/models/fusion/lka.py:157): phase 3 over the 9 bands
// (T 9, E 64, 4 heads) and phase 4 over the 4 experts (T 4, E 128, 8
// heads), P = one LR image's pixels.
//
// What bounds it on the H100: operations. A pixel costs 2 T E 3E + 2 T E^2
// FLOPs of projections and 4 T^2 E of attention: at 336x512, 0.81 ms
// (phase 3) and 1.37 ms (phase 4) on the fp32 cores, against 0.24 and
// 0.21 ms for reading x and writing out once.
//
// Design: one block of 256 threads per 64 token rows, i.e. 64 / T whole
// pixels (63 rows at T 9, 64 at T 4); the last block is masked, so P need
// not be a multiple of anything. Nothing but x, the weights and out
// touches device memory:
//   1. the block's x rows go to shared memory transposed ([E][68]), and
//      q | k | v = x Win + bin is computed 64 columns a pass into a
//      [64][3E + 1] shared tile (odd stride: a warp's 32 rows hit 32
//      banks). Win is streamed from L2 32 rows at a time, the next rows
//      loaded into registers while the current ones are multiplied, so
//      phase 4's 196 KB Win is never staged whole beside the pixel tile;
//   2. one thread per (row, head) computes its T logits and softmax in
//      registers and writes o_h over the x tile, transposed;
//   3. out = o Wout + bout, the same tiled product, straight to out.
// The products are register-tiled: thread (ty, tx) owns rows 4 ty .. +3
// and columns 4 tx .. +3 of a pass, one float4 of each operand per 16
// FMAs. The TPU's [T, E, P] transpose and lane-wide broadcast biases are
// not carried over: the kernel reads [P, T, E] as it is.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;       // token rows per block
constexpr int kLd = kRows + 4;  // row stride of the transposed row tile
constexpr int kDepth = 32;      // weight rows staged at a time
constexpr int kCols = 64;       // output columns per pass
constexpr int kMaxT = 16;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] = sum_k At[k][4 ty + i] w[k][n0 + 4 tx + j] for k < K, columns
// past N read as zero (N, ldw and n0 multiples of 4). Starts with a
// barrier (At is complete and the previous users of Wt are done). The
// next 32 weight rows are loaded into registers while the current ones
// are multiplied.
__device__ void tile_product(float (&acc)[4][4], const float* At,
                             const float* __restrict__ w, int ldw, int n0,
                             int N, int K, float* Wt) {
  constexpr int kPer = kDepth * kCols / 4 / kThreads;  // float4s a thread
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float4 rw[kPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e4 = tid + kThreads * q;
      const int kk = e4 / (kCols / 4), j = 4 * (e4 % (kCols / 4));
      rw[q] = k0 + kk < K && n0 + j < N
                  ? ld4(w + (long long)(k0 + kk) * ldw + n0 + j)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      reinterpret_cast<float4*>(Wt)[tid + kThreads * q] = rw[q];
  };
  fetch(0);
  __syncthreads();
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    const bool more = k0 + kDepth < K;
    if (more) fetch(k0 + kDepth);
    const int depth = min(kDepth, K - k0);
    for (int kk = 0; kk < depth; ++kk) {
      const float4 a = ld4(At + (k0 + kk) * kLd + 4 * ty);
      const float4 b = ld4(Wt + kk * kCols + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (more) stash();
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
token_attention_kernel(const float* __restrict__ x,
                       const float* __restrict__ win,
                       const float* __restrict__ bin,
                       const float* __restrict__ wout,
                       const float* __restrict__ bout,
                       float* __restrict__ out, long long rows_total, int T,
                       int E, int nh, float scale) {
  extern __shared__ float4 smem4[];
  const int ldq = 3 * E + 1;
  float* At = reinterpret_cast<float*>(smem4);  // [E][kLd]: x^T, then o^T
  float* Wt = At + E * kLd;                     // [kDepth][kCols]
  float* QKV = Wt + kDepth * kCols;             // [kRows][ldq]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = (kRows / T) * T;  // rows of whole pixels in a block
  const long long r0 = (long long)blockIdx.x * rows;
  const int hd = E / nh;

  for (int e = tid; e < kRows * E; e += kThreads) {
    const int r = e / E, c = e - r * E;
    At[c * kLd + r] =
        r < rows && r0 + r < rows_total ? x[(r0 + r) * E + c] : 0.f;
  }

  // 1. q | k | v of every row
  for (int n0 = 0; n0 < 3 * E; n0 += kCols) {
    float acc[4][4];
    tile_product(acc, At, win, 3 * E, n0, 3 * E, E, Wt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      if (col >= 3 * E) continue;
      const float bv = bin[col];
#pragma unroll
      for (int i = 0; i < 4; ++i) QKV[(4 * ty + i) * ldq + col] = acc[i][j] + bv;
    }
  }
  __syncthreads();

  // 2. attention of row r, head h over the T rows of r's pixel
  for (int item = tid; item < kRows * nh; item += kThreads) {
    const int r = item % kRows, h = item / kRows;
    if (r >= rows) continue;
    const int p0 = r - r % T;
    const float* q = QKV + r * ldq + h * hd;
    float s[kMaxT];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < T) {
        const float* kr = QKV + (p0 + j) * ldq + E + h * hd;
        float a = 0.f;
        for (int d = 0; d < hd; ++d) a = fmaf(q[d], kr[d], a);
        s[j] = a * scale;
        mx = fmaxf(mx, s[j]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < T) {
        s[j] = expf(s[j] - mx);
        sum += s[j];
      }
    }
    const float inv = 1.f / sum;
    const float* vr = QKV + p0 * ldq + 2 * E + h * hd;
    for (int d = 0; d < hd; ++d) {
      float o = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j)
        if (j < T) o = fmaf(s[j], vr[j * ldq + d], o);
      At[(h * hd + d) * kLd + r] = o * inv;
    }
  }

  // 3. the output projection (rows past the block's pixels are dropped)
  for (int n0 = 0; n0 < E; n0 += kCols) {
    float acc[4][4];
    tile_product(acc, At, wout, E, n0, E, E, Wt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      if (r >= rows || r0 + r >= rows_total) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + 4 * tx + j;
        if (col < E) out[(r0 + r) * E + col] = acc[i][j] + bout[col];
      }
    }
  }
}

}  // namespace

// x, out [P, T, E]; win [E, 3E] (q | k | v columns), bin [3E]; wout
// [E, E] ([in, out]), bout [E]. All fp32 contiguous; T <= 16,
// E % 4 == 0, E % heads == 0.
extern "C" int ff_token_attention(const float* x, const float* win,
                                  const float* bin, const float* wout,
                                  const float* bout, float* out, int P, int T,
                                  int E, int num_heads, void* stream) {
  if (T < 1 || T > kMaxT || num_heads < 1 || E % num_heads || E % 4)
    return int(cudaErrorInvalidValue);
  const size_t smem =
      (size_t(E) * kLd + kDepth * kCols + size_t(kRows) * (3 * E + 1)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      token_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const int pb = kRows / T;
  const unsigned blocks = unsigned((P + pb - 1) / pb);
  const float scale = 1.f / sqrtf(float(E / num_heads));
  token_attention_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, win, bin, wout, bout, out, (long long)P * T, T, E, num_heads, scale);
  return int(cudaGetLastError());
}
