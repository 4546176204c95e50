// GRL mixed attention with its 6-way qkv projection in the kernel, fp32:
// the window half projects q/k/v from x_rolled (x rolled by (-s, -s) for
// shifted blocks, else x), the stripe half from x, with the weight
// segments qw | kw | vw | qs | ks | vs (each C/2 columns of wqkv [C, 3C]),
// then both halves run as in grl_attention.cu.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_attention.py:
// fused_grl_mixed_attention_qkv_nhwc (:795), which FREQFUSION_GRL_QKV=1
// routes GRL-B's 40 blocks through (freqfusion_tpu/models/grl.py:403).
//
// What bounds it on the H100: operations. The projection is 2 * 180 * 540
// FLOPs a pixel, about five times the attention's 90 * (4 * 64 + 8 * 16),
// so a 336x512 call is 0.59 ms on the fp32 cores; the bytes (x, x_rolled,
// the anchor and two C/2 outputs once) are 0.23 ms.
//
// Design: one block per (batch * 8x8 tile, head), as grl_attention.cu.
// Before each half the block projects its head's q, k and v columns
// (3 hd = 90 of the 540) for the tile's 64 tokens straight into the
// shared-memory tiles that grl_attention.cuh's window_head and
// stripe_head consume, so q/k/v never reach device memory. A first small
// launch packs each (half, head)'s weight columns into one contiguous,
// zero-padded [C][16 NJ] slab, so the block stages its weights as plain
// float4 copies. The projection is a register-tiled 64 x 3hd x C
// product: thread (ty, tx) owns tokens 4 ty .. 4 ty + 3 and columns
// NJ tx .. NJ tx + NJ - 1 (read as float2s); x and the weights are staged
// 32 input channels at a time, x transposed so a thread's four tokens
// are one float4, and the next chunk is loaded into registers while the
// current one is multiplied. Each head's block re-reads the tile's x
// (46 KB, from L2 after the first head) and projects only its own
// columns, so no product is computed twice. The staging buffers share
// their space with the attention's logits.

#include "grl_attention.cuh"

namespace {

constexpr int kRows = 64;         // tokens a block projects (ws * ws <= 64)
constexpr int kDepth = 32;        // input channels staged at a time
constexpr int kXLd = kRows + 4;   // row stride of the transposed x chunk

__host__ __device__ constexpr int stage_floats(int nj) {
  return kDepth * kXLd + kDepth * 16 * nj;
}

// Floats of Q, K, V [n][hd + 1], rounded up so what follows is 16-byte
// aligned.
__host__ __device__ inline int qkv_floats(int n, int hd) {
  return (3 * n * (hd + 1) + 3) & ~3;
}

// wpack[((half * heads + head) * Cin + c) * 16 NJ + j] = wqkv[c][col0 +
// s C2 + head * hd + d] for j = s hd + d < 3 hd (s = 0, 1, 2 for q, k, v;
// col0 = 0 for the window half, 3 C2 for the stripe half), 0 for j >= 3 hd:
// each (half, head) gets one contiguous [Cin][16 NJ] slab of its columns.
__global__ void pack_weights_kernel(const float* __restrict__ w,
                                    float* __restrict__ wpack, int Cin,
                                    int C2, int heads_w, int heads_s,
                                    int heads, int nw) {
  const long long total = 2LL * heads * Cin * nw;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int j = int(e % nw);
    const long long r = e / nw;
    const int c = int(r % Cin);
    const int slab = int(r / Cin), half = slab / heads, head = slab % heads;
    const int hd = C2 / (half ? heads_s : heads_w);
    const bool ok = head < (half ? heads_s : heads_w) && j < 3 * hd;
    const int s = ok ? j / hd : 0;
    wpack[e] = ok ? w[(long long)c * 6 * C2 + half * 3 * C2 + s * C2 +
                      head * hd + j - s * hd]
                  : 0.f;
  }
}

// Q, K, V [n][hd + 1] of one head = x_tile W + bias for the head's packed
// weight slab W [Cin][16 NJ] (pack_weights_kernel) and bias columns
// col0 + s C2 + ch0 + d. Starts with a barrier (the previous users of
// Q/K/V and `stage` are done); the caller syncs before reading Q/K/V.
// The next chunk's x and W are loaded into registers while the current
// one is multiplied.
template <int NJ>  // 16 NJ >= 3 hd columns; thread tx owns NJ tx .. + NJ - 1
__device__ void project_head(float* Q, float* K, float* V, float* stage,
                             const float* __restrict__ x, int b, int H,
                             int W, int Cin, int y0, int x0, int ws,
                             const float* __restrict__ wslab,
                             const float* __restrict__ bias, int col0,
                             int C2, int ch0, int hd) {
  constexpr int NW = 16 * NJ;
  constexpr int kXPer = kRows * kDepth / kThreads;     // x floats a thread
  constexpr int kWPer = kDepth * NW / 4 / kThreads;    // W float4s a thread
  static_assert(kDepth * NW % (4 * kThreads) == 0, "whole float4 chunks");
  float* Xt = stage;                  // [kDepth][kXLd]: x chunk, transposed
  float* Wc = stage + kDepth * kXLd;  // [kDepth][NW]: weight chunk
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n = ws * ws, ncol = 3 * hd, ld = hd + 1;
  // x: thread tid stages channel tid % 32 of tokens tid / 32 + 8 q
  const int xc = tid % kDepth;
  int xpix[kXPer];  // NHWC pixel index of each staged token, -1 past n
#pragma unroll
  for (int q = 0; q < kXPer; ++q) {
    const int i = tid / kDepth + (kThreads / kDepth) * q;
    xpix[q] = i < n ? (b * H + y0 + i / ws) * W + x0 + i % ws : -1;
  }
  float rx[kXPer];
  float4 rw[kWPer];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int q = 0; q < kXPer; ++q)
      rx[q] = xpix[q] >= 0 && c0 + xc < Cin
                  ? x[(long long)xpix[q] * Cin + c0 + xc] : 0.f;
#pragma unroll
    for (int q = 0; q < kWPer; ++q) {
      const int e4 = tid + kThreads * q;  // float4 index in the chunk
      rw[q] = c0 + e4 * 4 / NW < Cin
                  ? *reinterpret_cast<const float4*>(wslab + (long long)c0 * NW +
                                                     4 * e4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int q = 0; q < kXPer; ++q)
      Xt[xc * kXLd + tid / kDepth + (kThreads / kDepth) * q] = rx[q];
#pragma unroll
    for (int q = 0; q < kWPer; ++q)
      reinterpret_cast<float4*>(Wc)[tid + kThreads * q] = rw[q];
  };

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  fetch(0);
  __syncthreads();
  stash();
  __syncthreads();
  for (int c0 = 0; c0 < Cin; c0 += kDepth) {
    const bool more = c0 + kDepth < Cin;
    if (more) fetch(c0 + kDepth);
    const int depth = min(kDepth, Cin - c0);
    for (int c = 0; c < depth; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(Xt + c * kXLd + 4 * ty);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        const float2 bw =
            *reinterpret_cast<const float2*>(Wc + c * NW + NJ * tx + j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(av[i], bw.x, acc[i][j]);
          acc[i][j + 1] = fmaf(av[i], bw.y, acc[i][j + 1]);
        }
      }
    }
    __syncthreads();
    if (more) stash();
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = NJ * tx + j;
    if (col >= ncol) continue;
    const int s = col / hd, d = col - s * hd;
    const float bv = bias[col0 + s * C2 + ch0 + d];
    float* dst = s == 0 ? Q : s == 1 ? K : V;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * ty + i;
      if (row < n) dst[row * ld + d] = acc[i][j] + bv;
    }
  }
}

template <int NJ>
__global__ void __launch_bounds__(kThreads)
grl_mixed_attention_qkv_kernel(
    const float* __restrict__ x, const float* __restrict__ x_rolled,
    const float* __restrict__ anchor, const float* __restrict__ wpack,
    const float* __restrict__ bqkv, const float* __restrict__ scale_w,
    const float* __restrict__ scale_s1, const float* __restrict__ scale_s2,
    const float* __restrict__ bias_w, const float* __restrict__ bias_s1,
    const float* __restrict__ bias_s2, const float* __restrict__ mask,
    float* __restrict__ out_w, float* __restrict__ out_s, int H, int W,
    int Cin, int C2, int heads_w, int heads_s, int ws, int df) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nwx = W / ws;
  const int ntile = (H / ws) * nwx;
  const int b = blockIdx.x / ntile;
  const int t = blockIdx.x % ntile;
  const int ty = t / nwx, tx = t % nwx;
  const int head = blockIdx.y;
  const int n = ws * ws;
  const int aws = ws / df, na = aws * aws;
  const int y0 = ty * ws, x0 = tx * ws;
  const int heads = heads_w > heads_s ? heads_w : heads_s;
  const long long slab = (long long)Cin * 16 * NJ;

  if (head < heads_w) {
    const int hd = C2 / heads_w, ch0 = head * hd;
    float* Q = smem;
    float* K = Q + n * (hd + 1);
    float* V = K + n * (hd + 1);
    float* R = smem + qkv_floats(n, hd);
    project_head<NJ>(Q, K, V, R, x_rolled, b, H, W, Cin, y0, x0, ws,
                     wpack + head * slab, bqkv, 0, C2, ch0, hd);
    __syncthreads();
    window_head(Q, K, V, R, n, hd, scale_w[head],
                bias_w + (long long)head * n * n,
                mask ? mask + (long long)t * n * n : nullptr, out_w,
                TileOut{b, H, W, C2, y0, x0, ws, ch0});
  }

  if (head < heads_s) {
    const int hd = C2 / heads_s, ld = hd + 1, ch0 = head * hd;
    float* Q = smem;
    float* K = Q + n * ld;
    float* V = K + n * ld;
    float* R = smem + qkv_floats(n, hd);
    project_head<NJ>(Q, K, V, R, x, b, H, W, Cin, y0, x0, ws,
                     wpack + (heads + head) * slab, bqkv, 3 * C2, C2, ch0,
                     hd);
    __syncthreads();
    float* A = R;                   // [na][ld], over the staging buffers
    float* S1 = A + na * ld;        // [na][n + 1]
    float* X1 = S1 + na * (n + 1);  // [na][ld]
    float* S2 = X1 + na * ld;       // [n][na + 1]
    load_tile(A, ld, anchor, b, H / df, W / df, C2, ty * aws, tx * aws, aws,
              na, ch0, hd);
    __syncthreads();
    stripe_head(Q, K, V, A, S1, X1, S2, n, na, hd, scale_s1[head],
                scale_s2[head], bias_s1 + (long long)head * na * n,
                bias_s2 + (long long)head * n * na, out_s,
                TileOut{b, H, W, C2, y0, x0, ws, ch0});
  }
}

template <int NJ>
cudaError_t launch(const float* x, const float* x_rolled, const float* anchor,
                   const float* wqkv, const float* bqkv, const float* scale_w,
                   const float* scale_s1, const float* scale_s2,
                   const float* bias_w, const float* bias_s1,
                   const float* bias_s2, const float* mask, float* out_w,
                   float* out_s, float* wpack, int B, int H, int W, int Cin,
                   int C2, int heads_w, int heads_s, int ws, int df,
                   cudaStream_t stream) {
  const int n = ws * ws, na = (ws / df) * (ws / df);
  const int hdw = C2 / heads_w, hds = C2 / heads_s;
  const int heads = heads_w > heads_s ? heads_w : heads_s;
  pack_weights_kernel<<<64, kThreads, 0, stream>>>(wqkv, wpack, Cin, C2,
                                                   heads_w, heads_s, heads,
                                                   16 * NJ);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  size_t rw = window_extra_floats(n), rs = stripe_extra_floats(n, na, hds);
  const size_t st = stage_floats(NJ);
  if (st > rw) rw = st;
  if (st > rs) rs = st;
  size_t floats = qkv_floats(n, hdw) + rw;
  const size_t sf = qkv_floats(n, hds) + rs;
  if (sf > floats) floats = sf;
  const size_t smem = floats * sizeof(float);
  err = cudaFuncSetAttribute(grl_mixed_attention_qkv_kernel<NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * (H / ws) * (W / ws), heads);
  grl_mixed_attention_qkv_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      x, x_rolled, anchor, wpack, bqkv, scale_w, scale_s1, scale_s2, bias_w,
      bias_s1, bias_s2, mask, out_w, out_s, H, W, Cin, C2, heads_w, heads_s,
      ws, df);
  return cudaGetLastError();
}

// Columns per thread for these head dims: 16 NJ >= 3 hd, NJ one of the
// instantiated 2, 4, 6, 8, 12 (GRL-B's head dim 30 -> 6); 0 if none fits.
int pick_nj(int C2, int heads_w, int heads_s) {
  const int hdw = C2 / heads_w, hds = C2 / heads_s;
  const int need = (3 * (hdw > hds ? hdw : hds) + 15) / 16;
  for (int nj : {2, 4, 6, 8, 12})
    if (need <= nj) return nj;
  return 0;
}

}  // namespace

// Floats of the packed-weight scratch ff_grl_mixed_attention_qkv_nhwc
// needs, or 0 for head dims it does not take.
extern "C" int ff_grl_qkv_scratch_floats(int Cin, int C2, int heads_w,
                                         int heads_s) {
  const int heads = heads_w > heads_s ? heads_w : heads_s;
  return 2 * heads * Cin * 16 * pick_nj(C2, heads_w, heads_s);
}

// x [B, H, W, Cin]; x_rolled the same shape, or null (unshifted: the
// window half projects from x); anchor [B, H/df, W/df, C2]; wqkv
// [Cin, 6 C2], bqkv [6 C2] (qw | kw | vw | qs | ks | vs); scales, biases
// and mask as ff_grl_mixed_attention_nhwc; out_w, out_s [B, H, W, C2];
// wpack scratch of ff_grl_qkv_scratch_floats floats. All fp32
// contiguous; H % ws == 0 == W % ws, ws * ws <= 64, head dims <= 64.
// Two launches: the weight packing, then the attention.
extern "C" int ff_grl_mixed_attention_qkv_nhwc(
    const float* x, const float* x_rolled, const float* anchor,
    const float* wqkv, const float* bqkv, const float* scale_w,
    const float* scale_s1, const float* scale_s2, const float* bias_w,
    const float* bias_s1, const float* bias_s2, const float* mask,
    float* out_w, float* out_s, float* wpack, int B, int H, int W, int Cin,
    int C2, int heads_w, int heads_s, int ws, int df, void* stream) {
  if (ws * ws > kRows) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xr = x_rolled ? x_rolled : x;
#define FF_GRL_QKV_LAUNCH(P)                                                 \
  case P:                                                                    \
    return int(launch<P>(x, xr, anchor, wqkv, bqkv, scale_w, scale_s1,       \
                         scale_s2, bias_w, bias_s1, bias_s2, mask, out_w,    \
                         out_s, wpack, B, H, W, Cin, C2, heads_w, heads_s,   \
                         ws, df, s));
  switch (pick_nj(C2, heads_w, heads_s)) {
    FF_GRL_QKV_LAUNCH(2)
    FF_GRL_QKV_LAUNCH(4)
    FF_GRL_QKV_LAUNCH(6)
    FF_GRL_QKV_LAUNCH(8)
    FF_GRL_QKV_LAUNCH(12)
  }
#undef FF_GRL_QKV_LAUNCH
  return int(cudaErrorInvalidValue);
}
