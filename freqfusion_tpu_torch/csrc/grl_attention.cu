// GRL mixed attention over NHWC tensors: the window half and the anchored
// stripe half of one 8x8 tile, fp32.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_attention.py:
// fused_grl_mixed_attention_nhwc (:548), which every GRL-B block calls
// (freqfusion_tpu/models/grl.py:426-441). The per-head body is in
// grl_attention.cuh, which grl_attention_qkv.cu shares.
//
// What bounds it on the H100: GRL-B's tiles are small (N = 64 tokens,
// Na = 16 anchors, head dim 30), so each (tile, head) is ~0.5 MFLOP over
// ~35 KB of operands; the whole call reads the six C/2 halves and the
// anchor once and writes two outputs. The work is latency- and
// shared-memory-bound, not FLOP-bound.
//
// Design: one block per (batch * tile, head). A block runs window head h
// (if h < heads_w) and then stripe head h (if h < heads_s), each entirely
// in shared memory. Offsets come from blockIdx; no partition or
// head-transpose copies.

#include "grl_attention.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
grl_mixed_attention_kernel(
    const float* __restrict__ qw, const float* __restrict__ kw,
    const float* __restrict__ vw, const float* __restrict__ qs,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const float* __restrict__ anchor, const float* __restrict__ scale_w,
    const float* __restrict__ scale_s1, const float* __restrict__ scale_s2,
    const float* __restrict__ bias_w, const float* __restrict__ bias_s1,
    const float* __restrict__ bias_s2, const float* __restrict__ mask,
    float* __restrict__ out_w, float* __restrict__ out_s, int H, int W,
    int C2, int heads_w, int heads_s, int ws, int df) {
  extern __shared__ float smem[];
  const int nwx = W / ws;
  const int ntile = (H / ws) * nwx;
  const int b = blockIdx.x / ntile;
  const int t = blockIdx.x % ntile;
  const int ty = t / nwx, tx = t % nwx;
  const int head = blockIdx.y;
  const int n = ws * ws;
  const int aws = ws / df, na = aws * aws;
  const int y0 = ty * ws, x0 = tx * ws;

  if (head < heads_w) {
    const int hd = C2 / heads_w, ld = hd + 1, ch0 = head * hd;
    float* Q = smem;
    float* K = Q + n * ld;
    float* V = K + n * ld;
    load_tile(Q, ld, qw, b, H, W, C2, y0, x0, ws, n, ch0, hd);
    load_tile(K, ld, kw, b, H, W, C2, y0, x0, ws, n, ch0, hd);
    load_tile(V, ld, vw, b, H, W, C2, y0, x0, ws, n, ch0, hd);
    __syncthreads();
    window_head(Q, K, V, V + n * ld, n, hd, scale_w[head],
                bias_w + (long long)head * n * n,
                mask ? mask + (long long)t * n * n : nullptr, out_w,
                TileOut{b, H, W, C2, y0, x0, ws, ch0});
    __syncthreads();
  }

  if (head < heads_s) {
    const int hd = C2 / heads_s, ld = hd + 1, ch0 = head * hd;
    float* Q = smem;
    float* K = Q + n * ld;
    float* V = K + n * ld;
    float* A = V + n * ld;          // [na][ld]
    float* S1 = A + na * ld;        // [na][n + 1]
    float* X1 = S1 + na * (n + 1);  // [na][ld]
    float* S2 = X1 + na * ld;       // [n][na + 1]
    load_tile(Q, ld, qs, b, H, W, C2, y0, x0, ws, n, ch0, hd);
    load_tile(K, ld, ks, b, H, W, C2, y0, x0, ws, n, ch0, hd);
    load_tile(V, ld, vs, b, H, W, C2, y0, x0, ws, n, ch0, hd);
    load_tile(A, ld, anchor, b, H / df, W / df, C2, ty * aws, tx * aws, aws,
              na, ch0, hd);
    __syncthreads();
    stripe_head(Q, K, V, A, S1, X1, S2, n, na, hd, scale_s1[head],
                scale_s2[head], bias_s1 + (long long)head * na * n,
                bias_s2 + (long long)head * n * na, out_s,
                TileOut{b, H, W, C2, y0, x0, ws, ch0});
  }
}

}  // namespace

// q/k/v halves, out_w, out_s: [B, H, W, C2]; anchor [B, H/df, W/df, C2];
// scale_w [heads_w], scale_s1/scale_s2 [heads_s]; bias_w [heads_w, N, N],
// bias_s1 [heads_s, Na, N], bias_s2 [heads_s, N, Na]; mask [nW, N, N] or
// null. All fp32 contiguous; H % ws == 0 == W % ws.
extern "C" int ff_grl_mixed_attention_nhwc(
    const float* qw, const float* kw, const float* vw, const float* qs,
    const float* ks, const float* vs, const float* anchor,
    const float* scale_w, const float* scale_s1, const float* scale_s2,
    const float* bias_w, const float* bias_s1, const float* bias_s2,
    const float* mask, float* out_w, float* out_s, int B, int H, int W,
    int C2, int heads_w, int heads_s, int ws, int df, void* stream) {
  const int n = ws * ws, na = (ws / df) * (ws / df);
  const int hdw = C2 / heads_w, hds = C2 / heads_s;
  size_t floats = size_t(3) * n * (hdw + 1) + window_extra_floats(n);
  const size_t sf = size_t(3) * n * (hds + 1) + stripe_extra_floats(n, na, hds);
  if (sf > floats) floats = sf;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      grl_mixed_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(B * (H / ws) * (W / ws), heads_w > heads_s ? heads_w : heads_s);
  grl_mixed_attention_kernel<<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      qw, kw, vw, qs, ks, vs, anchor, scale_w, scale_s1, scale_s2, bias_w,
      bias_s1, bias_s2, mask, out_w, out_s, H, W, C2, heads_w, heads_s, ws,
      df);
  return int(cudaGetLastError());
}
