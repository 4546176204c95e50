// GRL mixed attention over NHWC tensors: the window half and the anchored
// stripe half of one 8x8 tile, fp32.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_attention.py:
// fused_grl_mixed_attention_nhwc (:548), which every GRL-B block calls
// (freqfusion_tpu/models/grl.py:426-441). Per tile and head:
//   window half   softmax(nrm(q) nrm(k)^T * scale_w[h] + bias_w[h] + mask) v
//   stripe half   x1  = softmax(nrm(a) nrm(k)^T * s1[h] + bias_s1[h]) v
//                 out = softmax(nrm(q) nrm(a)^T * s2[h] + bias_s2[h]) x1
// where nrm is the per-head L2 normalisation of torch's F.normalize
// (x / max(||x||, 1e-12)) and a is the tile's (ws/df)^2 anchors.
//
// What bounds it on the H100: GRL-B's tiles are small (N = 64 tokens,
// Na = 16 anchors, head dim 30), so each (tile, head) is ~0.5 MFLOP over
// ~35 KB of operands; the whole call reads the six C/2 halves and the
// anchor once and writes two outputs. The work is latency- and
// shared-memory-bound, not FLOP-bound.
//
// Design: one block per (batch * tile, head). A block runs window head h
// (if h < heads_w) and then stripe head h (if h < heads_s), each entirely
// in shared memory: the 64 x hd operand tiles (row stride hd + 1, so
// column walks hit distinct banks), the 64 x 64 logits, and for the
// stripe half the 16-anchor summary x1, which never leaves the block.
// Offsets come from blockIdx; no partition or head-transpose copies.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

// Rows i < rows of one head slice of an NHWC tensor into dst[i * ld + d];
// tile token i sits at (y0 + i / tw, x0 + i % tw).
__device__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                          int b, int Hs, int Ws, int C, int y0, int x0,
                          int tw, int rows, int ch0, int hd) {
  for (int e = threadIdx.x; e < rows * hd; e += blockDim.x) {
    const int i = e / hd, d = e - i * hd;
    const int y = y0 + i / tw, x = x0 + i % tw;
    dst[i * ld + d] = src[(((long long)b * Hs + y) * Ws + x) * C + ch0 + d];
  }
}

__device__ void l2_normalize_rows(float* x, int ld, int rows, int hd) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    float* r = x + i * ld;
    float ss = 0.f;
    for (int d = 0; d < hd; ++d) ss = fmaf(r[d], r[d], ss);
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
    for (int d = 0; d < hd; ++d) r[d] = r[d] / nrm;
  }
}

// S[i][j] = (A_i . B_j) * scale + bias[i][j] (+ mask[i][j]), then a
// row softmax over j < nb.
__device__ void attention_probs(float* S, int lds, const float* A,
                                const float* Bm, int ld, int na, int nb,
                                int hd, float scale,
                                const float* __restrict__ bias,
                                const float* __restrict__ mask) {
  for (int e = threadIdx.x; e < na * nb; e += blockDim.x) {
    const int i = e / nb, j = e - i * nb;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(A[i * ld + d], Bm[j * ld + d], acc);
    float s = acc * scale + bias[e];
    if (mask) s += mask[e];
    S[i * lds + j] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < na; i += blockDim.x) {
    float* r = S + i * lds;
    float m = -INFINITY;
    for (int j = 0; j < nb; ++j) m = fmaxf(m, r[j]);
    float sum = 0.f;
    for (int j = 0; j < nb; ++j) {
      const float p = expf(r[j] - m);
      r[j] = p;
      sum += p;
    }
    const float inv = 1.f / sum;
    for (int j = 0; j < nb; ++j) r[j] *= inv;
  }
  __syncthreads();
}

// out[i][d] = sum_j P[i][j] V[j][d] for i < rows, into shared memory
// (dst_ld > 0) or into the NHWC tile of `dst_g` (token i at
// (y0 + i / tw, x0 + i % tw)).
__device__ void probs_times_values(const float* P, int ldp, const float* V,
                                   int ldv, int rows, int cols, int hd,
                                   float* dst_s, int dst_ld,
                                   float* __restrict__ dst_g, int b, int H,
                                   int W, int C, int y0, int x0, int tw,
                                   int ch0) {
  for (int e = threadIdx.x; e < rows * hd; e += blockDim.x) {
    const int i = e / hd, d = e - i * hd;
    float acc = 0.f;
    for (int j = 0; j < cols; ++j) acc = fmaf(P[i * ldp + j], V[j * ldv + d], acc);
    if (dst_s) {
      dst_s[i * dst_ld + d] = acc;
    } else {
      const int y = y0 + i / tw, x = x0 + i % tw;
      dst_g[(((long long)b * H + y) * W + x) * C + ch0 + d] = acc;
    }
  }
}

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
    float* S = V + n * ld;  // [n][n + 1]
    load_tile(Q, ld, qw, b, H, W, C2, y0, x0, ws, n, ch0, hd);
    load_tile(K, ld, kw, b, H, W, C2, y0, x0, ws, n, ch0, hd);
    load_tile(V, ld, vw, b, H, W, C2, y0, x0, ws, n, ch0, hd);
    __syncthreads();
    l2_normalize_rows(Q, ld, n, hd);
    l2_normalize_rows(K, ld, n, hd);
    __syncthreads();
    attention_probs(S, n + 1, Q, K, ld, n, n, hd, scale_w[head],
                    bias_w + (long long)head * n * n,
                    mask ? mask + (long long)t * n * n : nullptr);
    probs_times_values(S, n + 1, V, ld, n, n, hd, nullptr, 0, out_w, b, H, W,
                       C2, y0, x0, ws, ch0);
    __syncthreads();
  }

  if (head < heads_s) {
    const int hd = C2 / heads_s, ld = hd + 1, ch0 = head * hd;
    float* Q = smem;
    float* K = Q + n * ld;
    float* V = K + n * ld;
    float* A = V + n * ld;        // [na][ld]
    float* S1 = A + na * ld;      // [na][n + 1]
    float* X1 = S1 + na * (n + 1);  // [na][ld]
    float* S2 = X1 + na * ld;     // [n][na + 1]
    load_tile(Q, ld, qs, b, H, W, C2, y0, x0, ws, n, ch0, hd);
    load_tile(K, ld, ks, b, H, W, C2, y0, x0, ws, n, ch0, hd);
    load_tile(V, ld, vs, b, H, W, C2, y0, x0, ws, n, ch0, hd);
    load_tile(A, ld, anchor, b, H / df, W / df, C2, ty * aws, tx * aws, aws,
              na, ch0, hd);
    __syncthreads();
    l2_normalize_rows(Q, ld, n, hd);
    l2_normalize_rows(K, ld, n, hd);
    l2_normalize_rows(A, ld, na, hd);
    __syncthreads();
    // stage 1: the anchors attend to the tile's keys and values
    attention_probs(S1, n + 1, A, K, ld, na, n, hd, scale_s1[head],
                    bias_s1 + (long long)head * na * n, nullptr);
    probs_times_values(S1, n + 1, V, ld, na, n, hd, X1, ld, nullptr, 0, 0, 0,
                       0, 0, 0, 0, 0);
    // stage 2: the tile's queries attend to the anchor summary
    attention_probs(S2, na + 1, Q, A, ld, n, na, hd, scale_s2[head],
                    bias_s2 + (long long)head * n * na, nullptr);
    probs_times_values(S2, na + 1, X1, ld, n, na, hd, nullptr, 0, out_s, b, H,
                       W, C2, y0, x0, ws, ch0);
  }
}

size_t window_floats(int n, int hd) { return size_t(3) * n * (hd + 1) + size_t(n) * (n + 1); }

size_t stripe_floats(int n, int na, int hd) {
  return size_t(3) * n * (hd + 1) + size_t(2) * na * (hd + 1) +
         size_t(na) * (n + 1) + size_t(n) * (na + 1);
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
  size_t floats = window_floats(n, C2 / heads_w);
  const size_t sf = stripe_floats(n, na, C2 / heads_s);
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
