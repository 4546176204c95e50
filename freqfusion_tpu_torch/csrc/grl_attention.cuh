// GRL mixed attention, the body of one (8x8 tile, head): the window half
// and the anchored stripe half, fp32, from q/k/v tiles already in shared
// memory. Shared by grl_attention.cu (which loads q/k/v from six NHWC
// tensors) and grl_attention_qkv.cu (which projects them from x in the
// block). Per tile and head:
//   window half   softmax(nrm(q) nrm(k)^T * scale_w[h] + bias_w[h] + mask) v
//   stripe half   x1  = softmax(nrm(a) nrm(k)^T * s1[h] + bias_s1[h]) v
//                 out = softmax(nrm(q) nrm(a)^T * s2[h] + bias_s2[h]) x1
// where nrm is the per-head L2 normalisation of torch's F.normalize
// (x / max(||x||, 1e-12)) and a is the tile's (ws/df)^2 anchors.
//
// Operand tiles are [rows][hd + 1] (the odd row stride sends column walks
// to distinct banks); logits [rows][cols + 1]; the stripe summary x1
// never leaves the block. Outputs go straight to their NHWC places.

#pragma once

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

// Where one (tile, head) writes: batch b, tile origin (y0, x0) in an
// [H, W] image of C2-channel pixels, tile width ws, channels ch0 + d.
struct TileOut {
  int b, H, W, C2, y0, x0, ws, ch0;
};

// Window head: Q, K, V [n][hd + 1] raw (normalised here), S [n][n + 1].
__device__ void window_head(float* Q, float* K, float* V, float* S, int n,
                            int hd, float scale,
                            const float* __restrict__ bias_h,
                            const float* __restrict__ mask_t,
                            float* __restrict__ out, TileOut t) {
  const int ld = hd + 1;
  l2_normalize_rows(Q, ld, n, hd);
  l2_normalize_rows(K, ld, n, hd);
  __syncthreads();
  attention_probs(S, n + 1, Q, K, ld, n, n, hd, scale, bias_h, mask_t);
  probs_times_values(S, n + 1, V, ld, n, n, hd, nullptr, 0, out, t.b, t.H,
                     t.W, t.C2, t.y0, t.x0, t.ws, t.ch0);
}

// Stripe head: Q, K, V [n][hd + 1] and A [na][hd + 1] raw (normalised
// here); S1 [na][n + 1], X1 [na][hd + 1], S2 [n][na + 1].
__device__ void stripe_head(float* Q, float* K, float* V, float* A, float* S1,
                            float* X1, float* S2, int n, int na, int hd,
                            float scale1, float scale2,
                            const float* __restrict__ bias1_h,
                            const float* __restrict__ bias2_h,
                            float* __restrict__ out, TileOut t) {
  const int ld = hd + 1;
  l2_normalize_rows(Q, ld, n, hd);
  l2_normalize_rows(K, ld, n, hd);
  l2_normalize_rows(A, ld, na, hd);
  __syncthreads();
  // stage 1: the anchors attend to the tile's keys and values
  attention_probs(S1, n + 1, A, K, ld, na, n, hd, scale1, bias1_h, nullptr);
  probs_times_values(S1, n + 1, V, ld, na, n, hd, X1, ld, nullptr, 0, 0, 0,
                     0, 0, 0, 0, 0);
  // stage 2: the tile's queries attend to the anchor summary
  attention_probs(S2, na + 1, Q, A, ld, n, na, hd, scale2, bias2_h, nullptr);
  probs_times_values(S2, na + 1, X1, ld, n, na, hd, nullptr, 0, out, t.b,
                     t.H, t.W, t.C2, t.y0, t.x0, t.ws, t.ch0);
}

// Floats a window head needs beyond its Q, K, V tiles, and a stripe head
// beyond its Q, K, V tiles (A, S1, X1, S2).
__host__ __device__ inline size_t window_extra_floats(int n) {
  return size_t(n) * (n + 1);
}

__host__ __device__ inline size_t stripe_extra_floats(int n, int na, int hd) {
  return size_t(2) * na * (hd + 1) + size_t(na) * (n + 1) +
         size_t(n) * (na + 1);
}

}  // namespace
