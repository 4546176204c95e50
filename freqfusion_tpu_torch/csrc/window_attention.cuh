// Window multi-head self-attention straight from NHWC q/k/v, fp32: the
// body shared by window_attention.cu (q, k, v as three tensors) and
// window_attention_qkv.cu (q, k, v as the column thirds of one projected
// [B, H, W, 3C] tensor). Per (batch, ws x ws window, head):
//     out = softmax(q k^T * scale + bias[h] + mask[w]) v
// with window partition and reverse folded into the addressing. The
// template flag WM selects the window-major form instead (TPU kernel #10,
// q/k/v [B_, N, C] with the windows already partitioned): token i of
// window b is row b * N + i, its mask is mask[b % nW], and N is any size;
// the NHWC form's code is unchanged by the flag.
//
// What bounds it on the H100: DRCT-L's dense blocks have head dims 30, 53,
// 122, 46 and 77 (C = 180..308 over 6/4/2/6/4 heads), window 16 (N = 256).
// The FLOPs are 4 N^2 hd per (window, head), run here on the fp32 CUDA
// cores; device-memory traffic is only q/k/v/out once plus the bias and
// mask rows, which stay in L2. One head's K and V for a whole window at
// hd 122 take 2 * 256 * 122 * 4 B = 250 KB, more than the 227 KB a block
// may use, so K/V cannot stay resident.
//
// Design: one block per (batch * window, head, 64-query tile); keys are
// walked in 64-key tiles with an online (flash-style) softmax, so shared
// memory holds one Q tile and one K/V tile whatever the head dim; the P
// tile reuses the K tile's space once S is in registers, which keeps hd
// 122 at 102 KB and two blocks per SM. Both products are register-tiled
// as in a SGEMM: thread (ty, tx) of a 16 x 16 grid owns query rows
// 4 ty .. 4 ty + 3, and
//   - in S = Q K^T the keys 4 tx .. 4 tx + 3: per head dim one float4 of
//     the transposed Q tile and one of the transposed K tile feed 16 FMAs,
//     so the FMA pipe, not shared-memory bandwidth, is the limit;
//   - in O += P V the dims tx + 16 k (k < DPT): per key one float4 of the
//     transposed P tile and DPT scalars of V feed 4 DPT FMAs.
// A row's softmax statistics live in the 16 lanes of one half-warp and
// meet through four shuffles. P is stored transposed with its 4-row groups
// XOR-swizzled by key, so the half-warp's float4 stores hit distinct banks
// while each reader's key row stays uniform. Zero-padded V dims run to
// 16 DPT; out-of-range keys get a -inf score. No partition copies: every
// thread computes its window's NHWC offsets from blockIdx. Tensor cores
// (wgmma), TMA and bf16 are left to later versions.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;       // queries per block, keys per tile
constexpr int kThreads = 256;   // 16 x 16, each 4 rows x 4 keys of S
constexpr int kLd = kTile + 4;  // row stride of the transposed Q/K tiles
static_assert(kThreads == 4 * kTile, "tile loads: 4 threads per tile row");

// Offset in the transposed P tile of key j's float4 of query rows
// 4 g .. 4 g + 3.
__device__ __forceinline__ int pt_offset(int j, int g) {
  return j * kTile + 4 * (g ^ ((j >> 2) & 7));
}

// Floats of the region holding the K tile and, later, the P tile.
__host__ __device__ constexpr int kt_floats(int hdp) {
  return hdp * kLd > kTile * kTile ? hdp * kLd : kTile * kTile;
}

// q, k, v: pixel rows of `ldi` floats (C for separate tensors, 3 C for one
// packed projection); out: pixel rows of C floats. The window-major form
// reads only wm_n (N) and wm_nw (nW) of the geometry; the NHWC form reads
// H, W and ws and not those two.
template <int DPT,   // head dims per thread in P V: 16 * DPT >= hd
          bool WM>   // window-major [B_, N, C] rows instead of NHWC
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, int ldi,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask,
                        float* __restrict__ out,
                        int H, int W, int C, int hd, int ws, float scale,
                        int wm_n, int wm_nw) {
  constexpr int hdp = 16 * DPT;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [hdp][kLd] q^T * scale
  float* kt = qt + hdp * kLd;                   // [hdp][kLd] k^T of a tile
  float* pt = kt;  // [kTile][kTile] P^T, once S is in registers
  float* vs = kt + kt_floats(hdp);              // [kTile][hdp] v of a tile

  const int n = WM ? wm_n : ws * ws;
  const int nww = WM ? 1 : W / ws;
  const int nw_img = WM ? wm_nw : (H / ws) * nww;
  const int b = WM ? blockIdx.x : blockIdx.x / nw_img;
  const int win = blockIdx.x % nw_img;  // the mask's window
  const int wy = win / nww, wx = win % nww;
  const int head = blockIdx.y;
  const int q0 = blockIdx.z * kTile;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  // Row of window token i: its NHWC pixel, or b * N + i window-major.
  auto pixel = [&](int i) -> long long {
    if constexpr (WM) {
      return (long long)b * n + i;
    } else {
      const int y = wy * ws + i / ws, x = wx * ws + i % ws;
      return ((long long)b * H + y) * W + x;
    }
  };
  const int ch0 = head * hd;

  // Tile loads: thread tid copies dims tid % 4, + 4, ... of tile row tid / 4.
  const int lrow = tid / 4, lcol = tid % 4;
  {
    const bool ok = q0 + lrow < n;
    const long long base = ok ? pixel(q0 + lrow) * ldi + ch0 : 0;
    for (int d = lcol; d < hd; d += 4)
      qt[d * kLd + lrow] = ok ? q[base + d] * scale : 0.f;
    for (int d = hd + lcol; d < hdp; d += 4) vs[lrow * hdp + d] = 0.f;
  }
  // float4 bias / mask reads need rows of a multiple of 4 and aligned bases
  const bool vec = n % 4 == 0 && reinterpret_cast<size_t>(bias) % 16 == 0 &&
                   reinterpret_cast<size_t>(mask) % 16 == 0;

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[r][c] = 0.f;
  }
  const float* brow[4];
  const float* mrow[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = min(q0 + 4 * ty + r, n - 1);
    brow[r] = bias + ((long long)head * n + i) * n;
    mrow[r] = mask ? mask + ((long long)win * n + i) * n : nullptr;
  }

  for (int k0 = 0; k0 < n; k0 += kTile) {
    const int nk = min(kTile, n - k0);
    __syncthreads();  // the previous tile's V and P are consumed
    {
      const bool ok = lrow < nk;
      const long long base = ok ? pixel(k0 + lrow) * ldi + ch0 : 0;
      for (int d = lcol; d < hd; d += 4) {
        kt[d * kLd + lrow] = ok ? k[base + d] : 0.f;
        vs[lrow * hdp + d] = ok ? v[base + d] : 0.f;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLd + 4 * ty);
      const float4 bk = *reinterpret_cast<const float4*>(kt + d * kLd + 4 * tx);
      const float qa[4] = {a.x, a.y, a.z, a.w};
      const float kb[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float add[4] = {0.f, 0.f, 0.f, 0.f};
      if (vec) {  // nk % 4 == 0: this thread's 4 keys are all in or all out
        if (4 * tx < nk) {
          const float4 bb =
              *reinterpret_cast<const float4*>(brow[r] + k0 + 4 * tx);
          float4 mm = make_float4(0.f, 0.f, 0.f, 0.f);
          if (mrow[r])
            mm = *reinterpret_cast<const float4*>(mrow[r] + k0 + 4 * tx);
          add[0] = bb.x + mm.x;
          add[1] = bb.y + mm.y;
          add[2] = bb.z + mm.z;
          add[3] = bb.w + mm.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * tx + c;
          if (j < nk)
            add[c] = brow[r][k0 + j] + (mrow[r] ? mrow[r][k0 + j] : 0.f);
        }
      }
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = 4 * tx + c < nk ? s[r][c] + add[c] : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[r], mx);  // finite: every tile has a key
      const float corr = expf(m[r] - mn);  // 0 on the first tile
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - mn);
        ps += s[r][c];
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[r] = l[r] * corr + ps;
      m[r] = mn;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[r][c] *= corr;
    }
    __syncthreads();  // every warp is done reading the K tile P replaces
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(pt + pt_offset(4 * tx + c, ty)) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // keys j >= nk have P = 0 and V = 0
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(pt + pt_offset(j, ty));
      const float* vr = vs + j * hdp + tx;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const float vv = vr[16 * c];
        acc[0][c] = fmaf(p.x, vv, acc[0][c]);
        acc[1][c] = fmaf(p.y, vv, acc[1][c]);
        acc[2][c] = fmaf(p.z, vv, acc[2][c]);
        acc[3][c] = fmaf(p.w, vv, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    if (i < n) {
      const float inv = 1.f / l[r];
      const long long base = pixel(i) * C + ch0;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int d = tx + 16 * c;
        if (d < hd) out[base + d] = acc[r][c] * inv;
      }
    }
  }
}

// One launch over `windows` windows of n tokens: the NHWC form's geometry
// is (B, H, W, ws), the window-major form's (n, nw).
template <int DPT, bool WM>
cudaError_t window_attention_launch_dpt(
    const float* q, const float* k, const float* v, int ldi,
    const float* bias, const float* mask, float* out, int windows, int n,
    int H, int W, int C, int num_heads, int ws, int nw, float scale,
    cudaStream_t stream) {
  const int hd = C / num_heads;
  const size_t smem = (size_t(16) * DPT * kLd + kt_floats(16 * DPT) +
                       size_t(kTile) * 16 * DPT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<DPT, WM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(windows, num_heads, (n + kTile - 1) / kTile);
  window_attention_kernel<DPT, WM><<<grid, kThreads, smem, stream>>>(
      q, k, v, ldi, bias, mask, out, H, W, C, hd, ws, scale, n, nw);
  return cudaGetLastError();
}

// Dims per thread sized to DRCT-L's head dims (30, 46, 53, 77, 122 ->
// 2, 3, 4, 5, 8): unused dims cost FMAs on every key. hd <= 256.
template <bool WM>
cudaError_t window_attention_dispatch(
    const float* q, const float* k, const float* v, int ldi,
    const float* bias, const float* mask, float* out, int windows, int n,
    int H, int W, int C, int num_heads, int ws, int nw, float scale,
    cudaStream_t s) {
  const int dpt = (C / num_heads + 15) / 16;
#define FF_WINDOW_LAUNCH(P)                                                  \
  if (dpt <= P)                                                              \
    return window_attention_launch_dpt<P, WM>(q, k, v, ldi, bias, mask, out, \
                                              windows, n, H, W, C, num_heads, \
                                              ws, nw, scale, s);
  FF_WINDOW_LAUNCH(2)
  FF_WINDOW_LAUNCH(3)
  FF_WINDOW_LAUNCH(4)
  FF_WINDOW_LAUNCH(5)
  FF_WINDOW_LAUNCH(6)
  FF_WINDOW_LAUNCH(8)
  FF_WINDOW_LAUNCH(16)
#undef FF_WINDOW_LAUNCH
  return cudaErrorInvalidValue;
}

// q, k, v: [B, H, W] pixels of `ldi` floats, each head's hd channels at
// head * hd; out [B, H, W, C]; bias [heads, N, N]; mask [nW, N, N] or
// null (N = ws * ws, H % ws == 0 == W % ws, hd <= 256).
cudaError_t window_attention_launch(const float* q, const float* k,
                                    const float* v, int ldi,
                                    const float* bias, const float* mask,
                                    float* out, int B, int H, int W, int C,
                                    int num_heads, int ws, float scale,
                                    cudaStream_t s) {
  return window_attention_dispatch<false>(
      q, k, v, ldi, bias, mask, out, B * (H / ws) * (W / ws), ws * ws, H, W,
      C, num_heads, ws, 0, scale, s);
}

}  // namespace
