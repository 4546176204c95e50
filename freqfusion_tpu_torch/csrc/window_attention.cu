// Window multi-head self-attention, fp32, in two layouts.
//
// ff_window_attention_nhwc replaces the Pallas kernel
// freqfusion_tpu/ops/pallas_attention.py:fused_window_attention_nhwc
// (:238), which DRCT-L calls once per Swin block
// (freqfusion_tpu/models/drct.py:126-130), straight from NHWC q/k/v.
// ff_window_attention replaces fused_window_attention (:95), the
// window-major form over already partitioned [B_, N, C] windows; no model
// calls it. Both run the one kernel of window_attention.cuh (which
// window_attention_qkv.cu shares), where what bounds it and its design are
// set out; the window-major form is its WM template flag.

#include "window_attention.cuh"

// q, k, v, out: [B, H, W, C] fp32 contiguous; bias [heads, N, N];
// mask [nW, N, N] or null (N = ws * ws, H % ws == 0 == W % ws); hdp and
// vec from ops/attention.py:plan_window_attention.
extern "C" int ff_window_attention_nhwc(const float* q, const float* k,
                                        const float* v, const float* bias,
                                        const float* mask, float* out, int B,
                                        int H, int W, int C, int num_heads,
                                        int ws, float scale, int hdp, int vec,
                                        void* stream) {
  return int(window_attention_launch(q, k, v, C, bias, mask, out, B, H, W, C,
                                     num_heads, ws, scale, hdp, vec,
                                     static_cast<cudaStream_t>(stream)));
}

// q, k, v, out: [B_, N, C] fp32 contiguous, window b's token i at row
// b * N + i; bias [heads, N, N]; mask [nW, N, N] taken by b % nW, or null
// (B_ % nW == 0, C / heads <= 256, N any size); hdp and vec as above.
extern "C" int ff_window_attention(const float* q, const float* k,
                                   const float* v, const float* bias,
                                   const float* mask, float* out, int B_,
                                   int N, int nW, int C, int num_heads,
                                   float scale, int hdp, int vec,
                                   void* stream) {
  return int(window_attention_dispatch<true>(
      q, k, v, C, bias, mask, out, B_, N, 0, 0, C, num_heads, 0, nW, scale,
      hdp, vec, static_cast<cudaStream_t>(stream)));
}

// ---------------------------------------------------------------------------
// bf16 form: ff_window_attention_nhwc_bf16, the same function over bf16
// q, k, v and out, with the rounding points of the JAX kernel's bf16 run
// (freqfusion_tpu/ops/pallas_attention.py:_attn_heads, :165-192): q times
// scale rounded to bf16 (both bf16); the logits q k^T in fp32, plus the
// bias (bf16, as the module's bf16 table gives it) and the mask (fp32; its
// values 0 and -100 are exact in the bf16 the JAX wrapper casts it to);
// the softmax in fp32, normalised, then rounded to bf16 before P V; P V
// accumulated in fp32 and rounded to bf16 on the store.
//
// What bounds it on the H100: operations, 4 N^2 hd a (window, head) on the
// bf16 tensor cores (989 TFLOP/s): ~0.44 ms over DRCT-L's ten shapes, the
// bytes (q, k, v, out in bf16) ~1.0 ms, so at these shapes the bytes bind.
//
// Design (mma.sync m16n8k16 bf16, ldmatrix; bf16_mma.cuh's helpers), a
// simple body first: one block a (window, head), a warp each 16 query
// rows (N / 16 warps); the head's hd channels of the window's q (scaled),
// k and v go to shared memory as bf16 rows of HDP + 8 (HDP: hd rounded up
// to 16, zeros past hd, so the box adds nothing to Q K^T and P V writes
// no channel past hd), 8 channels a load item (one 16-byte load where the
// head's offset aligns, else 2-byte loads, all in flight). The JAX
// kernel normalises the softmax before it rounds P to bf16, so the keys
// are taken twice: a first sweep carries each row's max and sum (online,
// exp2 of log2 e-scaled logits), a second recomputes S (one bf16 product
// a 16-key tile, a third of a 3xTF32 one), forms P = exp2(s - max) / sum,
// rounds it to bf16 in the A fragment straight from S's accumulators and
// multiplies V read by ldmatrix.trans. Each sweep fetches a lane's bias
// and mask terms a key tile ahead (read in the softmax, their L2 latency
// stalled every tile). N % 16 == 0 and N <= 256 (K and V
// of the whole window stay in shared memory), hd <= 128. No atomics:
// reruns are bit-equal.

#include "bf16_mma.cuh"

namespace {

template <int HDP>
__global__ void __launch_bounds__(512)
window_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ bias,
                             const float* __restrict__ mask,
                             __nv_bfloat16* __restrict__ out, int H, int W,
                             int C, int hd, int ws, float scale, int heads) {
  constexpr int kLd = HDP + 8;  // bf16 a shared row (16-byte multiple)
  static_assert(HDP % 16 == 0, "head box: whole 16-dim k-steps");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int n = ws * ws;
  __nv_bfloat16* ks = qs + n * kLd;
  __nv_bfloat16* vs = ks + n * kLd;
  const int nww = W / ws, nw_img = (H / ws) * nww;
  const int head = blockIdx.x % heads;
  const int bw = blockIdx.x / heads;  // batch * window
  const int b = bw / nw_img, win = bw % nw_img;
  const int wy = win / nww, wx = win % nww;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  auto pixel = [&](int i) -> long long {
    const int y = wy * ws + i / ws, x = wx * ws + i % ws;
    return ((long long)b * H + y) * W + x;
  };
  const int ch0 = head * hd;
  const float qscale = round_bf16(scale);
  // 8 channels of a row an item: (tensor, row, chunk), the chunk's loads
  // independent of each other
  constexpr int kCh = HDP / 8;
  for (int idx = tid; idx < 3 * n * kCh; idx += blockDim.x) {
    const int which = idx / (n * kCh), r = idx / kCh % n, c = idx % kCh;
    const __nv_bfloat16* src = which == 0 ? q : which == 1 ? k : v;
    uint4 val = load8_bf16(src + pixel(r) * C + ch0 + 8 * c, hd - 8 * c);
    if (which == 0)
      val = map8_bf16(val, [qscale](float x) { return x * qscale; });
    *reinterpret_cast<uint4*>(qs + which * n * kLd + r * kLd + 8 * c) = val;
  }
  __syncthreads();

  const int r0 = 16 * warp;  // the warp's query rows r0 + g (+ 8)
  const __nv_bfloat16* qw = qs + r0 * kLd;
  const __nv_bfloat16* bb = bias + (long long)head * n * n;
  const float* mb = mask ? mask + (long long)win * n * n : nullptr;
  // The additive terms of the 16 keys from k0 for the lane's rows g and
  // g + 8: bias as bf16x2, mask as float2 (two keys each); fetched a key
  // tile ahead of their use, so their latency hides behind a tile's work.
  struct Add {
    uint32_t b[2][2];
    float2 m[2][2];
  };
  auto fetch = [&](Add& ad, int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = (r0 + g + 8 * h) * n + k0 + 8 * j + 2 * t;
        ad.b[j][h] = __ldg(reinterpret_cast<const unsigned int*>(bb + off));
        ad.m[j][h] = mb ? __ldg(reinterpret_cast<const float2*>(mb + off))
                        : make_float2(0.f, 0.f);
      }
  };
  // logits of the 16 keys from k0, in log2 units: (q k^T + bias + mask)
  // * log2 e, C fragments of two 8-key n-tiles
  auto scores = [&](float (&s)[2][4], int k0, const Add& ad) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int d16 = 0; d16 < HDP / 16; ++d16) {
      uint32_t a[4], bf[2][2];
      ldsm_a(a, qw + 16 * d16, kLd);
      ldsm_b_nk(bf, ks + k0 * kLd + 16 * d16, kLd);
      mma_bf16(s[0], a, bf[0][0], bf[0][1]);
      mma_bf16(s[1], a, bf[1][0], bf[1][1]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 bv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ad.b[j][h]));
        float x0 = s[j][2 * h] + bv.x, x1 = s[j][2 * h + 1] + bv.y;
        if (mb) {
          x0 += ad.m[j][h].x;
          x1 += ad.m[j][h].y;
        }
        s[j][2 * h] = x0 * kLog2e;
        s[j][2 * h + 1] = x1 * kLog2e;
      }
  };
  auto quad_max4 = [](float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  };

  // sweep 1: each row's max and sum of exp2(s - max)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  Add cur, nxt;
  fetch(cur, 0);
  for (int k0 = 0; k0 < n; k0 += 16) {
    if (k0 + 16 < n) fetch(nxt, k0 + 16);
    float s[2][4];
    scores(s, k0, cur);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mx = quad_max4(fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                                       fmaxf(s[1][2 * h], s[1][2 * h + 1])));
      const float mn = fmaxf(m[h], mx);  // finite: every key is
      const float ps = ex2(s[0][2 * h] - mn) + ex2(s[0][2 * h + 1] - mn) +
                       ex2(s[1][2 * h] - mn) + ex2(s[1][2 * h + 1] - mn);
      l[h] = l[h] * ex2(m[h] - mn) + ps;
      m[h] = mn;
    }
    cur = nxt;
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[h] = 1.f / lt;
  }

  // sweep 2: O += bf16(P) V
  float o[HDP / 8][4];
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  fetch(cur, 0);
  for (int k0 = 0; k0 < n; k0 += 16) {
    if (k0 + 16 < n) fetch(nxt, k0 + 16);
    float s[2][4];
    scores(s, k0, cur);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = ex2(s[j][e] - m[e / 2]);
    uint32_t a[4];
    p_frag_bf16(a, s[0], s[1], inv);
#pragma unroll
    for (int d = 0; d < HDP / 8; d += 2) {
      uint32_t bf[2][2];
      ldsm_b_kn(bf, vs + k0 * kLd + 8 * d, kLd);
      mma_bf16(o[d], a, bf[0][0], bf[0][1]);
      mma_bf16(o[d + 1], a, bf[1][0], bf[1][1]);
    }
    cur = nxt;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __nv_bfloat16* orow = out + pixel(r0 + g + 8 * h) * C + ch0;
#pragma unroll
    for (int d = 0; d < HDP / 8; ++d) {
      const int col = 8 * d + 2 * t;
      if (col < hd) orow[col] = __float2bfloat16_rn(o[d][2 * h]);
      if (col + 1 < hd) orow[col + 1] = __float2bfloat16_rn(o[d][2 * h + 1]);
    }
  }
}

template <int HDP>
cudaError_t window_attention_bf16_launch(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* bias, const float* mask, __nv_bfloat16* out, int B,
    int H, int W, int C, int heads, int ws, float scale,
    cudaStream_t stream) {
  const int n = ws * ws;
  const size_t smem = size_t(3) * n * (HDP + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_bf16_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * (H / ws) * (W / ws) * heads;
  if (blocks > 0x7fffffffLL || blocks == 0) return cudaErrorInvalidValue;
  window_attention_bf16_kernel<HDP><<<unsigned(blocks), 2 * n, smem,
                                      stream>>>(q, k, v, bias, mask, out, H,
                                                W, C, C / heads, ws, scale,
                                                heads);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: [B, H, W, C] bf16 contiguous; bias [heads, N, N] bf16,
// 4-byte aligned; mask [nW, N, N] fp32, 8-byte aligned, or null (N = ws *
// ws, a multiple of 16 up to 256; H % ws == 0 == W % ws; C / heads <= 128).
extern "C" int ff_window_attention_nhwc_bf16(const void* q, const void* k,
                                             const void* v, const void* bias,
                                             const float* mask, void* out,
                                             int B, int H, int W, int C,
                                             int num_heads, int ws,
                                             float scale, void* stream) {
  const int n = ws * ws;
  if (ws < 1 || num_heads < 1 || H % ws || W % ws || C % num_heads ||
      n % 16 || n > 256 || reinterpret_cast<size_t>(bias) % 4 ||
      reinterpret_cast<size_t>(mask) % 8)
    return int(cudaErrorInvalidValue);
  const int hdp = (C / num_heads + 15) / 16 * 16;
  using bf = __nv_bfloat16;
  const auto* qb = static_cast<const bf*>(q);
  const auto* kb = static_cast<const bf*>(k);
  const auto* vb = static_cast<const bf*>(v);
  const auto* bb = static_cast<const bf*>(bias);
  auto* ob = static_cast<bf*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FF_WINDOW_BF16(P)                                                   \
  if (hdp == P)                                                             \
    return int(window_attention_bf16_launch<P>(qb, kb, vb, bb, mask, ob, B, \
                                               H, W, C, num_heads, ws,      \
                                               scale, s));
  FF_WINDOW_BF16(16)
  FF_WINDOW_BF16(32)
  FF_WINDOW_BF16(48)
  FF_WINDOW_BF16(64)
  FF_WINDOW_BF16(80)
  FF_WINDOW_BF16(96)
  FF_WINDOW_BF16(112)
  FF_WINDOW_BF16(128)
#undef FF_WINDOW_BF16
  return int(cudaErrorInvalidValue);
}
