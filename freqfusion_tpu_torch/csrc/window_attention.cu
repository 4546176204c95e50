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
// bf16 form: ff_window_attention_nhwc_bf16, the same function over bf16 q,
// k, v, bias, mask and out, with the rounding points of the JAX kernel's
// bf16 run (freqfusion_tpu/ops/pallas_attention.py:_attn_heads, :165-192;
// its wrapper casts the mask to the operands' dtype, :279): q times scale
// rounded to bf16 (both bf16); the logits q k^T in fp32, plus the bias and
// the mask (bf16 values, added in fp32); the softmax in fp32, normalised,
// then rounded to bf16 before P V; P V accumulated in fp32 and rounded to
// bf16 on the store. The bf16 qkv window attention (window_attention_qkv.cu,
// #11) runs it for its attention stage.
//
// What bounds it on the H100: at DRCT-L's ten shapes (336x512) the bytes,
// q, k, v, out, the bias table and the mask once each in bf16, ~1.1 ms at
// 3.35 TB/s; the products, 4 N^2 hd a (window, head), ~0.44 ms at 989
// TFLOP/s; the softmax's N^2 exponentials a (window, head), ~0.46 ms on
// the SFU, its other fp32 work (~6 operations a logit) ~0.35 ms on the
// lanes, beside them.
//
// Design (wgmma; bf16_wgmma.cuh). One block a (window, head), one
// warpgroup (two where the head box passes 64 and the staged window holds
// an SM alone; otherwise two blocks share an SM, three up to head box 32,
// 1.15-1.2x faster at C 180 than two: csrc/bench/attention_variants.py),
// so that one block stages while another computes.
//   Staging: the head's slice of the window's q (scaled and rounded), k and
// v, once, in wgmma's core-matrix order, a pixel row a thread. A slice
// starts at a 2- or 4-byte offset at every DRCT-L width (hd 30, 53, 122,
// 46, 77), so the row is read as the aligned 16-byte words of device
// memory that cover it and shifted into place in registers (wa_stage),
// zeros past hd (the box HDP, hd rounded up to 16, adds nothing to
// Q K^T); the rows' pixel offsets come from a table the block fills once.
// K and V are staged with their keys permuted within each 32-key block
// (wa_perm), so that a thread's logits of four n-tiles take their bias
// and mask terms from one 16-byte load.
//   Each warpgroup then takes 64-query tiles and keeps a tile's logits
// over the whole key range (N <= 256) in its accumulators: the bias and
// mask terms are loaded straight into them (each term read once), and two
// m64n128k16 products a 16 of the head dim add Q K^T onto them (A and B
// by descriptor, K-major). Each row's max and sum come from those logits;
// P = exp2(s - max) / sum is formed once and rounded to bf16 in registers,
// where the sums of two 8-key n-tiles are exactly the A fragment of one
// k16 step; O = P V runs on wgmma with A from registers and V read by
// descriptor as staged (MN-major, the transpose bit). Q K^T, each
// exponential and each additive term are done once (the mma.sync kernel
// before it took the keys twice, since P is normalised before it is
// rounded). O leaves through a shared tile, 4-byte stores along each
// pixel's slice, 2-byte ones only at its edges. N % 16 == 0 and N <= 256,
// hd <= 128. No atomics: reruns are bit-equal.

#include "bf16_wgmma.cuh"

namespace {

constexpr int kWaRows = 64;  // query rows a warpgroup tile

// A call's plan (ops/attention.py:plan_window_attention_bf16 computes the
// same): the head box, keys padded to one or two 128-key halves, queries to
// whole tiles, warpgroups a block and the shared memory a block takes.
struct WaBf16Plan {
  int hdp, nk, nq, wg, smem;
};

inline WaBf16Plan wa_bf16_plan(int n, int hd) {
  WaBf16Plan p;
  p.hdp = (hd + 15) / 16 * 16;
  p.nk = n <= 128 ? 128 : 256;
  p.nq = (n + kWaRows - 1) / kWaRows * kWaRows;
  p.wg = p.hdp > 64 ? 2 : 1;
  p.smem = 2 * p.hdp * (p.nq + 2 * p.nk) + p.wg * kWaRows * (p.hdp + 8) * 2 +
           4 * n;  // q, k, v; the output tiles; the rows' pixel offsets
  return p;
}

__device__ __forceinline__ float wa_quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float wa_quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void wa_sync_wg(int wg) {  // one warpgroup
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

template <int N>
__device__ __forceinline__ void wa_fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// s (+)= Q K^T for one 64-query tile and one 128-key half: a k16 step of
// the head box a product (Q, K staged K-major: bw_a_off's order, q's rows
// nq apart in a 16 of channels, k's nk).
template <int HDP>
__device__ __forceinline__ void wa_qk(float (&s)[64], const unsigned char* qa,
                                      const unsigned char* kb, int nq,
                                      int nk) {
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks)
    bw_mma_n128(s, bw_desc(qa + ks * nq * 32), bw_desc(kb + ks * nk * 32), 1);
}

// o = P V over the n keys: a k16 step a product, P from registers, V
// MN-major (core matrix (channel group c, key group k) at c nk 16 + k 128);
// the steps of a 32-key block with no key below n left out.
template <int HDP>
__device__ __forceinline__ void wa_pv(float (&o)[HDP / 2],
                                      const uint32_t (&p)[16][4],
                                      const unsigned char* vs, int n,
                                      int nk) {
#pragma unroll
  for (int ks = 0; ks < 16; ++ks)
    if (32 * (ks / 2) < n)
      bw_mma_rs<HDP>(o, p[ks], bw_desc_at(vs + 256 * ks, 128, nk * 16),
                        ks > 0);
}

// The keys' order in K and V as staged: within each 32-key block, key 8 a
// + 2 b + e sits at row 8 b + 2 a + e (a, b < 4, e < 2). A thread's logits
// then hold, for each 32-key block, keys 8 t + 0..7 of its two rows (t =
// lane % 4): the bias and mask terms of four n-tiles are one 16-byte load.
__device__ __forceinline__ int wa_perm(int r) {
  return (r & ~31) | ((r & 6) << 2) | ((r >> 2) & 6) | (r & 1);
}

// Stage `rows` rows of one tensor's head slice, a row a thread: staged row
// r holds token kPerm ? wa_perm(r) : r (zeros for tokens past n), whose
// pixel is rowoff[token] elements past src; the aligned 16-byte words that
// cover its hd channels (at most HDP / 8 + 1) are loaded, then shifted
// into place a word at a time (the slice starts at byte sh of the first),
// zeros past hd, and its HDP / 8 pieces of 8 channels go to dst(r, c)
// through map. (Consecutive threads write consecutive staged rows, so a
// warp's 16-byte stores meet no bank twice.)
template <int HDP, int kThreads, bool kPerm, class Dst, class Map>
__device__ __forceinline__ void wa_stage(const __nv_bfloat16* src,
                                         const int* rowoff, int rows, int n,
                                         int hd, int tid, Dst dst, Map map) {
  constexpr int kq = HDP / 8, kW = kq + 1;
  constexpr int kRows = kW <= 5 ? 3 : kW <= 9 ? 2 : 1;  // rows in flight
  for (int r0 = tid; r0 < rows; r0 += kThreads * kRows) {
    uint32_t w[kRows][4 * kW];
    int sh[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + kThreads * i;
      const int token = kPerm ? wa_perm(r) : r;
      const bool live = r < rows && token < n;
      const size_t at =
          reinterpret_cast<size_t>(src + (live ? rowoff[token] : 0));
      sh[i] = int(at & 15);
      const int words = live ? (sh[i] + 2 * hd + 15) >> 4 : 0;
      const uint4* base = reinterpret_cast<const uint4*>(at & ~size_t(15));
#pragma unroll
      for (int u = 0; u < kW; ++u) {
        const uint4 x = u < words ? __ldg(base + u) : make_uint4(0, 0, 0, 0);
        w[i][4 * u] = x.x, w[i][4 * u + 1] = x.y;
        w[i][4 * u + 2] = x.z, w[i][4 * u + 3] = x.w;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + kThreads * i;
      if (r >= rows) continue;
      const int q = sh[i] >> 2;
      const uint32_t bits = (sh[i] & 2) * 8;
#pragma unroll
      for (int c = 0; c < kq; ++c) {
        uint32_t o[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int at = 4 * c + m;  // output word: bf16 2 at .. 2 at + 1
          const uint32_t lo = q == 0 ? w[i][at] : q == 1 ? w[i][at + 1]
                              : q == 2 ? w[i][at + 2] : w[i][at + 3];
          const uint32_t hi = q == 0 ? w[i][at + 1] : q == 1 ? w[i][at + 2]
                              : q == 2 ? w[i][at + 3] : w[i][at + 4];
          const uint32_t v = __funnelshift_r(lo, hi, bits);
          o[m] = 2 * at >= hd ? 0u : 2 * at + 1 >= hd ? v & 0xffffu : v;
        }
        *reinterpret_cast<uint4*>(dst(r, c)) =
            map(make_uint4(o[0], o[1], o[2], o[3]));
      }
    }
  }
}

template <int HDP, int WG>
__global__ void __launch_bounds__(128 * WG, WG == 1 ? (HDP <= 32 ? 3 : 2) : 1)
window_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ bias,
                              const __nv_bfloat16* __restrict__ mask,
                              __nv_bfloat16* __restrict__ out, int H, int W,
                              int C, int hd, int ws, float scale, int heads,
                              int nq, int nk) {
  constexpr int kThreads = 128 * WG, kOs = HDP + 8;
  extern __shared__ __align__(128) unsigned char wa_smem[];
  unsigned char* qs = wa_smem;
  unsigned char* ks = qs + nq * HDP * 2;
  unsigned char* vs = ks + nk * HDP * 2;
  __nv_bfloat16* otile = reinterpret_cast<__nv_bfloat16*>(vs + nk * HDP * 2);
  int* rowoff = reinterpret_cast<int*>(otile + WG * kWaRows * kOs);
  const int n = ws * ws;
  const int nww = W / ws, nw_img = (H / ws) * nww;
  const int head = blockIdx.x % heads;
  const int bw = blockIdx.x / heads;  // batch * window
  const int b = bw / nw_img, win = bw % nw_img;
  const int wy = win / nww, wx = win % nww;
  const int tid = threadIdx.x;
  const int ch0 = head * hd;
  // the window's first pixel, channel ch0; each row's pixel from it
  const long long origin = (((long long)b * H + wy * ws) * W + wx * ws) * C +
                           ch0;
  const float qscale = round_bf16(scale);
  BW_SPAN(30);
  BW_MARK(0);
  for (int r = tid; r < n; r += kThreads)
    rowoff[r] = (r / ws * W + r % ws) * C;
  const int wg = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles = nq / kWaRows, halves = nk / 128;
  const __nv_bfloat16* bb = bias + (long long)head * n * n;
  const __nv_bfloat16* mb = mask ? mask + (long long)win * n * n : nullptr;
  // The additive terms of this thread's logits in tile t: for each 32-key
  // block bl of half hh, keys 128 hh + 32 bl + 8 t4 + 0..7 of rows r0 and
  // r0 + 8 (16 bytes of bias and of mask each), the four n-tiles 4 bl ..
  // 4 bl + 3; zeros past the n keys and rows. (Issued a phase ahead, during
  // the previous tile's output stores, they made a call 1.1x slower at C
  // 244 and 2.4x at C 180, where their registers cost the third block an
  // SM: csrc/bench/attention_variants.py.)
  uint4 ab[2][2][4], am[2][2][4];
  auto load_terms = [&](int t) {
    const int r0 = kWaRows * t + 16 * warp + g;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const long long off =
            (long long)(r < n ? r : 0) * n + 128 * hh + 8 * t4;
#pragma unroll
        for (int bl = 0; bl < 4; ++bl) {
          const bool ok = r < n && 128 * hh + 32 * bl + 8 * t4 < n;
          ab[hh][h][bl] = ok ? __ldg(reinterpret_cast<const uint4*>(
                                   bb + off + 32 * bl))
                             : make_uint4(0, 0, 0, 0);
          am[hh][h][bl] = ok && mb ? __ldg(reinterpret_cast<const uint4*>(
                                         mb + off + 32 * bl))
                                   : make_uint4(0, 0, 0, 0);
        }
      }
  };
  __syncthreads();  // the rows' pixel offsets

  wa_stage<HDP, kThreads, false>(
      q + origin, rowoff, nq, n, hd, tid,
      [&](int r, int c) { return qs + bw_a_off(r, c, nq); },
      [qscale](uint4 x) {
        return map8_bf16(x, [qscale](float f) { return f * qscale; });
      });
  BW_MARK(26);
  wa_stage<HDP, kThreads, true>(
      k + origin, rowoff, nk, n, hd, tid,
      [&](int r, int c) { return ks + bw_a_off(r, c, nk); },
      [](uint4 x) { return x; });
  BW_MARK(27);
  wa_stage<HDP, kThreads, true>(
      v + origin, rowoff, nk, n, hd, tid,
      [&](int r, int c) {
        return vs + c * nk * 16 + (r >> 3) * 128 + (r & 7) * 16;
      },
      [](uint4 x) { return x; });
  BW_MARK(28);
  fence_proxy_async();  // the staged operands, before wgmma reads them
  __syncthreads();
  BW_MARK(1);
  // the block's query tiles, WG at a time
  __nv_bfloat16* ot = otile + wg * kWaRows * kOs;
  const int par = ch0 & 1;  // the slice's first channel is odd: shifted by one
  const bool even = C % 2 == 0;
  const int words = (hd + par + 1) / 2;  // 4-byte words an output row spans
  const float inv_words = 1.f / words;
  for (int t = wg; t < tiles; t += WG) {
    float s[2][64];
    // the terms into the accumulators, -inf past the n keys; S = Q K^T
    // onto them, a 128-key half at a time
    load_terms(t);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int bl = 0; bl < 4; ++bl) {
          const uint4 bq = ab[hh][h][bl], mq = am[hh][h][bl];
          const uint32_t bw4[4] = {bq.x, bq.y, bq.z, bq.w};
          const uint32_t mw4[4] = {mq.x, mq.y, mq.z, mq.w};
          const bool key_ok = 128 * hh + 32 * bl + 8 * t4 < n;
#pragma unroll
          for (int u = 0; u < 4; ++u) {  // n-tile 4 bl + u
            const float2 bv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&bw4[u]));
            const float2 mv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&mw4[u]));
            const int j = 4 * bl + u;
            s[hh][4 * j + 2 * h] = key_ok ? bv.x + mv.x : -INFINITY;
            s[hh][4 * j + 2 * h + 1] = key_ok ? bv.y + mv.y : -INFINITY;
          }
        }
      if (hh < halves) {
        bw_fence();
        wa_qk<HDP>(s[hh], qs + t * 2048, ks + hh * 4096, nq, nk);
        bw_commit();
      }
    }
    BW_MARK(2 + 5 * (t / WG));
    bw_wait<0>();
    bw_fence_acc(s[0]);
    bw_fence_acc(s[1]);
    BW_MARK(3 + 5 * (t / WG));

    // each row's max and sum (rows r0 + 8 h: pairs 4 j + 2 h, + 1), P
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mx[h] = fmaxf(mx[h], fmaxf(s[hh][4 * j + 2 * h],
                                     s[hh][4 * j + 2 * h + 1]));
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[h] = wa_quad_max(mx[h]) * kLog2e;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int h = (i >> 1) & 1;
        const float x = s[hh][i];
        const float e = ex2(fmaf(x, kLog2e, -mx[h]));
        s[hh][i] = e;
        sum[h] += e;
      }
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) inv[h] = 1.f / wa_quad_sum(sum[h]);
    uint32_t p[16][4];
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const int hh = kk >> 3, i = 8 * (kk & 7);  // n-tiles 2 kk, 2 kk + 1
      p[kk][0] = pack_bf16(s[hh][i] * inv[0], s[hh][i + 1] * inv[0]);
      p[kk][1] = pack_bf16(s[hh][i + 2] * inv[1], s[hh][i + 3] * inv[1]);
      p[kk][2] = pack_bf16(s[hh][i + 4] * inv[0], s[hh][i + 5] * inv[0]);
      p[kk][3] = pack_bf16(s[hh][i + 6] * inv[1], s[hh][i + 7] * inv[1]);
    }
    BW_MARK(4 + 5 * (t / WG));
    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    bw_fence();
    wa_pv<HDP>(o, p, vs, n, nk);
    bw_commit();
    bw_wait<0>();
    bw_fence_acc(o);
    wa_fence_regs(p);
    BW_MARK(5 + 5 * (t / WG));

    // O through the warpgroup's tile (channel c at column c + par), then
    // along each pixel's slice
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + g + 8 * h, col = 8 * j + 2 * t4 + par;
        __nv_bfloat16* d = ot + row * kOs + col;
        const float o0 = o[4 * j + 2 * h], o1 = o[4 * j + 2 * h + 1];
        if (par) {
          d[0] = __float2bfloat16_rn(o0);
          d[1] = __float2bfloat16_rn(o1);
        } else {
          *reinterpret_cast<uint32_t*>(d) = pack_bf16(o0, o1);
        }
      }
    wa_sync_wg(wg);
    for (int e = wt; e < kWaRows * words; e += 128) {
      // row = e / words: exact in fp32 at these sizes (e < 64 * 65)
      const int row = int((float(e) + 0.5f) * inv_words);
      const int wd = e - row * words, qr = kWaRows * t + row;
      if (qr >= n) continue;
      __nv_bfloat16* dst = out + origin + rowoff[qr] - par + 2 * wd;
      const uint32_t val =
          *reinterpret_cast<const uint32_t*>(ot + row * kOs + 2 * wd);
      const int c0 = 2 * wd - par;  // the slice's channel of the low half
      if (even && c0 >= 0 && c0 + 1 < hd) {
        *reinterpret_cast<uint32_t*>(dst) = val;
      } else {  // the slice's edges
        const __nv_bfloat162 pr =
            *reinterpret_cast<const __nv_bfloat162*>(&val);
        if (c0 >= 0 && c0 < hd) dst[0] = pr.x;
        if (c0 + 1 >= 0 && c0 + 1 < hd) dst[1] = pr.y;
      }
    }
    wa_sync_wg(wg);  // the tile read before the next tile's fill
    BW_MARK(6 + 5 * (t / WG));
  }
  BW_SPAN(31);
}

template <int HDP>
cudaError_t window_attention_wgmma_launch(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* bias, const __nv_bfloat16* mask, __nv_bfloat16* out,
    int B, int H, int W, int C, int heads, int ws, float scale,
    const WaBf16Plan& p, cudaStream_t stream) {
  static int allowed[64] = {};
  constexpr int WG = HDP > 64 ? 2 : 1;
  if (p.wg != WG) return cudaErrorInvalidValue;
  cudaError_t err =
      bw_allow(window_attention_wgmma_kernel<HDP, WG>, p.smem, allowed);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * (H / ws) * (W / ws) * heads;
  if (blocks > 0x7fffffffLL || blocks == 0) return cudaErrorInvalidValue;
  window_attention_wgmma_kernel<HDP, WG>
      <<<unsigned(blocks), 128 * WG, p.smem, stream>>>(
          q, k, v, bias, mask, out, H, W, C, C / heads, ws, scale, heads,
          p.nq, p.nk);
  return cudaGetLastError();
}

}  // namespace

#ifdef BW_PROFILE
// The timing marks (BW_MARK, BW_SPAN) of the last call, then cleared:
// csrc/bench/attention_variants.py reads them.
extern "C" int ff_bw_prof_wa(void* dst) {
  void* at = nullptr;
  cudaError_t err = cudaMemcpyFromSymbol(dst, bw_prof, sizeof(bw_prof));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&at, bw_prof);
  if (err == cudaSuccess) err = cudaMemset(at, 0, sizeof(bw_prof));
  return int(err);
}
#endif

// Blocks of the bf16 kernel the card keeps on an SM at once for N = ws *
// ws tokens and head dim hd (the runtime's occupancy), -1 where refused.
extern "C" int ff_window_attention_bf16_occupancy(int n, int hd) {
  if (n < 16 || n % 16 || n > 256 || hd < 1 || hd > 128) return -1;
  const WaBf16Plan p = wa_bf16_plan(n, hd);
  int blocks = -1;
  auto occupancy = [&](auto kernel, int threads) {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, p.smem) !=
            cudaSuccess)
      blocks = -1;
  };
#define FF_WINDOW_OCC(P)                                                    \
  if (p.hdp == P)                                                           \
    occupancy(window_attention_wgmma_kernel<P, (P > 64 ? 2 : 1)>,           \
              P > 64 ? 256 : 128);
  FF_WINDOW_OCC(16)
  FF_WINDOW_OCC(32)
  FF_WINDOW_OCC(48)
  FF_WINDOW_OCC(64)
  FF_WINDOW_OCC(80)
  FF_WINDOW_OCC(96)
  FF_WINDOW_OCC(112)
  FF_WINDOW_OCC(128)
#undef FF_WINDOW_OCC
  return blocks;
}

// Shared memory a block of the bf16 kernel takes for N = ws * ws tokens
// and head dim hd (ops/attention.py:plan_window_attention_bf16), -1 where
// it refuses them.
extern "C" int ff_window_attention_bf16_smem(int n, int hd) {
  if (n < 16 || n % 16 || n > 256 || hd < 1 || hd > 128) return -1;
  return wa_bf16_plan(n, hd).smem;
}

// q, k, v, out: [B, H, W, C] bf16 contiguous (out 4-byte aligned); bias
// [heads, N, N] and mask [nW, N, N] (or null) bf16, 16-byte aligned (N = ws * ws, a multiple of 16
// up to 256; H % ws == 0 == W % ws; C / heads <= 128).
extern "C" int ff_window_attention_nhwc_bf16(const void* q, const void* k,
                                             const void* v, const void* bias,
                                             const void* mask, void* out,
                                             int B, int H, int W, int C,
                                             int num_heads, int ws,
                                             float scale, void* stream) {
  const int n = ws * ws;
  if (ws < 1 || num_heads < 1 || H % ws || W % ws || C % num_heads ||
      n % 16 || n > 256 || C / num_heads > 128 ||
      reinterpret_cast<size_t>(bias) % 16 ||
      reinterpret_cast<size_t>(mask) % 16 || reinterpret_cast<size_t>(out) % 4)
    return int(cudaErrorInvalidValue);
  const WaBf16Plan p = wa_bf16_plan(n, C / num_heads);
  using bf = __nv_bfloat16;
  const auto* qb = static_cast<const bf*>(q);
  const auto* kb = static_cast<const bf*>(k);
  const auto* vb = static_cast<const bf*>(v);
  const auto* bb = static_cast<const bf*>(bias);
  const auto* mb = static_cast<const bf*>(mask);
  auto* ob = static_cast<bf*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FF_WINDOW_BF16(P)                                                   \
  if (p.hdp == P)                                                           \
    return int(window_attention_wgmma_launch<P>(qb, kb, vb, bb, mb, ob, B,  \
                                                H, W, C, num_heads, ws,     \
                                                scale, p, s));
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
