// GRL mixed attention over NHWC tensors: the window half and the anchored
// stripe half of every 8x8 tile, 3xTF32 on the tensor cores.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_attention.py:
// fused_grl_mixed_attention_nhwc (:548), which every GRL-B block calls
// (freqfusion_tpu/models/grl.py:426-441). The body, its bound and its
// design are in grl_attention.cuh, which grl_attention_qkv.cu shares; here
// the six halves are separate [B, H, W, C2] tensors, each tile row of
// each one bulk copy.

#include "grl_attention.cuh"

// q/k/v halves, out_w, out_s: [B, H, W, C2]; anchor [B, H/df, W/df, C2];
// scale_w [heads_w], scale_s1/scale_s2 [heads_s]; bias_w [heads_w, N, N],
// bias_s1 [heads_s, Na, N], bias_s2 [heads_s, N, Na]; mask [nW, N, N] or
// null. All fp32 contiguous, the halves and the anchor 16-byte aligned;
// ws 8 and df 2 (N 64, Na 16), H % 8 == 0 == W % 8, head dims <= 96 and
// (208 C2 + the head box) floats of shared memory a block.
extern "C" int ff_grl_mixed_attention_nhwc(
    const float* qw, const float* kw, const float* vw, const float* qs,
    const float* ks, const float* vs, const float* anchor,
    const float* scale_w, const float* scale_s1, const float* scale_s2,
    const float* bias_w, const float* bias_s1, const float* bias_s2,
    const float* mask, float* out_w, float* out_s, int B, int H, int W,
    int C2, int heads_w, int heads_s, int ws, int df, void* stream) {
  if (ws != kGrlWs || df != kGrlWs / kGrlAws) return int(cudaErrorInvalidValue);
  const GrlArgs a{{GrlHalf{qw, kw, vw, C2, 0, heads_w, scale_w, nullptr,
                           bias_w, nullptr, mask, out_w},
                   GrlHalf{qs, ks, vs, C2, 0, heads_s, scale_s1, scale_s2,
                           bias_s1, bias_s2, nullptr, out_s}},
                  anchor, H, W, C2};
  return int(grl_attention_launch(a, B, static_cast<cudaStream_t>(stream)));
}

// ---------------------------------------------------------------------------
// bf16 form: ff_grl_mixed_attention_nhwc_bf16, the same function over bf16
// halves, anchor, mask and outputs, with the rounding points of the JAX
// kernel's bf16 run (freqfusion_tpu/ops/pallas_attention.py:_grl_mixed_core,
// :385-424): q, k and the anchors normalised in fp32 and rounded to bf16;
// the logits in fp32, times the head's scale, plus the bias (fp32: GRL's
// continuous position bias runs in fp32 on the fp32 table), plus the mask
// (bf16: the JAX wrapper casts it to the operands' dtype, :612); each
// softmax in fp32, normalised, rounded to bf16 before its product; the
// anchor stage's output x1 rounded to bf16 before the second stage; both
// outputs rounded to bf16. No atomics: reruns are bit-equal.
//
// What bounds it on the H100: bytes. At GRL-B's 336x512 shape a call
// reads the six halves and the anchor once and writes two outputs, ~0.27
// GB in bf16 or ~0.08 ms at 3.35 TB/s, plus the bias tables (once) and the
// bf16 mask; its 5.95 GFLOP on the bf16 tensor cores are ~0.006 ms.
//
// Design: persistent blocks, one an SM, each walking the tiles of one half
// (the window half's blocks first, then the stripe half's), so that a
// block reads its half's bias terms once, not once a tile:
//   - warp 0 lands each tile's operands in a ring of stages by bulk copies
//     on one full mbarrier a stage, the ring's first tiles before the
//     loop and tile i + depth right after the block barrier that ends tile
//     i (the stage is then free): q, k and v as the tile's eight
//     pixel rows each (an 8-pixel row is 16 C2 contiguous bytes, 16-byte
//     aligned for any C2), the window half's mask tile (8 KB of bf16, in
//     the fragment order of ops/attention.py:grl_mask_layout, cast and laid
//     out once per mask table) and the stripe half's four anchor rows (8 C2
//     bytes each: one bulk copy each where C2 is even; at odd C2 a row may
//     start 8 bytes off a 16-byte boundary, and the warp's lanes assemble it
//     from the 16-byte words that cover it), so that a tile's copies land
//     while earlier tiles' units run;
//   - 12 warps (8 past head box 32) and no other, each of which always
//     takes the same (head, 16-row unit) and keeps that unit's bias terms
//     in registers (32 floats a thread at 64 keys): ptxas gives a block of
//     12 warps 168 registers a thread, of 8 warps 255 (beside a producer
//     warpgroup, setmaxnreg handing its registers on, the units spilled
//     from head box 32 up); a unit past the warps (more than 3 heads at
//     12) reads its terms a tile;
//   - heads are read from the staged pixel rows as they lie (row stride
//     C2), as the fp32 body reads its head box: a fragment is one 4-byte
//     load of two channels (two 2-byte loads where C2 or a head dim is
//     odd), zero past the head dim; q, k and the anchors are normalised in
//     registers from their fragments (a quad's lanes hold a row's whole
//     head between them: the sum of squares over the quad by two shuffles;
//     no pass over shared memory, no barrier);
//   - products on mma.sync m16n8k16 (bf16 operands, fp32 sums): they do not
//     bind this kernel, and its rows (180 bytes at C2 90) are no 16-byte
//     multiple, which ldmatrix and wgmma's core matrices need; V's
//     fragments (two keys of one channel) are 2-byte loads;
//   - the stripe half's stage 1 (one unit a head) writes x1 rounded to bf16
//     and transposed ([channel][anchor], rows of 24), so that stage 2 reads
//     its V fragments as 4-byte loads free of bank conflicts; one barrier
//     between the stages;
//   - each unit writes its rows of the output into a shared tile (two, in
//     turns), which leaves by 8 bulk stores, one a pixel row, after one
//     barrier a tile.
// ws 8, df 2, head dims <= 96.

#include "bf16_mma.cuh"
#include "bf16_wgmma.cuh"

namespace {

using gb16 = __nv_bfloat16;

constexpr int kGbMaxStages = 4;  // the ring's depth at most
constexpr int kGbHead = 128;     // the ring's barriers, at the head of smem
constexpr int kGbX1Ld = 24;      // x1's transposed rows: 16 anchors + 8
constexpr int kGbPad = 256;      // bytes past a stage's rows a box may read
constexpr int kGbSmemMax = 232448;

// Warps a block: 12 up to head box 32, 8 past it.
__host__ __device__ constexpr int gb_warps(int hdp) {
  return hdp <= 32 ? 12 : 8;
}

// An anchor row of 4 pixels in shared memory: 4 C2 bf16, padded to 8.
__host__ __device__ inline int gb_anchor_ld(int C2) { return bw_up(4 * C2, 8); }

struct GbPlan {
  int hdp, warps, stages, stage, smem;  // stage, smem: bytes
};

// The plan of a call (ops/attention.py:plan_grl_attention_bf16): the head
// box of the wider head, the consumer warps, the deepest ring (2 to 4
// stages) that fits; smem 0 where refused. A stage: q, k, v (64 C2 bf16
// each), then the mask tile or the anchor rows, and a pad; then two output
// tiles (64 C2 bf16) and x1 (heads_s HDP rows of 24).
inline GbPlan gb_plan(int C2, int heads_w, int heads_s, bool masked) {
  GbPlan q{0, 0, 0, 0, 0};
  if (C2 <= 0 || heads_w < 1 || heads_s < 1) return q;
  q.hdp = grl_head_box(C2 / min(heads_w, heads_s));
  if (!q.hdp) return q;
  q.warps = gb_warps(q.hdp);
  const int extra = max(masked ? kGrlN * kGrlN * 2 : 0, 4 * gb_anchor_ld(C2) * 2);
  q.stage = bw_up(3 * kGrlN * C2 * 2 + extra + kGbPad, 128);
  const int rest =
      2 * bw_up(kGrlN * C2 * 2, 128) + heads_s * q.hdp * kGbX1Ld * 2;
  for (int s = kGbMaxStages; s >= 2; --s)
    if (kGbHead + s * q.stage + rest <= kGbSmemMax) {
      q.stages = s;
      q.smem = kGbHead + s * q.stage + rest;
      break;
    }
  return q;
}

struct GbArgs {
  const gb16* x[2][3];   // (window, stripe) x (q, k, v), [B, H, W, C2]
  const gb16* anchor;    // [B, H / 2, W / 2, C2]
  const float* scale[3];  // s_w [heads_w], s1, s2 [heads_s]
  const float* bias[3];   // [heads_w, N, N], [heads_s, Na, N], [heads_s, N, Na]
  const gb16* mask;      // [tiles][4096] in grl_mask_layout's order, or null
  gb16* out[2];          // [B, H, W, C2]
  int heads[2];
  int B, H, W, C2;
  int nbw;               // the window half's blocks: the first nbw
  int stages, stage;     // the ring: its depth, a stage's bytes
};

// Channels c, c + 1 of a head (hd channels, from p), zero past hd; P: p + c
// 4-byte aligned and hd even (C2 and the head dims even).
template <bool P>
__device__ __forceinline__ uint32_t gb_pair(const gb16* p, int c, int hd) {
  if constexpr (P) {
    return c < hd ? *reinterpret_cast<const uint32_t*>(p + c) : 0u;
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p + c);
    const uint32_t lo = c < hd ? s[0] : 0u, hi = c + 1 < hd ? s[1] : 0u;
    return lo | hi << 16;
  }
}

__device__ __forceinline__ float2 gb_f2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ float gb_sq(uint32_t w) {
  const float2 f = gb_f2(w);
  return f.x * f.x + f.y * f.y;
}

// x / max(||x||, 1e-12) as the JAX kernel's _cosnorm: x times the inverse,
// in fp32, rounded to bf16.
__device__ __forceinline__ float gb_inv_norm(float ss) {
  return 1.f / fmaxf(sqrtf(ss), 1e-12f);
}

__device__ __forceinline__ uint32_t gb_scaled(uint32_t w, float f) {
  const float2 v = gb_f2(w);
  return pack_bf16(v.x * f, v.y * f);
}

// The A fragments of a 16-row unit's head (HDP / 16 k-steps), rows g and
// g + 8 at r0 and r1 (the head's channel 0), normalised: the quad's four
// lanes hold each row's channels between them.
template <int HDP, bool P>
__device__ __forceinline__ void gb_rows_a(uint32_t (&a)[HDP / 16][4],
                                          const gb16* r0, const gb16* r1,
                                          int hd) {
  const int t = threadIdx.x & 3;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 16 * kk + 8 * e + 2 * t;
      a[kk][2 * e] = gb_pair<P>(r0, c, hd);
      a[kk][2 * e + 1] = gb_pair<P>(r1, c, hd);
      s0 += gb_sq(a[kk][2 * e]);
      s1 += gb_sq(a[kk][2 * e + 1]);
    }
  const float f0 = gb_inv_norm(quad_sum(s0)), f1 = gb_inv_norm(quad_sum(s1));
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      a[kk][2 * e] = gb_scaled(a[kk][2 * e], f0);
      a[kk][2 * e + 1] = gb_scaled(a[kk][2 * e + 1], f1);
    }
}

// The B fragments of one n-tile of keys (this lane's key row at kp, the
// head's channel 0), normalised over the quad.
template <int HDP, bool P>
__device__ __forceinline__ void gb_key_b(uint32_t (&b)[HDP / 16][2],
                                         const gb16* kp, int hd) {
  const int t = threadIdx.x & 3;
  float s = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      b[kk][e] = gb_pair<P>(kp, 16 * kk + 8 * e + 2 * t, hd);
      s += gb_sq(b[kk][e]);
    }
  const float f = gb_inv_norm(quad_sum(s));
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 2; ++e) b[kk][e] = gb_scaled(b[kk][e], f);
}

// A unit's bias terms, rows g and g + 8 from `b` (the unit's first row of
// a [rows][8 NT] fp32 table), keys 8 j + 2 t and + 1.
template <int NT>
__device__ __forceinline__ void gb_terms(float2 (&tb)[NT][2], const float* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tb[j][h] = __ldg(reinterpret_cast<const float2*>(
          b + (g + 8 * h) * (8 * NT) + 8 * j + 2 * t));
}

// One unit, rows g and g + 8 of 16: o = bf16(softmax(A K^T scale + bias(j,
// h) + mask(j, h))) V over NT 8-key n-tiles, fp32 sums. a: the normalised
// A fragments; key(j): this lane's key row of n-tile j (8 j + g) at the
// head's channel 0; vb(kk, n, b0, b1): V's B fragments of keys 16 kk ..
// and channels 8 n ..; bias(j, h), mask(j, h): the float2 terms of row g +
// 8 h, keys 8 j + 2 t and + 1 (the mask's already bf16 values).
template <int NT, int HDP, bool P, class Key, class VB, class Bias,
          class Mask>
__device__ __forceinline__ void gb_unit(float (&o)[HDP / 8][4],
                                        const uint32_t (&a)[HDP / 16][4],
                                        Key key, VB vb, int hd, float scale,
                                        Bias bias, Mask mask) {
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    uint32_t b[HDP / 16][2];
    gb_key_b<HDP, P>(b, key(j), hd);
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) mma_bf16(s[j], a[kk], b[kk][0], b[kk][1]);
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 bj = bias(j, h), mj = mask(j, h);
      s[j][2 * h] = (s[j][2 * h] * scale + bj.x + mj.x) * kLog2e;
      s[j][2 * h + 1] = (s[j][2 * h + 1] * scale + bj.y + mj.y) * kLog2e;
      mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    }
    mx = quad_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][2 * h] = ex2(s[j][2 * h] - mx);
      s[j][2 * h + 1] = ex2(s[j][2 * h + 1] - mx);
      sum += s[j][2 * h] + s[j][2 * h + 1];
    }
    inv[h] = 1.f / quad_sum(sum);
  }
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t pa[4];
    p_frag_bf16(pa, s[2 * kk], s[2 * kk + 1], inv);
#pragma unroll
    for (int d = 0; d < HDP / 8; ++d) {
      uint32_t b0, b1;
      vb(kk, d, b0, b1);
      mma_bf16(o[d], pa, b0, b1);
    }
  }
}

// A unit's rows r0 + g and r0 + g + 8 of o, rounded to bf16, into the
// output tile (rows of C2) at the head's channels c0 .. c0 + hd.
template <int HDP, bool P>
__device__ __forceinline__ void gb_put(gb16* ob, const float (&o)[HDP / 8][4],
                                       int r0, int c0, int hd, int C2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    gb16* row = ob + (r0 + g + 8 * h) * C2 + c0;
#pragma unroll
    for (int d = 0; d < HDP / 8; ++d) {
      const int c = 8 * d + 2 * t;
      if constexpr (P) {
        if (c < hd)
          *reinterpret_cast<uint32_t*>(row + c) =
              pack_bf16(o[d][2 * h], o[d][2 * h + 1]);
      } else {
        if (c < hd) row[c] = __float2bfloat16_rn(o[d][2 * h]);
        if (c + 1 < hd) row[c + 1] = __float2bfloat16_rn(o[d][2 * h + 1]);
      }
    }
  }
}

// The four anchor rows of a tile (4 C2 bf16 each, the first at src, the
// next `step` elements on) into dst (rows of gb_anchor_ld(C2)) by the warp's
// lanes, where bulk copies cannot land them: at odd C2 a row starts 0 or 8
// bytes past a 16-byte boundary. Word k of a row (channels 8 k .. 8 k + 7)
// is one 16-byte load where the row is aligned, else the upper half of the
// aligned word at channel 8 k - 4 and the lower half of the one at 8 k +
// 4; no load reaches past the row.
__device__ __forceinline__ void gb_anchor_rows(unsigned char* dst,
                                               const gb16* src,
                                               long long step, int C2) {
  const int lane = threadIdx.x & 31, len = 4 * C2, ld = gb_anchor_ld(C2);
  const int words = ld / 8;
  for (int e = lane; e < 4 * words; e += 32) {
    const int y = e / words, k = e % words;
    const gb16* row = src + y * step;
    uint4 w;
    if ((reinterpret_cast<size_t>(row) & 15) == 0) {
      if (8 * k + 8 <= len) {
        w = __ldg(reinterpret_cast<const uint4*>(row + 8 * k));
      } else {  // the last word of an odd row: 4 channels
        const uint2 h = __ldg(reinterpret_cast<const uint2*>(row + 8 * k));
        w = make_uint4(h.x, h.y, 0u, 0u);
      }
    } else {
      const uint4 lo = __ldg(reinterpret_cast<const uint4*>(row + 8 * k - 4));
      const uint4 hi =
          8 * k + 4 < len
              ? __ldg(reinterpret_cast<const uint4*>(row + 8 * k + 4))
              : make_uint4(0u, 0u, 0u, 0u);
      w = make_uint4(lo.z, lo.w, hi.x, hi.y);
    }
    *reinterpret_cast<uint4*>(dst + (y * ld + 8 * k) * 2) = w;
  }
}

// What the consumer warps of a block share.
struct GbBlock {
  unsigned char* ring;
  uint64_t* full;
  unsigned char* outs;  // two output tiles
  gb16* x1t;            // x1 transposed: [heads_s][HDP][kGbX1Ld]
  long long hb, nb;     // the block's first tile and its stride
  int n, tiles_x, tiles, outb;
  bool stripe;
};

// Warp 0 (every lane): tile i's operands into stage i % depth, on its full
// barrier. At odd C2 the stripe half's anchor rows come by the lanes
// first; then lane 0 sets the bytes to wait for and the lanes issue one
// bulk copy each: q, k and v's 24 tile rows, the mask tile or the anchor
// rows.
__device__ __forceinline__ void gb_fill(const GbBlock& k, const GbArgs& p,
                                        int i) {
  const int lane = threadIdx.x & 31, C2 = p.C2, H = p.H, W = p.W;
  const long long tt = k.hb + i * k.nb;
  const long long b = tt / k.tiles;
  const int tile = int(tt % k.tiles);
  const int ty = tile / k.tiles_x, tx = tile % k.tiles_x;
  const int s = i % p.stages, nq = kGrlN * C2, ald = gb_anchor_ld(C2);
  unsigned char* st = k.ring + s * p.stage;
  const gb16* an = p.anchor + ((b * (H / 2) + ty * kGrlAws) * (W / 2) +
                               tx * kGrlAws) * C2;
  const bool lanes = k.stripe && (C2 & 1);  // anchor rows by the lanes
  const uint32_t row = 16 * C2;             // bytes of a tile row
  if (lanes) {
    gb_anchor_rows(st + 3 * nq * 2, an, (long long)(W / 2) * C2, C2);
    __threadfence_block();
  }
  __syncwarp();
  if (lane == 0)
    mbar_arrive_expect_tx(
        &k.full[s], 3 * kGrlWs * row +
                        (k.stripe ? (lanes ? 0u : uint32_t(kGrlAws) * 8 * C2)
                                  : (p.mask ? uint32_t(kGrlN * kGrlN * 2)
                                            : 0u)));
  __syncwarp();
  if (lane < 3 * kGrlWs) {
    const int w3 = lane / kGrlWs, y = lane % kGrlWs;
    bulk_copy(st + (w3 * nq + y * kGrlWs * C2) * 2,
              p.x[k.stripe][w3] +
                  ((b * H + ty * kGrlWs + y) * W + tx * kGrlWs) * C2,
              row, &k.full[s]);
  } else if (!k.stripe) {
    if (p.mask && lane == 3 * kGrlWs)
      bulk_copy(st + 3 * nq * 2, p.mask + (long long)tile * kGrlN * kGrlN,
                kGrlN * kGrlN * 2, &k.full[s]);
  } else if (!lanes && lane < 3 * kGrlWs + kGrlAws) {
    const int y = lane - 3 * kGrlWs;
    bulk_copy(st + (3 * nq + y * ald) * 2, an + (long long)y * (W / 2) * C2,
              8 * C2, &k.full[s]);
  }
}

// After a tile's units: the output tile (its buffer i & 1) out by 8 bulk
// stores, one a pixel row, then the stage refilled with tile i + depth;
// thread 0 first waits until the previous tile's stores have read the
// other buffer, which the next tile fills.
template <int kWarps>
__device__ __forceinline__ void gb_tile_done(const GbBlock& k, const GbArgs& p,
                                             int i, gb16* out) {
  const int tid = threadIdx.x;
  fence_proxy_async();  // this thread's output rows, before the bulk store
  if (tid == 0) bw_store_wait_read<0>();
  bw_sync(32 * kWarps);
  if (tid == 0) {
    const long long tt = k.hb + i * k.nb;
    const long long b = tt / k.tiles;
    const int tile = int(tt % k.tiles);
    const int ty = tile / k.tiles_x, tx = tile % k.tiles_x;
    const gb16* ob = reinterpret_cast<const gb16*>(k.outs + (i & 1) * k.outb);
#pragma unroll 1
    for (int y = 0; y < kGrlWs; ++y)
      bw_store(out + ((b * p.H + ty * kGrlWs + y) * p.W + tx * kGrlWs) *
                         p.C2,
               ob + y * kGrlWs * p.C2, 16 * p.C2);
    bw_store_commit();
  }
  if (tid < 32 && i + p.stages < k.n) gb_fill(k, p, i + p.stages);
}

// The window half's tiles: unit u (head u / 4, rows 16 (u % 4)), warp w
// keeping unit w's terms.
template <int HDP, bool P>
__device__ __forceinline__ void gb_window(const GbArgs& p, const GbBlock& k) {
  constexpr int kWarps = gb_warps(HDP);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int C2 = p.C2, heads = p.heads[0], hd = C2 / heads, units = 4 * heads;
  const int nq = kGrlN * C2;
  float2 kb[8][2];
  float ks = 0.f;
  if (warp < units) {
    gb_terms<8>(kb, p.bias[0] + ((long long)(warp / 4) * kGrlN +
                                 16 * (warp % 4)) * kGrlN);
    ks = __ldg(p.scale[0] + warp / 4);
  }
  for (int i = 0; i < k.n; ++i) {
    const int s = i % p.stages;
    mbar_wait(&k.full[s], (i / p.stages) & 1);
    const gb16* q = reinterpret_cast<const gb16*>(k.ring + s * p.stage);
    const gb16* kx = q + nq;
    const gb16* v = kx + nq;
    const uint2* mk = reinterpret_cast<const uint2*>(v + nq);
    gb16* ob = reinterpret_cast<gb16*>(k.outs + (i & 1) * k.outb);
    for (int u = warp; u < units; u += kWarps) {
      const int h = u / 4, r = u % 4, r0 = 16 * r, c0 = h * hd;
      // the mask's words of n-tiles 2 q and 2 q + 1, [r][q][hh][lane][2]:
      // held (P false) or read as the softmax takes them (P true, where
      // holding them spilled at head box 32)
      const uint2* mr = mk + r * 256 + lane;
      uint32_t mw[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) mw[j] = 0u;
      if (!P && p.mask) {
#pragma unroll
        for (int qq = 0; qq < 4; ++qq)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const uint2 m = mk[((r * 4 + qq) * 2 + hh) * 32 + lane];
            mw[(2 * qq) * 2 + hh] = m.x;
            mw[(2 * qq + 1) * 2 + hh] = m.y;
          }
      }
      uint32_t a[HDP / 16][4];
      gb_rows_a<HDP, P>(a, q + (r0 + g) * C2 + c0, q + (r0 + g + 8) * C2 + c0,
                        hd);
      auto key = [&](int j) { return kx + (8 * j + g) * C2 + c0; };
      auto vb = [&](int kk, int d, uint32_t& b0, uint32_t& b1) {
        const unsigned short* e = reinterpret_cast<const unsigned short*>(
            v + (16 * kk + 2 * t) * C2 + c0 + 8 * d + g);
        b0 = e[0] | uint32_t(e[C2]) << 16;
        b1 = e[8 * C2] | uint32_t(e[9 * C2]) << 16;
      };
      auto mask = [&](int j, int hh) {
        if constexpr (P) {
          if (!p.mask) return make_float2(0.f, 0.f);
          const uint2 m = mr[((j >> 1) * 2 + hh) * 32];
          return gb_f2((j & 1) ? m.y : m.x);
        } else {
          return gb_f2(mw[2 * j + hh]);
        }
      };
      float o[HDP / 8][4];
      if (u == warp) {
        gb_unit<8, HDP, P>(o, a, key, vb, hd, ks,
                           [&](int j, int hh) { return kb[j][hh]; }, mask);
      } else {  // a unit past the warps: its terms from L2
        const float* bt = p.bias[0] + ((long long)h * kGrlN + r0) * kGrlN;
        gb_unit<8, HDP, P>(
            o, a, key, vb, hd, __ldg(p.scale[0] + h),
            [&](int j, int hh) {
              return __ldg(reinterpret_cast<const float2*>(
                  bt + (g + 8 * hh) * kGrlN + 8 * j + 2 * t));
            },
            mask);
      }
      gb_put<HDP, P>(ob, o, r0, c0, hd, C2);
    }
    gb_tile_done<kWarps>(k, p, i, p.out[0]);
  }
}

// The stripe half's tiles: stage 1 (the anchors attend to the tile's keys,
// one unit a head, warp h keeping head h's terms), x1 into shared memory,
// one barrier, stage 2 (unit u: head u / 4, rows 16 (u % 4), warp w keeping
// unit w's terms).
template <int HDP, bool P>
__device__ __forceinline__ void gb_stripe(const GbArgs& p, const GbBlock& k) {
  constexpr int kWarps = gb_warps(HDP);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int C2 = p.C2, heads = p.heads[1], hd = C2 / heads, units = 4 * heads;
  const int nq = kGrlN * C2, ald = gb_anchor_ld(C2);
  float2 kb1[8][2], kb2[2][2];
  float ks1 = 0.f, ks2 = 0.f;
  if (warp < heads) {
    gb_terms<8>(kb1, p.bias[1] + (long long)warp * kGrlNa * kGrlN);
    ks1 = __ldg(p.scale[1] + warp);
  }
  if (warp < units) {
    gb_terms<2>(kb2, p.bias[2] + ((long long)(warp / 4) * kGrlN +
                                  16 * (warp % 4)) * kGrlNa);
    ks2 = __ldg(p.scale[2] + warp / 4);
  }
  auto none = [](int, int) { return make_float2(0.f, 0.f); };
  for (int i = 0; i < k.n; ++i) {
    const int s = i % p.stages;
    mbar_wait(&k.full[s], (i / p.stages) & 1);
    const gb16* q = reinterpret_cast<const gb16*>(k.ring + s * p.stage);
    const gb16* kx = q + nq;
    const gb16* v = kx + nq;
    const gb16* an = v + nq;
    auto arow = [&](int r) { return an + (r >> 2) * ald + (r & 3) * C2; };
    gb16* ob = reinterpret_cast<gb16*>(k.outs + (i & 1) * k.outb);
    for (int h = warp; h < heads; h += kWarps) {  // stage 1
      const int c0 = h * hd;
      uint32_t a[HDP / 16][4];
      gb_rows_a<HDP, P>(a, arow(g) + c0, arow(g + 8) + c0, hd);
      auto key = [&](int j) { return kx + (8 * j + g) * C2 + c0; };
      auto vb = [&](int kk, int d, uint32_t& b0, uint32_t& b1) {
        const unsigned short* e = reinterpret_cast<const unsigned short*>(
            v + (16 * kk + 2 * t) * C2 + c0 + 8 * d + g);
        b0 = e[0] | uint32_t(e[C2]) << 16;
        b1 = e[8 * C2] | uint32_t(e[9 * C2]) << 16;
      };
      float o[HDP / 8][4];
      if (h == warp) {
        gb_unit<8, HDP, P>(o, a, key, vb, hd, ks1,
                           [&](int j, int hh) { return kb1[j][hh]; }, none);
      } else {
        const float* bt = p.bias[1] + (long long)h * kGrlNa * kGrlN;
        gb_unit<8, HDP, P>(
            o, a, key, vb, hd, __ldg(p.scale[1] + h),
            [&](int j, int hh) {
              return __ldg(reinterpret_cast<const float2*>(
                  bt + (g + 8 * hh) * kGrlN + 8 * j + 2 * t));
            },
            none);
      }
      // x1 rounded to bf16, transposed: x1t[h][channel][anchor]
      gb16* x1 = k.x1t + h * HDP * kGbX1Ld;
#pragma unroll
      for (int d = 0; d < HDP / 8; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x1[(8 * d + 2 * t + (e & 1)) * kGbX1Ld + g + 8 * (e >> 1)] =
              __float2bfloat16_rn(o[d][e]);
    }
    bw_sync(32 * kWarps);  // x1 in
    for (int u = warp; u < units; u += kWarps) {  // stage 2
      const int h = u / 4, r0 = 16 * (u % 4), c0 = h * hd;
      uint32_t a[HDP / 16][4];
      gb_rows_a<HDP, P>(a, q + (r0 + g) * C2 + c0, q + (r0 + g + 8) * C2 + c0,
                        hd);
      auto key = [&](int j) { return arow(8 * j + g) + c0; };
      const gb16* x1 = k.x1t + h * HDP * kGbX1Ld;
      auto vb = [&](int, int d, uint32_t& b0, uint32_t& b1) {
        const gb16* e = x1 + (8 * d + g) * kGbX1Ld + 2 * t;
        b0 = *reinterpret_cast<const uint32_t*>(e);
        b1 = *reinterpret_cast<const uint32_t*>(e + 8);
      };
      float o[HDP / 8][4];
      if (u == warp) {
        gb_unit<2, HDP, P>(o, a, key, vb, hd, ks2,
                           [&](int j, int hh) { return kb2[j][hh]; }, none);
      } else {
        const float* bt = p.bias[2] + ((long long)h * kGrlN + r0) * kGrlNa;
        gb_unit<2, HDP, P>(
            o, a, key, vb, hd, __ldg(p.scale[2] + h),
            [&](int j, int hh) {
              return __ldg(reinterpret_cast<const float2*>(
                  bt + (g + 8 * hh) * kGrlNa + 8 * j + 2 * t));
            },
            none);
      }
      gb_put<HDP, P>(ob, o, r0, c0, hd, C2);
    }
    gb_tile_done<kWarps>(k, p, i, p.out[1]);
  }
}

template <int HDP, bool P>
__global__ void __launch_bounds__(32 * gb_warps(HDP), 1)
grl_bf16_kernel(const GbArgs p) {
  extern __shared__ __align__(128) unsigned char gb_smem[];
  GbBlock k;
  k.full = reinterpret_cast<uint64_t*>(gb_smem);
  k.ring = gb_smem + kGbHead;
  k.outb = bw_up(kGrlN * p.C2 * 2, 128);
  k.outs = k.ring + p.stages * p.stage;
  k.x1t = reinterpret_cast<gb16*>(k.outs + 2 * k.outb);
  const bool stripe = int(blockIdx.x) >= p.nbw;
  k.stripe = stripe;
  k.hb = stripe ? blockIdx.x - p.nbw : blockIdx.x;
  k.nb = stripe ? gridDim.x - p.nbw : p.nbw;
  k.tiles_x = p.W / kGrlWs;
  k.tiles = (p.H / kGrlWs) * k.tiles_x;
  const long long total = (long long)p.B * k.tiles;
  k.n = k.hb < total ? int((total - 1 - k.hb) / k.nb) + 1 : 0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(&k.full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid < 32)  // the ring's first tiles
    for (int i = 0; i < p.stages && i < k.n; ++i) gb_fill(k, p, i);
  if (stripe)
    gb_stripe<HDP, P>(p, k);
  else
    gb_window<HDP, P>(p, k);
  if (tid == 0) bw_store_wait<0>();
}

}  // namespace

// The plan of a bf16 call, as ops/attention.py:plan_grl_attention_bf16
// computes it: into out[0..4] the head box, the consumer warps a block,
// the ring's depth, a stage's bytes and a block's shared memory. Returns
// -1 (refused: a head dim past 96, or no two stages fit) or 0.
extern "C" int ff_grl_attention_bf16_plan(int C2, int heads_w, int heads_s,
                                          int masked, int* out) {
  const GbPlan q = gb_plan(C2, heads_w, heads_s, masked != 0);
  out[0] = q.hdp;
  out[1] = q.warps;
  out[2] = q.stages;
  out[3] = q.stage;
  out[4] = q.smem;
  return q.smem > 0 ? 0 : -1;
}

// As ff_grl_mixed_attention_nhwc, with the halves, the anchor, the mask
// and both outputs bf16 (16-byte aligned), the mask [nW, 64, 64] in
// ops/attention.py:grl_mask_layout's fragment order; the scales [heads],
// biases fp32, the biases 8-byte aligned. ws 8, df 2, H % 8 == 0 == W % 8,
// head dims <= 96.
extern "C" int ff_grl_mixed_attention_nhwc_bf16(
    const void* qw, const void* kw, const void* vw, const void* qs,
    const void* ks, const void* vs, const void* anchor, const float* scale_w,
    const float* scale_s1, const float* scale_s2, const float* bias_w,
    const float* bias_s1, const float* bias_s2, const void* mask,
    void* out_w, void* out_s, int B, int H, int W, int C2, int heads_w,
    int heads_s, int ws, int df, void* stream) {
  if (ws != kGrlWs || df != kGrlWs / kGrlAws || H % kGrlWs || W % kGrlWs ||
      B < 1 || H < kGrlWs || W < kGrlWs || heads_w < 1 || heads_s < 1 ||
      C2 % heads_w || C2 % heads_s)
    return int(cudaErrorInvalidValue);
  const void* al[] = {qw, kw, vw, qs, ks, vs, anchor, mask, out_w, out_s};
  for (const void* v : al)
    if (reinterpret_cast<size_t>(v) % 16) return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<size_t>(bias_w) | reinterpret_cast<size_t>(bias_s1) |
       reinterpret_cast<size_t>(bias_s2)) % 8)
    return int(cudaErrorInvalidValue);
  const GbPlan q = gb_plan(C2, heads_w, heads_s, mask != nullptr);
  if (q.smem <= 0) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const long long total = (long long)B * (H / kGrlWs) * (W / kGrlWs);
  // half the SMs a half, one block each, at most a block a tile
  const int nbw = int(total < max(1, sms / 2) ? total : max(1, sms / 2));
  const int nbs = int(total < max(1, sms - sms / 2) ? total
                                                     : max(1, sms - sms / 2));
  using bf = gb16;
  const GbArgs a{{{static_cast<const bf*>(qw), static_cast<const bf*>(kw),
                   static_cast<const bf*>(vw)},
                  {static_cast<const bf*>(qs), static_cast<const bf*>(ks),
                   static_cast<const bf*>(vs)}},
                 static_cast<const bf*>(anchor),
                 {scale_w, scale_s1, scale_s2},
                 {bias_w, bias_s1, bias_s2},
                 static_cast<const bf*>(mask),
                 {static_cast<bf*>(out_w), static_cast<bf*>(out_s)},
                 {heads_w, heads_s},
                 B, H, W, C2, nbw, q.stages, q.stage};
  const bool pairs =
      C2 % 2 == 0 && (C2 / heads_w) % 2 == 0 && (C2 / heads_s) % 2 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int allowed[10][64] = {};
#define FF_GRL_BF16(I, HP, PR)                                               \
  if (q.hdp == HP && pairs == PR) {                                          \
    err = bw_allow(grl_bf16_kernel<HP, PR>, q.smem, allowed[I]);             \
    if (err != cudaSuccess) return int(err);                                 \
    grl_bf16_kernel<HP, PR><<<unsigned(nbw + nbs), 32 * gb_warps(HP),        \
                              q.smem, s>>>(a);                               \
    return int(cudaGetLastError());                                          \
  }
  FF_GRL_BF16(0, 16, true)
  FF_GRL_BF16(1, 16, false)
  FF_GRL_BF16(2, 32, true)
  FF_GRL_BF16(3, 32, false)
  FF_GRL_BF16(4, 48, true)
  FF_GRL_BF16(5, 48, false)
  FF_GRL_BF16(6, 64, true)
  FF_GRL_BF16(7, 64, false)
  FF_GRL_BF16(8, 96, true)
  FF_GRL_BF16(9, 96, false)
#undef FF_GRL_BF16
  return int(cudaErrorInvalidValue);
}
