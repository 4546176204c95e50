// GRL mixed attention, 3xTF32 on the tensor cores: the body that
// grl_attention.cu (q, k, v as six NHWC tensors, TPU kernel #2) and
// grl_attention_qkv.cu (q|k|v as the two halves of a projected scratch,
// #12's attention stage) share. Per 8x8 tile and head:
//   window half   softmax(nrm(q) nrm(k)^T * s_w[h] + bias_w[h] + mask[t]) v
//   stripe half   x1  = softmax(nrm(a) nrm(k)^T * s1[h] + bias_s1[h]) v
//                 out = softmax(nrm(q) nrm(a)^T * s2[h] + bias_s2[h]) x1
// where nrm is the per-head L2 normalisation of torch's F.normalize
// (x / max(||x||, 1e-12)) and a is the tile's 4x4 anchors.
//
// What bounds it on the H100: bytes. At GRL-B's 336x512 shape (C/2 90, 3 +
// 3 heads of 30) a call reads the six halves and the anchor once and
// writes two outputs, ~0.5 GB or 0.16 ms at 3.35 TB/s; its 5.95 GFLOP as
// three TF32 products each are 0.036 ms at 495 TFLOP/s.
//
// Design (mma.sync m16n8k8 TF32, bulk copies; tf32_mma.cuh's helpers):
//   - A block is one (tile, half): 6 warps, each a (head, 32 query rows)
//     unit (16 rows at head boxes over 64), looping where a half has more
//     units. Half is the fastest block index, so a tile's two halves run
//     side by side. A block's operands (a half's q, k, v tiles and, for
//     the stripe, the anchor tile: 75 KB at C/2 90) and 168 registers a
//     thread leave room for two blocks an SM, so one block's copies
//     overlap the other's products.
//   - One thread copies the block's operands as bulk copies on one
//     mbarrier: a tile row of 8 pixels is 32 C/2 contiguous bytes at a
//     16-byte aligned address (rows of 360 bytes are only 8-byte aligned
//     one by one), so the window half is 24 copies (8 where q|k|v are the
//     column thirds of one projected row, as #12 hands them) and the
//     anchor 4 more. Shared memory keeps the pixel rows as they are.
//   - Both products of each stage run in 3xTF32 (x = hi + lo, hi the TF32
//     rounding, lo*hi + hi*lo + hi*hi in fp32). A head's hd channels are
//     read as a box of HDP (a multiple of 16) from its first channel; the
//     box's channels past hd (the next head's, or zeros past the tile) are
//     zeroed in the A operand as it is read, so they add nothing to Q K^T,
//     and are never stored from O.
//   - The cosine normalisation is one pass over shared memory once the
//     copies land: every (row, head) of q and k (and the anchors) is
//     scaled in place by 1 / max(|x|, 1e-12), q's also by its head's
//     scale * log2 e (stage 1 scales the anchors by s1 as it reads them),
//     so each product gives logits in log2 units and K's norms are taken
//     once a block, not once a warp.
//   - S and the softmax stay in registers. The stripe's stages have 64
//     keys for 16 anchor rows and 16 keys, so a plain softmax over the
//     whole row (exp2) does; the window half takes its 64 keys in two
//     halves, the softmax carried across them, since S of all 64 beside O
//     spills at 168 registers. S's accumulators start as (bias + mask) *
//     log2 e and the product adds onto them. P goes into P V from S's
//     accumulators in a permuted key order (window_attention.cuh's): a
//     k-step's t and t + 4 are keys 2t and 2t + 1, and V's fragment is
//     read from those rows.
//   - The stripe's x1 (16 anchors x HDP) never leaves registers: both row
//     units of a head compute stage 1 (two thirds of a unit's products),
//     and stage 2 takes x1's B fragments from the lanes that hold them by
//     shuffles, so no warp waits on another.
//   - The bias tables (48 KB window, 24 KB stripe at GRL-B) and the mask
//     rows are read from L2 into S's registers as float2s, each once a
//     block: a warp's first terms while the block's copies land, the
//     window's second key half's while the first half's products run.
//     Outputs are stored straight from the O fragments.
// What holds it now is the units' instruction stream at 12 warps an SM,
// not the copies: on GRL-B's two shapes this body takes ~0.70-0.75 ms,
// the copies alone (returning after the wait) ~0.37 and the units alone
// (no copies) ~0.63. Tried on the H100 and not kept: three blocks an SM
// (96 registers: spills, 0.81-1.05 ms); the window's 64 keys in one
// softmax (spills, 0.76 ms with the norms taken from the product's
// fragments instead of a pass); the two halves as two launches, which
// halves each one's code (0.76-0.82 ms).
// No atomics: reruns are bit-equal.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kGrlWarps = 6;
constexpr int kGrlThreads = 32 * kGrlWarps;
constexpr int kGrlWs = 8;    // tile side
constexpr int kGrlN = 64;    // tokens a tile
constexpr int kGrlAws = 4;   // anchor tile side (down factor 2)
constexpr int kGrlNa = 16;   // anchors a tile

// The head box HDP a head of hd channels is read in: 16, 32, 48, 64 or 96
// (0 past 96), as ops/attention.py:plan_grl_attention picks it.
__host__ __device__ inline int grl_head_box(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 48 ? 48 : hd <= 64 ? 64
       : hd <= 96 ? 96 : 0;
}

// Floats of a block's shared memory: q, k, v tiles (192 C2), the anchor
// tile (16 C2) and a pad of HDP zeros that the last rows' boxes reach.
__host__ __device__ inline int grl_smem_floats(int C2, int hdp) {
  return (3 * kGrlN + kGrlNa) * C2 + hdp;
}

// m-tiles a warp unit holds (two up to head box 64, one past it, for the
// registers), and blocks an SM the registers are held to.
template <int HDP>
struct GrlShape {
  static constexpr int kMt = HDP > 64 ? 1 : 2;
  static constexpr int kRows = 16 * kMt;
  static constexpr int kUnits = kGrlN / kRows;  // row units a head
  static constexpr int kDt = HDP / 8;           // k-steps, dim n-tiles
};

// One half's operands. q, k, v: pixel rows of ldi floats, a head's
// channels at head * hd; `packed`: they are the column thirds of one row
// (k = q + C2, v = q + 2 C2, ldi = 3 C2), copied as one. The window half
// reads scale, bias ([heads, N, N]) and mask ([tiles, N, N] or null); the
// stripe half scale/bias (s1, [heads, Na, N]) and scale2/bias2 (s2,
// [heads, N, Na]).
struct GrlHalf {
  const float* q;
  const float* k;
  const float* v;
  int ldi, packed, heads;
  const float* scale;
  const float* scale2;
  const float* bias;
  const float* bias2;
  const float* mask;
  float* out;  // [B, H, W, C2]
};

struct GrlArgs {
  GrlHalf half[2];        // window, stripe
  const float* anchor;    // [B, H / 2, W / 2, C2]
  int H, W, C2;
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Adds A B^T over the box to acc[n][mt] (which the caller set to the
// logits' additive terms): A's rows 16 mt + g (+ 8) ([rows][lda]), times
// a_scale where kScaleA; B's rows 8 n + g ([rows][ldb]); both from
// column 0 of the head, both already normalised, A's columns >= hd read as
// zeros.
template <int MT, int NT, int HDP, bool kScaleA>
__device__ __forceinline__ void grl_qk(float (&acc)[NT][MT][4],
                                       const float* A, int lda,
                                       const float* Bm, int ldb, int hd,
                                       float a_scale) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int d8 = 0; d8 < HDP / 8; ++d8) {
    const int c0 = 8 * d8 + t, c1 = c0 + 4;
    const bool ok0 = c0 < hd, ok1 = c1 < hd;
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* r = A + (16 * mt + g) * lda;
      float a[4] = {ok0 ? r[c0] : 0.f, ok0 ? r[8 * lda + c0] : 0.f,
                    ok1 ? r[c1] : 0.f, ok1 ? r[8 * lda + c1] : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kScaleA) a[e] *= a_scale;
        split_tf32(a[e], ah[mt][e], al[mt][e]);
      }
    }
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += 2) {
      constexpr int P = NT < 2 ? NT : 2;
      float b[P][2];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* r = Bm + (8 * (n0 + p) + g) * ldb;
        b[p][0] = r[c0];
        b[p][1] = r[c1];
      }
      mma_3xtf32(*reinterpret_cast<float(*)[P][MT][4]>(&acc[n0]), ah, al, b);
    }
  }
}

// The logits' additive terms in log2 units, (bias + mask) * log2 e, into
// S's fragments: row 16 mt + g + 8 h of the lane at bias + row * ld (and
// mask), its columns 8 n + 2t (+1).
template <int MT, int NT>
__device__ __forceinline__ void grl_add(float (&s)[NT][MT][4],
                                        const float* __restrict__ bias,
                                        const float* __restrict__ mask,
                                        int ld) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = (16 * mt + g + 8 * h) * ld + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float2 add = __ldg(reinterpret_cast<const float2*>(bias + off + 8 * n));
        if (mask) {
          const float2 m =
              __ldg(reinterpret_cast<const float2*>(mask + off + 8 * n));
          add.x += m.x;
          add.y += m.y;
        }
        s[n][mt][2 * h] = add.x * kLog2e;
        s[n][mt][2 * h + 1] = add.y * kLog2e;
      }
    }
}

// S's rows (logits in log2 units) into unnormalised probabilities
// exp2(s - max); returns each row's 1 / sum in inv[mt][h].
template <int MT, int NT>
__device__ __forceinline__ void grl_softmax(float (&s)[NT][MT][4],
                                            float (&inv)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][mt][2 * h], s[n][mt][2 * h + 1]));
      mx = quad_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float& s0 = s[n][mt][2 * h];
        float& s1 = s[n][mt][2 * h + 1];
        s0 = ex2(s0 - mx);
        s1 = ex2(s1 - mx);
        sum += s0 + s1;
      }
      inv[mt][h] = 1.f / quad_sum(sum);
    }
}

// Normalises the rows of each head in shared memory, in place, over its hd
// channels (torch's F.normalize: x / max(||x||, 1e-12)): the tile's 64 q
// rows, times scale[head] * log2 e as well, its 64 k rows and, where
// `anchors`, the 16 anchor rows (rows of `lds` floats; the anchors' of C2).
__device__ __forceinline__ void grl_normalise(float* qs, float* ks, float* as,
                                              int lds, int C2, int heads,
                                              int hd,
                                              const float* __restrict__ scale,
                                              bool anchors) {
  const int per = 2 * kGrlN + (anchors ? kGrlNa : 0);  // rows a head
  for (int i = threadIdx.x; i < heads * per; i += kGrlThreads) {
    const int head = i / per, r = i % per;
    float* row = r < kGrlN ? qs + r * lds
               : r < 2 * kGrlN ? ks + (r - kGrlN) * lds
                               : as + (r - 2 * kGrlN) * C2;
    row += head * hd;
    float ss = 0.f;
    for (int d = 0; d < hd; ++d) ss = fmaf(row[d], row[d], ss);
    float f = 1.f / fmaxf(sqrtf(ss), 1e-12f);
    if (r < kGrlN) f *= __ldg(scale + head) * kLog2e;
    for (int d = 0; d < hd; ++d) row[d] *= f;
  }
}

// The P operand of key step j: S's accumulators of n-tile j in the
// permuted key order (k t <-> key 8j + 2t, t + 4 <-> 8j + 2t + 1), split.
template <int MT, int NT>
__device__ __forceinline__ void grl_p_frag(const float (&p)[NT][MT][4], int j,
                                           uint32_t (&ah)[MT][4],
                                           uint32_t (&al)[MT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    split_tf32(p[j][mt][0], ah[mt][0], al[mt][0]);
    split_tf32(p[j][mt][2], ah[mt][1], al[mt][1]);
    split_tf32(p[j][mt][1], ah[mt][2], al[mt][2]);
    split_tf32(p[j][mt][3], ah[mt][3], al[mt][3]);
  }
}

template <int D, int MT>
__device__ __forceinline__ void grl_zero(float (&o)[D][MT][4]) {
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][mt][e] = 0.f;
}

// o[d][mt] += P V over NT 8-key steps, V rows [keys][lds] from the head's
// column 0 (key 8j + 2t and + 1 for the lane's two B values, column 8d +
// g).
template <int MT, int NT, int HDP>
__device__ __forceinline__ void grl_pv(float (&o)[HDP / 8][MT][4],
                                       const float (&p)[NT][MT][4],
                                       const float* V, int lds) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  constexpr int kDt = HDP / 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ah[MT][4], al[MT][4];
    grl_p_frag(p, j, ah, al);
    const float* vr = V + (8 * j + 2 * t) * lds + g;
#pragma unroll
    for (int d = 0; d < kDt; d += 2) {
      float vb[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        vb[q][0] = vr[8 * (d + q)];
        vb[q][1] = vr[lds + 8 * (d + q)];
      }
      mma_3xtf32(*reinterpret_cast<float(*)[2][MT][4]>(&o[d]), ah, al, vb);
    }
  }
}

// Rows 16 mt + g (+ 8) of o, times inv, into the head's channels
// [ch0, ch0 + hd) of the tile's pixels (row r at pixel (y0 + r / 8,
// x0 + r % 8) of an [H, W] image of C2-channel rows at `out`).
template <int MT, int HDP>
__device__ __forceinline__ void grl_store(const float (&o)[HDP / 8][MT][4],
                                          const float (&inv)[MT][2],
                                          float* __restrict__ out, int r0,
                                          int W, int C2, int ch0, int hd) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bool pairs = C2 % 2 == 0 && ch0 % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * mt + g + 8 * h;
      float* orow = out + ((long long)(r / kGrlWs) * W + r % kGrlWs) * C2 +
                    ch0;
#pragma unroll
      for (int d = 0; d < HDP / 8; ++d) {
        const int col = 8 * d + 2 * t;
        const float v0 = o[d][mt][2 * h] * inv[mt][h];
        const float v1 = o[d][mt][2 * h + 1] * inv[mt][h];
        if (pairs && col + 1 < hd) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
        } else {
          if (col < hd) orow[col] = v0;
          if (col + 1 < hd) orow[col + 1] = v1;
        }
      }
    }
}

// The additive terms of warp unit u's first product, (bias + mask) *
// log2 e: the window half's first 32 keys ([4][kMt][4] fragments) or the
// stripe's stage 1 ([8][1][4]), into pre.
template <int HDP>
__device__ __forceinline__ void grl_first_add(float (&pre)[32],
                                              const GrlHalf& hf, int stripe,
                                              int u, int tile) {
  using Shape = GrlShape<HDP>;
  const int head = u / Shape::kUnits, r0 = (u % Shape::kUnits) * Shape::kRows;
  if (!stripe)
    grl_add(*reinterpret_cast<float(*)[4][Shape::kMt][4]>(pre),
            hf.bias + ((long long)head * kGrlN + r0) * kGrlN,
            hf.mask ? hf.mask + ((long long)tile * kGrlN + r0) * kGrlN
                    : nullptr,
            kGrlN);
  else
    grl_add(*reinterpret_cast<float(*)[8][1][4]>(pre),
            hf.bias + (long long)head * kGrlNa * kGrlN, nullptr, kGrlN);
}

template <int HDP>
__global__ void __launch_bounds__(kGrlThreads, 2)
grl_attention_kernel(GrlArgs p, int tiles_x, int tiles) {
  using Shape = GrlShape<HDP>;
  constexpr int kMt = Shape::kMt, kRows = Shape::kRows, kDt = Shape::kDt;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ uint64_t bar;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int stripe = blockIdx.x % 2;
  const int bt = blockIdx.x / 2;  // batch * tiles + tile
  const int tile = bt % tiles, b = bt / tiles;
  const int ty = tile / tiles_x, tx = tile % tiles_x;
  const GrlHalf hf = stripe ? p.half[1] : p.half[0];
  const int C2 = p.C2, H = p.H, W = p.W;
  const int hd = C2 / hf.heads;
  // shared memory: q, k, v tiles (one [64][ldi] tile where packed), the
  // anchor tile, then HDP zeros
  const int lds = hf.packed ? hf.ldi : C2;
  float* qs = sm;
  float* ks = hf.packed ? sm + C2 : sm + kGrlN * C2;
  float* vs = hf.packed ? sm + 2 * C2 : sm + 2 * kGrlN * C2;
  float* as = sm + 3 * kGrlN * C2;
  float* pad = as + (stripe ? kGrlNa * C2 : 0);

  if (tid == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  for (int i = tid; i < HDP; i += kGrlThreads) pad[i] = 0.f;
  __syncthreads();
  if (tid == 0) {
    const uint32_t row = 4 * kGrlWs * hf.ldi;  // bytes of a tile row
    const uint32_t arow = 4 * kGrlAws * C2;
    const int copies = hf.packed ? 1 : 3;
    mbar_arrive_expect_tx(&bar, kGrlWs * copies * row +
                                    (stripe ? kGrlAws * arow : 0));
    const float* src[3] = {hf.q, hf.k, hf.v};
    for (int c = 0; c < copies; ++c)
      for (int y = 0; y < kGrlWs; ++y) {
        const long long pix =
            ((long long)b * H + ty * kGrlWs + y) * W + tx * kGrlWs;
        bulk_copy(sm + c * kGrlN * C2 + y * kGrlWs * hf.ldi,
                  src[c] + pix * hf.ldi, row, &bar);
      }
    if (stripe)
      for (int y = 0; y < kGrlAws; ++y) {
        const long long pix = ((long long)b * (H / 2) + ty * kGrlAws + y) *
                                  (W / 2) + tx * kGrlAws;
        bulk_copy(as + y * kGrlAws * C2, p.anchor + pix * C2, arow, &bar);
      }
  }
  // the additive terms of the warp's first unit, loaded while the copies
  // land
  float pre[32];
  if (warp < hf.heads * Shape::kUnits)
    grl_first_add<HDP>(pre, hf, stripe, warp, tile);
  mbar_wait(&bar, 0);
  // q and k (and the anchors) normalised in place, q times its scale
  // (window: s_w; stripe: s2, stage 2's; stage 1 scales the anchors by s1
  // as it reads them)
  grl_normalise(qs, ks, as, lds, C2, hf.heads, hd,
                stripe ? hf.scale2 : hf.scale, stripe);
  __syncthreads();

  // the tile's first pixel in the outputs
  float* out = hf.out + (((long long)b * H + ty * kGrlWs) * W +
                         tx * kGrlWs) * C2;
  for (int u = warp; u < hf.heads * Shape::kUnits; u += kGrlWarps) {
    const int head = u / Shape::kUnits, r0 = (u % Shape::kUnits) * kRows;
    const int ch0 = head * hd;
    float o[kDt][kMt][4], inv[kMt][2];
    grl_zero(o);
    if (u != warp) grl_first_add<HDP>(pre, hf, stripe, u, tile);
    if (!stripe) {
      // the keys in two halves of 32, a softmax carried across them (the
      // registers of all 64 keys' S besides O spill)
      const float* bias = hf.bias + ((long long)head * kGrlN + r0) * kGrlN;
      const float* mask =
          hf.mask ? hf.mask + ((long long)tile * kGrlN + r0) * kGrlN : nullptr;
      float m[kMt][2], l[kMt][2];
      auto keys = [&](float (&s)[4][kMt][4], int k0) {
        grl_qk<kMt, 4, HDP, false>(s, qs + r0 * lds + ch0, lds,
                                   ks + k0 * lds + ch0, lds, hd, 1.f);
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float mx = -INFINITY;
#pragma unroll
            for (int n = 0; n < 4; ++n)
              mx = fmaxf(mx, fmaxf(s[n][mt][2 * h], s[n][mt][2 * h + 1]));
            mx = quad_max(mx);
            const float mn = k0 ? fmaxf(m[mt][h], mx) : mx;
            float ps = 0.f;
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              float& s0 = s[n][mt][2 * h];
              float& s1 = s[n][mt][2 * h + 1];
              s0 = ex2(s0 - mn);
              s1 = ex2(s1 - mn);
              ps += s0 + s1;
            }
            if (k0) {
              const float corr = ex2(m[mt][h] - mn);
              l[mt][h] = l[mt][h] * corr + ps;
#pragma unroll
              for (int d = 0; d < kDt; ++d) {
                o[d][mt][2 * h] *= corr;
                o[d][mt][2 * h + 1] *= corr;
              }
            } else {
              l[mt][h] = ps;
            }
            m[mt][h] = mn;
          }
        grl_pv<kMt, 4, HDP>(o, s, vs + k0 * lds + ch0, lds);
      };
      // the second half's terms load while the first half's products run
      float later[4][kMt][4];
      grl_add(later, bias + 32, mask ? mask + 32 : nullptr, kGrlN);
      keys(*reinterpret_cast<float(*)[4][kMt][4]>(pre), 0);
      keys(later, 32);
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) inv[mt][h] = 1.f / quad_sum(l[mt][h]);
    } else {
      // stage 1: the anchors attend to the tile's keys; x1 = P1 V / l1
      float x1[kDt][1][4];
      {
        float(&s1)[8][1][4] = *reinterpret_cast<float(*)[8][1][4]>(pre);
        float inv1[1][2];
        grl_qk<1, 8, HDP, true>(s1, as + ch0, C2, ks + ch0, lds, hd,
                                __ldg(hf.scale + head) * kLog2e);
        grl_softmax(s1, inv1);
        grl_zero(x1);
        grl_pv<1, 8, HDP>(x1, s1, vs + ch0, lds);
#pragma unroll
        for (int d = 0; d < kDt; ++d) {
          x1[d][0][0] *= inv1[0][0];
          x1[d][0][1] *= inv1[0][0];
          x1[d][0][2] *= inv1[0][1];
          x1[d][0][3] *= inv1[0][1];
        }
      }
      // stage 2: the tile's queries attend to the anchor summary
      float s2[2][kMt][4];
      grl_add(s2, hf.bias2 + ((long long)head * kGrlN + r0) * kGrlNa,
              nullptr, kGrlNa);
      grl_qk<kMt, 2, HDP, false>(s2, qs + r0 * lds + ch0, lds, as + ch0, C2,
                                 hd, 1.f);
      grl_softmax(s2, inv);
      // O = P2 x1: x1's B fragment (anchor 8j + 2t (+1), column 8d + g) is
      // in lane 4 (2t) + g / 2 (+ 4), value 2j + g % 2 of its n-tile d
      const int src0 = 8 * t + g / 2, odd = g % 2;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t ah[kMt][4], al[kMt][4];
        grl_p_frag(s2, j, ah, al);
#pragma unroll
        for (int d = 0; d < kDt; ++d) {
          float xb[1][2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float e0 =
                __shfl_sync(0xffffffffu, x1[d][0][2 * j], src0 + 4 * q);
            const float e1 =
                __shfl_sync(0xffffffffu, x1[d][0][2 * j + 1], src0 + 4 * q);
            xb[0][q] = odd ? e1 : e0;
          }
          mma_3xtf32(*reinterpret_cast<float(*)[1][kMt][4]>(&o[d]), ah, al,
                     xb);
        }
      }
    }
    grl_store<kMt, HDP>(o, inv, out, r0, W, C2, ch0, hd);
  }
}

// One launch over B * tiles * 2 blocks (H % 8 == 0 == W % 8, anchors at
// [B, H / 2, W / 2, C2]); hdp from grl_head_box of the wider head. The
// operands' bases and rows must be 16-byte aligned for the bulk copies
// (C2 floats a row, or 3 C2 packed), bias and mask 8-byte aligned.
cudaError_t grl_attention_launch(const GrlArgs& a, int B,
                                 cudaStream_t stream) {
  const int C2 = a.C2;
  int hdp = 0;
  for (int s = 0; s < 2; ++s) {
    const GrlHalf& h = a.half[s];
    if (h.heads <= 0 || C2 % h.heads) return cudaErrorInvalidValue;
    const int box = grl_head_box(C2 / h.heads);
    if (!box) return cudaErrorInvalidValue;
    hdp = box > hdp ? box : hdp;
    const size_t bases = reinterpret_cast<size_t>(h.q) |
                         (h.packed ? 0 : reinterpret_cast<size_t>(h.k) |
                                             reinterpret_cast<size_t>(h.v));
    if (bases % 16 || (h.packed && (h.ldi != 3 * C2 || h.k != h.q + C2 ||
                                    h.v != h.q + 2 * C2)) ||
        (!h.packed && h.ldi != C2))
      return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<size_t>(a.anchor) % 16 || a.H % kGrlWs ||
      a.W % kGrlWs)
    return cudaErrorInvalidValue;
  const size_t smem = size_t(grl_smem_floats(C2, hdp)) * sizeof(float);
  const int tiles_x = a.W / kGrlWs, tiles = (a.H / kGrlWs) * tiles_x;
  const long long blocks = 2LL * B * tiles;
  if (blocks > 0x7fffffffLL || blocks == 0) return cudaErrorInvalidValue;
#define FF_GRL_LAUNCH(P)                                                    \
  if (hdp == P) {                                                           \
    cudaError_t err = cudaFuncSetAttribute(                                 \
        grl_attention_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
        int(smem));                                                         \
    if (err != cudaSuccess) return err;                                     \
    grl_attention_kernel<P><<<unsigned(blocks), kGrlThreads, smem, stream>>>( \
        a, tiles_x, tiles);                                                 \
    return cudaGetLastError();                                              \
  }
  FF_GRL_LAUNCH(16)
  FF_GRL_LAUNCH(32)
  FF_GRL_LAUNCH(48)
  FF_GRL_LAUNCH(64)
  FF_GRL_LAUNCH(96)
#undef FF_GRL_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace
