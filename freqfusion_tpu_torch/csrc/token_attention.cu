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
// FLOPs of projections: at 336x512, 50.7 (phase 3) and 90.2 GFLOP (phase
// 4), 0.31 and 0.55 ms as three TF32 products at 495 TFLOP/s (0.81 and
// 1.37 ms on the fp32 cores), against 0.24 and 0.21 ms for reading x and
// writing out once. The attention itself, 4 T^2 E a pixel, is 3.6 and 1.4
// GFLOP. So the projections run on the tensor cores in 3xTF32
// (tf32_mma.cuh: mma.sync m16n8k8, lo*hi + hi*lo + hi*hi), the attention
// on the fp32 cores.
//
// Two launches a call:
//   1. token_attention_prep_kernel lays the weights out once, by head
//      groups (a head each, or two where heads are 16 wide or less and E >
//      64): a group's q | k | v columns (each head's hd padded to hdq, a
//      multiple of 16; the 1/sqrt(hd) q-scale folded into q's columns and
//      bias, as the JAX wrapper does), then its rows of Wout; both in
//      mma.sync's fragment order (a lane's B fragment is two adjacent
//      floats), as "pieces" that a block bulk-copies whole. It reads Win
//      and Wout through their strides, so the module's transposed views
//      need no copy.
//   2. token_attention_kernel<WC, NO, KT>: a persistent grid of blocks of
//      4 x WC warps (WC 2 with a head a group, WC 4 with two) in two
//      teams, each team half the warps and half the tile's rows, synced
//      by its own named barrier, so that one team's softmax runs beside
//      the other's products. A tile is two teams' pb whole pixels (rows =
//      pb T, padded to 32: 7 pixels at T 9, 16 at T 4). A team's x rows
//      go to shared memory by cp.async (the next tile's during the last
//      group's attention); then group by group:
//        a. the group's q | k | v = x Win_g + b_g on the tensor cores, 24
//           WC columns a piece (a head's 48 at WC 2, two heads' at WC 4),
//           into a q|k|v tile: warp (wr, wc) owns rows 32 wr.. of its
//           team (two m-tiles) and 3 of a piece's 3 WC n-tiles;
//        b. the T x T softmax of each head on the fp32 cores, two threads
//           a (row, head) (half of hdq each, partial dot products summed by
//           one shuffle), exp2 of log2(e)-scaled logits; o_h over q_h. KT
//           = T for the path's two geometries (the loops unrolled, no
//           guards; E = np, so the q|k|v product's K is known too), 0
//           elsewhere;
//        c. out += o_g Wout_g on the tensor cores, 8 WC rows of Wout a
//           piece, the sum over groups held in registers (warp: two
//           m-tiles x NO n-tiles);
//      then out = acc + bout, stored from the fragments (a quad writes 32
//      contiguous bytes of a row).
//      The weight pieces stream through a ring of bulk copies on
//      mbarriers (three stages at WC 2, a group ahead; two at WC 4) that
//      the teams share: the last team done with a stage refills it (a
//      counter a stage). A team syncs after each piece and after the
//      softmax, all of which its tiles' reuse needs anyway.
// At T 9 (E 64) a block of 8 warps takes 100 KB and at most 128 registers
// a thread: two blocks an SM. At T 4 (E 128) 8 warps would need 64
// registers a thread for the out sums alone (one block, 8 warps, an SM),
// so 16 warps take two heads a group: 32 registers of sums, 16 warps an
// SM, half the groups (barrier rounds) a tile.
// The weights stay fp32 in the ring and a lane splits its B fragment as
// it reads it (as it does its A fragment): split beforehand they would
// double the ring (at T 4 the ring, the x tile and the q|k|v tile would
// pass the 227 KB a block may have) and the bytes every tile pulls from
// L2. Weight bytes from L2 a tile: E^2 16 = 64 KB at T 9, 256 KB at T 4
// (0.81 and 1.41 GB a call at 336x512).
//
// bf16 form: ff_token_attention_bf16, for the fusion net in bf16, with
// the JAX kernel's rounding points (pallas_token_attention.py, on bf16
// operands): the q-scale folded into Win's q columns and bias in fp32,
// then rounded to bf16 (:96-105); q | k | v = bf16(x Win + bin) with fp32
// sums and bias add (:51); each logit the fp32 sum of the q k products
// (:57 rounds each product to bf16 in the source, a round trip XLA's
// default excess precision drops, so the kernel as JAX runs it sums exact
// fp32 products: the product of two bf16 values is exact in fp32, and an
// FMA gives the same sums); the softmax in fp32, not rounded; o_h = sum
// of p v in fp32, rounded a head (:58-63); out = bf16(o Wout + bout)
// (:69). Four launches, no library call:
//   1. ta_bf16_prep_kernel: Win (q-scale folded) and Wout, through their
//      strides, zero-padded to [kp][np] bf16, and the folded bias;
//   2. q | k | v on bf16_gemm.cuh's GEMM (bf16 mma.sync m16n8k16, fp32
//      sums, no hi/lo split), rows of x read in place (E a multiple of 8:
//      16-byte rows), into a [P T, 3E] bf16 scratch;
//   3. ta_bf16_attend_kernel<HD>: a block stages whole pixels' q | k | v
//      rows in shared memory, then a thread a (pixel, head, query token)
//      on the fp32 cores, into o [P T, E] bf16;
//   4. out = bf16(o Wout + bout), the same GEMM.
// What bounds it: bytes. At 336x512 x and out are 0.40 (T 9) and 0.35 GB
// (T 4), 0.12 and 0.11 ms, against 0.05 and 0.09 ms of products at 989
// TFLOP/s and 0.05 and 0.02 ms of attention on the fp32 cores; this first
// version moves q | k | v and o through device memory besides (four times
// x's bytes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_gemm.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kMaxRows = 128;  // rows a tile: 4 row groups of 32
constexpr int kMaxT = 16;
constexpr size_t kSmemLimit = 232448;  // a block's shared memory (227 KB)

// The block: 4 row groups x wc column groups of warps (wc 2: 8 warps, a
// group one head, a ring of 3 pieces; wc 4: 16 warps, a group two heads
// of hd <= 16, a ring of 2), in `teams` teams of whole row groups. Every
// warp owns two m-tiles of its row group and 3 of a q|k|v piece's 3 wc
// n-tiles, then no of the out product's.
inline int stages(int wc) { return wc == 2 ? 3 : 2; }

struct TaPlan {
  int hd, hdq, wc, g, gw, groups, chunks;  // g heads a group, gw = g hdq
  int kp, np, no;
  int piece;               // floats of a ring stage
  int teams;               // 2, or 1 where two teams' rows do not fit
  int pt, rows, rows_pad;  // a team's pixels, rows, rows padded to 32
  long long tiles;         // tiles of teams pt pixels
  long long weight_floats;  // the laid-out weights; then the biases
  long long scratch_floats;
  size_t smem;
};

// wc 4 (two heads a group) where the heads are 16 wide or less and wc 2
// would hold one 8-warp block an SM (E > 64: the out sums' registers).
// Two teams of 64 rows each where they fit, else one of up to 128: the
// first of (2 teams, 64 or 32 rows a team; 1 team, 128 .. 32 rows) whose
// shared memory fits (ring, x tile [rows][kp + 8], q|k|v tile [rows][3
// gw + 8], an mbarrier and a counter a stage): 2 x 64 wherever hd <= 16.
TaPlan ta_plan(long long P, int T, int E, int nh) {
  TaPlan q;
  q.hd = E / nh;
  q.wc = q.hd <= 16 && E > 64 ? 4 : 2;
  q.g = q.wc / 2;
  q.hdq = (q.hd + 15) / 16 * 16;
  q.gw = q.g * q.hdq;
  q.groups = (nh + q.g - 1) / q.g;
  q.chunks = q.gw / (8 * q.wc);  // q|k|v pieces a group, and out pieces
  q.kp = (E + 7) / 8 * 8;
  q.np = E <= 64 ? 64 : E <= 128 ? 128 : 160;
  q.no = q.np / (8 * q.wc);
  const int qkv = 24 * q.wc * q.kp, out = 8 * q.wc * q.np;
  q.piece = qkv > out ? qkv : out;
  for (q.teams = 2; q.teams >= 1; --q.teams) {
    bool fits = false;
    for (int cap = kMaxRows / q.teams; cap >= 32 && !fits; cap -= 32) {
      q.pt = cap / T;
      q.rows = q.pt * T;
      q.rows_pad = (q.rows + 31) / 32 * 32;
      q.smem = (size_t(stages(q.wc)) * q.piece +
                size_t(q.teams) * q.rows_pad * (q.kp + 8 + 3 * q.gw + 8)) *
                   sizeof(float) +
               stages(q.wc) * 16;
      fits = q.smem <= kSmemLimit;
    }
    if (fits) break;
  }
  if (q.teams < 1) q.teams = 1;  // nothing fits: ff_token_attention refuses
  q.tiles = q.pt > 0 ? (P + q.teams * q.pt - 1) / (q.teams * q.pt) : 0;
  q.weight_floats = (long long)q.groups * q.chunks * (qkv + out);
  q.scratch_floats = q.weight_floats + 3LL * q.groups * q.gw + q.np;
  return q;
}

struct PrepArgs {
  const float* win;   // [E, 3E] through strides (ws0, ws1)
  const float* bin;   // [3E]
  const float* wout;  // [E, E] through strides (os0, os1)
  const float* bout;  // [E]
  long long ws0, ws1, os0, os1;
  float* w;  // the laid-out weights, then the biases
  int E, nh, hd, hdq, g, gw, groups, chunks, wc, kp, np;
  float scale;
};

// One float2 of the laid-out weights a thread (grid-stride), then the
// biases. A group's columns are [q | k | v], each gw wide: head g0 + i's
// hdq columns at i hdq (its hd real, the rest zeros; q scaled). Its
// pieces: `chunks` q|k|v pieces (kp x 24 wc: [k8 block][3 wc n-tiles][32
// lanes][2]), then `chunks` out pieces (8 wc of the group's gw rows of
// Wout x np: [wc k8 blocks][np / 8 n-tiles][32][2]). A fragment unit (kb,
// nt, lane (g, t)) holds W[8 kb + 2t][8 nt + g] and W[8 kb + 2t + 1][8 nt
// + g]: fragment rows t and t + 4 are rows 2t and 2t + 1, the order in
// which a lane reads its A fragment's two columns as one 8-byte load. The
// biases: per group [q | k | v] (gw each, q scaled), then bout padded to
// np.
__global__ void __launch_bounds__(256)
token_attention_prep_kernel(PrepArgs p) {
  const long long qkv_units = 12LL * p.wc * p.kp;  // a piece's float2s
  const long long out_units = 4LL * p.wc * p.np;
  const long long group_units = p.chunks * (qkv_units + out_units);
  const long long units = group_units * p.groups;
  const int nbias = 3 * p.groups * p.gw + p.np;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < units + nbias;
       i += gridDim.x * 256LL) {
    if (i >= units) {
      const int j = int(i - units);
      float v = 0.f;
      if (j < 3 * p.groups * p.gw) {
        const int c = j % (3 * p.gw), part = c / p.gw;
        const int h = j / (3 * p.gw) * p.g + c % p.gw / p.hdq;
        const int d = c % p.hdq;
        if (h < p.nh && d < p.hd)
          v = p.bin[part * p.E + h * p.hd + d] * (part ? 1.f : p.scale);
      } else if (j - 3 * p.groups * p.gw < p.E) {
        v = p.bout[j - 3 * p.groups * p.gw];
      }
      p.w[2 * units + j] = v;
      continue;
    }
    const int gp = int(i / group_units);
    long long u = i % group_units;
    const int lane = int(u % 32), g = lane / 4, t = lane % 4;
    float v[2] = {0.f, 0.f};
    if (u < p.chunks * qkv_units) {
      const int c = int(u / qkv_units);
      const int blk = int(u % qkv_units) / 32, kb = blk / (3 * p.wc);
      const int col = 24 * p.wc * c + 8 * (blk % (3 * p.wc)) + g;
      const int part = col / p.gw, h = gp * p.g + col % p.gw / p.hdq;
      const int d = col % p.hdq;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * kb + 2 * t + e;
        if (k < p.E && h < p.nh && d < p.hd)
          v[e] = p.win[k * p.ws0 + (part * p.E + h * p.hd + d) * p.ws1] *
                 (part ? 1.f : p.scale);
      }
    } else {
      u -= p.chunks * qkv_units;
      const int c = int(u / out_units);
      const int blk = int(u % out_units) / 32;
      const int kb = blk / (p.np / 8), n = 8 * (blk % (p.np / 8)) + g;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * p.wc * c + 8 * kb + 2 * t + e;  // of the gw rows
        const int h = gp * p.g + k / p.hdq, d = k % p.hdq;
        if (h < p.nh && d < p.hd && n < p.E)
          v[e] = p.wout[(h * p.hd + d) * p.os0 + n * p.os1];
      }
    }
    reinterpret_cast<float2*>(p.w)[i] = make_float2(v[0], v[1]);
  }
}

struct TaArgs {
  const float* x;
  float* out;
  const float* w;     // the laid-out weights
  const float* bias;  // [groups][3 gw], then bout [np]
  long long rows_total, tiles;
  int T, E, groups, g, hdq, gw, chunks, kp, np, piece;
  int teams, rows, rows_pad;  // a team's rows, padded to 32
};

// acc[j][mt] += A B over `k8s` (<= K8) k8 blocks: A the shared tile `as`
// (row stride lda) at rows row0 + 16 mt + (g, g + 8), its k8 block's
// column pairs (2t, 2t + 1) read as one float2; B a piece in fragment
// order with `ntiles` n-tiles a k8 block, this warp's from n-tile nt0 on.
// Both operands are split into hi/lo here, and each product is three
// TF32 products.
template <int N, int K8>
__device__ __forceinline__ void product(float (&acc)[N][2][4],
                                        const float* as, int lda, int row0,
                                        int k8s, const float* wp, int ntiles,
                                        int nt0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* ar = as + (row0 + g) * lda + 2 * t;
  const float* br = wp + nt0 * 64 + 2 * lane;
#pragma unroll
  for (int kb = 0; kb < K8; ++kb) {
    if (kb >= k8s) break;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float2 r0 =
          *reinterpret_cast<const float2*>(ar + 16 * mt * lda + 8 * kb);
      const float2 r1 = *reinterpret_cast<const float2*>(
          ar + (16 * mt + 8) * lda + 8 * kb);
      split_tf32(r0.x, ah[mt][0], al[mt][0]);
      split_tf32(r1.x, ah[mt][1], al[mt][1]);
      split_tf32(r0.y, ah[mt][2], al[mt][2]);
      split_tf32(r1.y, ah[mt][3], al[mt][3]);
    }
    uint32_t bh[N][2], bl[N][2];
    const float* bk = br + kb * ntiles * 64;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(bk + 64 * j);
      split_tf32(b.x, bh[j][0], bl[j][0]);
      split_tf32(b.y, bh[j][1], bl[j][1]);
    }
    mma_3xtf32_split(acc, ah, al, bh, bl);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A team's barrier (named barrier 1 + team over its `threads`).
__device__ __forceinline__ void team_sync(int team, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(threads) : "memory");
}

// The team's x rows of tile `tile` into its part of the x tile (cp.async
// by the team's `threads` threads, tt its thread; zeros past the team's
// pixels, past P, and in columns E..kp).
__device__ __forceinline__ void load_x(const TaArgs& a, float* xs,
                                       long long tile, int team, int tt,
                                       int threads) {
  const long long r0 = (tile * a.teams + team) * a.rows;
  const int cpr = a.kp / 4, lx = a.kp + 8;
  float* dst = xs + team * a.rows_pad * lx;
  for (int i = tt; i < a.rows_pad * cpr; i += threads) {
    const int r = i / cpr, c = 4 * (i % cpr);
    const bool ok = r < a.rows && r0 + r < a.rows_total && c < a.E;
    cp_async16(dst + r * lx + c, ok ? a.x + (r0 + r) * a.E + c : a.x, ok);
  }
  cp_async_commit();
}

// o_h = softmax(q_h k_h^T) v_h over each pixel's T rows for the group's
// heads, on the team's q|k|v rows `qs`: two threads a (row, head) (half s
// of hdq each; the partial dot products summed by one shuffle), o_h
// written over q_h. tt is the thread's index in its team, rm = 128 /
// teams the team's rows at most. KT: T and hdq 16 known at compile time
// (the path's T 9 and T 4: no guards, the loads hoisted), or 0.
template <int KT>
__device__ __forceinline__ void attend(const TaArgs& a, float* qs, int lq,
                                       int tt, int rm) {
  constexpr int kT = KT ? KT : kMaxT;
  const int T = KT ? KT : a.T, hq = KT ? 8 : a.hdq / 2;
  const int s = tt % 2, r = tt / 2 % rm, gi = tt / (2 * rm);
  const bool real = r < a.rows;  // padding rows run on row 0's data
  const int rr = real ? r : 0;
  float* qr = qs + rr * lq + gi * a.hdq + s * hq;
  const float* kr = qs + (rr - rr % T) * lq + a.gw + gi * a.hdq + s * hq;
  const float* vr = kr + a.gw;
  float sc[kT];
#pragma unroll
  for (int j = 0; j < kT; ++j) sc[j] = 0.f;
  for (int d = 0; d < hq; d += 8) {
    const float4 q0 = ld4(qr + d), q1 = ld4(qr + d + 4);
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (j < T) {
        const float4 k0 = ld4(kr + j * lq + d);
        const float4 k1 = ld4(kr + j * lq + d + 4);
        float v = sc[j];
        v = fmaf(q0.x, k0.x, v);
        v = fmaf(q0.y, k0.y, v);
        v = fmaf(q0.z, k0.z, v);
        v = fmaf(q0.w, k0.w, v);
        v = fmaf(q1.x, k1.x, v);
        v = fmaf(q1.y, k1.y, v);
        v = fmaf(q1.z, k1.z, v);
        v = fmaf(q1.w, k1.w, v);
        sc[j] = v;
      }
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    if (j < T) {
      sc[j] = (sc[j] + __shfl_xor_sync(0xffffffffu, sc[j], 1)) * kLog2e;
      mx = fmaxf(mx, sc[j]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    if (j < T) {
      sc[j] = ex2(sc[j] - mx);
      sum += sc[j];
    }
  }
  const float inv = 1.f / sum;
  for (int d = 0; d < hq; d += 8) {
    float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (j < T) {
        const float4 v0 = ld4(vr + j * lq + d);
        const float4 v1 = ld4(vr + j * lq + d + 4);
        o[0] = fmaf(sc[j], v0.x, o[0]);
        o[1] = fmaf(sc[j], v0.y, o[1]);
        o[2] = fmaf(sc[j], v0.z, o[2]);
        o[3] = fmaf(sc[j], v0.w, o[3]);
        o[4] = fmaf(sc[j], v1.x, o[4]);
        o[5] = fmaf(sc[j], v1.y, o[5]);
        o[6] = fmaf(sc[j], v1.z, o[6]);
        o[7] = fmaf(sc[j], v1.w, o[7]);
      }
    }
    if (real) {
      *reinterpret_cast<float4*>(qr + d) =
          make_float4(o[0] * inv, o[1] * inv, o[2] * inv, o[3] * inv);
      *reinterpret_cast<float4*>(qr + d + 4) =
          make_float4(o[4] * inv, o[5] * inv, o[6] * inv, o[7] * inv);
    }
  }
}

template <int WC, int NO, int KT>
__global__ void __launch_bounds__(128 * WC, WC == 2 && NO <= 4 ? 2 : 1)
token_attention_kernel(TaArgs a) {
  constexpr int kThreads = 128 * WC, S = WC == 2 ? 3 : 2;
  extern __shared__ float4 smem4[];
  const int lx = a.kp + 8, lq = 3 * a.gw + 8;
  float* ring = reinterpret_cast<float*>(smem4);
  float* xs = ring + S * a.piece;
  float* qs = xs + a.teams * a.rows_pad * lx;
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + a.teams * a.rows_pad * lq);
  unsigned* freed = reinterpret_cast<unsigned*>(full + S);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int threads = kThreads / a.teams, team = tid / threads;
  const int tt = tid % threads, lw = warp % (4 * WC / a.teams);
  const int g = lane / 4, t = lane % 4, wr = lw / WC, wc = lw % WC;
  const int row0 = team * a.rows_pad + 32 * wr;  // the warp's first row
  const bool mine = 32 * wr < a.rows_pad;  // its rows lie in the team's
  float* qt = qs + team * a.rows_pad * lq;    // the team's q|k|v rows
  const int qkv_floats = 24 * WC * a.kp, out_floats = 8 * WC * a.np;
  const long long group_floats =
      (long long)a.chunks * (qkv_floats + out_floats);
  const long long tiles_here =
      (a.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long pieces = tiles_here * a.groups * 2 * a.chunks;

  // piece i of this block's stream: the groups' pieces, tile after tile
  auto load_piece = [&](long long i) {
    if (i >= pieces) return;
    const int gp = int(i % (2LL * a.chunks * a.groups));
    const int grp = gp / (2 * a.chunks), j = gp % (2 * a.chunks);
    const float* src =
        a.w + grp * group_floats +
        (j < a.chunks ? (long long)j * qkv_floats
                      : (long long)a.chunks * qkv_floats +
                            (long long)(j - a.chunks) * out_floats);
    const uint32_t bytes = 4u * (j < a.chunks ? qkv_floats : out_floats);
    const int b = int(i % S);
    fence_proxy_async();
    mbar_arrive_expect_tx(&full[b], bytes);
    bulk_copy(ring + b * a.piece, src, bytes, &full[b]);
  };
  // after a team's barrier behind its reads of piece i: the last team to
  // be done with the stage refills it with piece i + S
  auto release = [&](long long i) {
    if (tt != 0) return;
    if (a.teams > 1) {
      __threadfence_block();
      if (atomicAdd(&freed[i % S], 1u) != unsigned(a.teams - 1)) return;
      freed[i % S] = 0;
      __threadfence_block();
    }
    load_piece(i + S);
  };

  if (tid == 0) {
    for (int b = 0; b < S; ++b) {
      mbar_init(&full[b], 1);
      freed[b] = 0;
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < S; ++i) load_piece(i);
  if (tiles_here > 0) load_x(a, xs, blockIdx.x, team, tt, threads);

  long long piece = 0;
  for (long long tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    cp_async_wait<0>();
    team_sync(team, threads);  // the team's x rows are in
    float oacc[NO][2][4];
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[j][mt][e] = 0.f;

    for (int grp = 0; grp < a.groups; ++grp) {
      // a. the group's q | k | v (+ bias) into the q|k|v tile, 24 WC
      // columns a piece
      for (int c = 0; c < a.chunks; ++c, ++piece) {
        mbar_wait(&full[piece % S], uint32_t(piece / S) & 1);
        if (mine) {
          float acc[3][2][4];
#pragma unroll
          for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.f;
          product<3, NO * WC>(acc, xs, lx, row0, KT ? NO * WC : a.kp / 8,
                              ring + (piece % S) * a.piece, 3 * WC, 3 * wc);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int col = 24 * WC * c + 8 * (3 * wc + j) + 2 * t;
            const float2 b = __ldg(reinterpret_cast<const float2*>(
                a.bias + 3 * grp * a.gw + col));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                *reinterpret_cast<float2*>(
                    qs + (row0 + 16 * mt + g + 8 * hh) * lq + col) =
                    make_float2(acc[j][mt][2 * hh] + b.x,
                                acc[j][mt][2 * hh + 1] + b.y);
          }
        }
        team_sync(team, threads);  // the stage is read; the columns written
        release(piece);
      }
      if (grp == a.groups - 1 && tile + gridDim.x < a.tiles)
        load_x(a, xs, tile + gridDim.x, team, tt, threads);  // x's last read

      // b. the group's o_h over its q_h
      attend<KT>(a, qt, lq, tt, kMaxRows / a.teams);
      team_sync(team, threads);  // o is complete

      // c. out += o Wout_group, 8 WC of o's columns a piece
      for (int c = 0; c < a.chunks; ++c, ++piece) {
        mbar_wait(&full[piece % S], uint32_t(piece / S) & 1);
        if (mine)
          product<NO, WC>(oacc, qs + 8 * WC * c, lq, row0, WC,
                          ring + (piece % S) * a.piece, NO * WC, NO * wc);
        team_sync(team, threads);  // the stage and o are read
        release(piece);
      }
    }

    // out = acc + bout, the team's rows within its pixels and P
    if (mine) {
      const long long r0 = (tile * a.teams + team) * a.rows;
      const float* bout = a.bias + 3 * a.groups * a.gw;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int col = 8 * (NO * wc + j) + 2 * t;
        if (col >= a.E) continue;
        const float2 b = __ldg(reinterpret_cast<const float2*>(bout + col));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 32 * wr + 16 * mt + g + 8 * hh;
            if (r < a.rows && r0 + r < a.rows_total)
              *reinterpret_cast<float2*>(a.out + (r0 + r) * a.E + col) =
                  make_float2(oacc[j][mt][2 * hh] + b.x,
                              oacc[j][mt][2 * hh + 1] + b.y);
          }
      }
    }
  }
}

template <int WC, int NO, int KT = 0>
cudaError_t ta_launch(const TaArgs& a, size_t smem, cudaStream_t stream) {
  const auto kernel = token_attention_kernel<WC, NO, KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, 128 * WC, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long grid =
      a.tiles < (long long)per_sm * sms ? a.tiles : (long long)per_sm * sms;
  kernel<<<unsigned(grid), 128 * WC, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch ff_token_attention needs: the laid-out weights and
// biases (ta_plan, as ops/token_attention.py:plan_token_attention).
extern "C" long long ff_token_attention_scratch_floats(long long P, int T,
                                                       int E, int heads) {
  return ta_plan(P, T, E, heads).scratch_floats;
}

// x, out [P, T, E] contiguous; win [E, 3E] (q | k | v columns) and wout
// [E, E] ([in, out]) through their element strides (torch's in_proj_weight
// and out_proj.weight transposed are views: strides (1, E)); bin [3E],
// bout [E] contiguous; scratch (ff_token_attention_scratch_floats) and x
// and out 16-byte aligned. All fp32; T <= 16, E <= 160, E % 4 == 0, E %
// heads == 0.
extern "C" int ff_token_attention(const float* x, const float* win,
                                  long long ws0, long long ws1,
                                  const float* bin, const float* wout,
                                  long long os0, long long os1,
                                  const float* bout, float* out,
                                  float* scratch, long long scratch_floats,
                                  long long P, int T, int E, int num_heads,
                                  void* stream) {
  if (T < 1 || T > kMaxT || num_heads < 1 || E % num_heads || E % 4 ||
      E > 160 || P < 1 || reinterpret_cast<size_t>(x) % 16 ||
      reinterpret_cast<size_t>(out) % 16 ||
      reinterpret_cast<size_t>(scratch) % 16)
    return int(cudaErrorInvalidValue);
  const TaPlan q = ta_plan(P, T, E, num_heads);
  if (q.smem > kSmemLimit || q.pt < 1 || scratch_floats < q.scratch_floats)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  PrepArgs p{win, bin, wout, bout, ws0, ws1, os0, os1, scratch,
             E, num_heads, q.hd, q.hdq, q.g, q.gw, q.groups, q.chunks, q.wc,
             q.kp, q.np, 1.f / sqrtf(float(q.hd))};
  const long long total =
      q.weight_floats / 2 + 3LL * q.groups * q.gw + q.np;
  const long long pblocks = (total + 255) / 256;
  token_attention_prep_kernel<<<unsigned(pblocks < 264 ? pblocks : 264), 256,
                                0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  TaArgs a{x, out, scratch, scratch + q.weight_floats, P * T, q.tiles,
           T, E, q.groups, q.g, q.hdq, q.gw, q.chunks, q.kp, q.np, q.piece,
           q.teams, q.rows, q.rows_pad};
  // the path's two geometries (hd 16, E = np): T 9 at E 64, T 4 at E 128
  const bool h16 = q.hdq == 16 && E == q.np;
  if (q.wc == 4) {  // E > 64: np 128 or 160
    if (q.no == 5) return int(ta_launch<4, 5>(a, q.smem, s));
    return int(h16 && T == 4 ? ta_launch<4, 4, 4>(a, q.smem, s)
                             : ta_launch<4, 4>(a, q.smem, s));
  }
  switch (q.no) {
    case 4:
      return int(h16 && T == 9 ? ta_launch<2, 4, 9>(a, q.smem, s)
                               : ta_launch<2, 4>(a, q.smem, s));
    case 8: return int(ta_launch<2, 8>(a, q.smem, s));
    default: return int(ta_launch<2, 10>(a, q.smem, s));
  }
}

namespace {

// A's rows from a row-major [M, E] bf16 matrix (E a multiple of 8, rows
// 16-byte aligned), zeros from column E on (K is E padded to 32).
struct TaRows {
  const bf16* a;
  long long M;
  int E;
  __device__ __forceinline__ const bf16* src(long long m, int k) const {
    return m < M && k < E ? a + m * E + k : nullptr;
  }
};

// The bf16 call's scratch (byte offsets), each piece 256-byte aligned.
struct TaBf16Layout {
  int kp, npq, npo;  // E padded to 32; 3E and E padded to 64
  long long wq, bq, wo, qkv, o, bytes;
};

TaBf16Layout ta_bf16_layout(long long P, int T, int E) {
  TaBf16Layout l;
  l.kp = bg_up(E, kBgK);
  l.npq = bg_up(3 * E, kBgN);
  l.npo = bg_up(E, kBgN);
  const long long M = P * T;
  l.wq = 0;
  l.bq = l.wq + bg_piece(2LL * l.kp * l.npq);
  l.wo = l.bq + bg_piece(2LL * 3 * E);
  l.qkv = l.wo + bg_piece(2LL * l.kp * l.npo);
  l.o = l.qkv + bg_piece(2 * M * 3 * E);
  l.bytes = l.o + bg_piece(2 * M * E);
  return l;
}

// wq [kp][npq]: wq[r][n] = bf16(win[r][n] * (q column ? scale : 1)) for r <
// E, n < 3E, else 0; bq[n] = bf16(bin[n] * (the same)); wo [kp][npo]:
// wout[r][n] for r, n < E, else 0. win and wout read through their element
// strides.
__global__ void __launch_bounds__(256)
ta_bf16_prep_kernel(const bf16* __restrict__ win, long long ws0,
                    long long ws1, const bf16* __restrict__ bin,
                    const bf16* __restrict__ wout, long long os0,
                    long long os1, int E, float scale, int kp, int npq,
                    int npo, bf16* __restrict__ wq, bf16* __restrict__ bq,
                    bf16* __restrict__ wo) {
  const long long nq = (long long)kp * npq, total = nq + 3 * E +
                                                    (long long)kp * npo;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += gridDim.x * 256LL) {
    if (i < nq) {
      const int r = int(i / npq), n = int(i % npq);
      const float v = r < E && n < 3 * E
                          ? bg_f(win[r * ws0 + n * ws1]) * (n < E ? scale : 1.f)
                          : 0.f;
      wq[i] = bg_round(v);
    } else if (i < nq + 3 * E) {
      const int n = int(i - nq);
      bq[n] = bg_round(bg_f(bin[n]) * (n < E ? scale : 1.f));
    } else {
      const long long j = i - nq - 3 * E;
      const int r = int(j / npo), n = int(j % npo);
      bf16 v = bg_round(0.f);
      if (r < E && n < E) v = wout[r * os0 + n * os1];
      wo[j] = v;
    }
  }
}

// HD bf16 of a row (16-byte aligned, in shared memory) as floats.
template <int HD>
__device__ __forceinline__ void ta_load_row(float (&dst)[HD],
                                            const bf16* src) {
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const uint4 u = reinterpret_cast<const uint4*>(src)[c];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      dst[8 * c + 2 * e] = f.x;
      dst[8 * c + 2 * e + 1] = f.y;
    }
  }
}

// o[p T + i][h HD + d] = bf16(sum_j softmax_j(sum_d q_id k_jd) v_jd) over
// qkv [P T, 3E] (q | k | v, head h at columns h HD of each), fp32
// throughout. A block stages `pb` whole pixels' q | k | v rows (one
// contiguous run of qkv) in shared memory by 16-byte loads, then runs a
// thread a (pixel, head, query), reading its q row and the pixel's k and
// v rows from there.
template <int HD>
__global__ void __launch_bounds__(256)
ta_bf16_attend_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o,
                      long long P, int T, int E, int heads, int pb) {
  extern __shared__ uint4 ta_rows[];
  const long long p0 = (long long)blockIdx.x * pb;
  const int np = int(P - p0 < pb ? P - p0 : pb);
  const int row = 3 * E;  // bf16 a row
  const uint4* src = reinterpret_cast<const uint4*>(qkv + p0 * T * row);
  for (int c = threadIdx.x; c < np * T * row / 8; c += blockDim.x)
    ta_rows[c] = src[c];
  __syncthreads();
  const int u = threadIdx.x;
  if (u >= np * heads * T) return;
  const int i = u % T, h = u / T % heads, pl = u / (T * heads);
  const bf16* rows = reinterpret_cast<const bf16*>(ta_rows) +
                     (long long)pl * T * row + h * HD;
  float q[HD], r[HD];
  ta_load_row<HD>(q, rows + i * row);
  float l[kMaxT];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    if (j < T) {
      ta_load_row<HD>(r, rows + j * row + E);
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc += q[d] * r[d];
      l[j] = acc;
      mx = fmaxf(mx, acc);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j)
    if (j < T) {
      l[j] = expf(l[j] - mx);
      sum += l[j];
    }
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j)
    if (j < T) {
      const float w = l[j] / sum;
      ta_load_row<HD>(r, rows + j * row + 2 * E);
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] += w * r[d];
    }
  uint4* dst = reinterpret_cast<uint4*>(o + ((p0 + pl) * T + i) * E + h * HD);
#pragma unroll
  for (int c = 0; c < HD / 8; ++c)
    dst[c] = make_uint4(pack_bf16(acc[8 * c], acc[8 * c + 1]),
                        pack_bf16(acc[8 * c + 2], acc[8 * c + 3]),
                        pack_bf16(acc[8 * c + 4], acc[8 * c + 5]),
                        pack_bf16(acc[8 * c + 6], acc[8 * c + 7]));
}

}  // namespace

// Bytes of scratch ff_token_attention_bf16 needs (ta_bf16_layout); -1 for
// shapes it refuses.
extern "C" long long ff_token_attention_bf16_scratch_bytes(long long P,
                                                           int T, int E) {
  if (P < 1 || T < 1 || T > kMaxT || E < 8 || E % 8 || E > 2048) return -1;
  return ta_bf16_layout(P, T, E).bytes;
}

// As ff_token_attention, all bf16: x, out [P, T, E] contiguous, 16-byte
// aligned; win [E, 3E] and wout [E, E] through their element strides; bin
// [3E], bout [E]; scale the q-scale (hd^-0.5 in fp32); scratch of
// ff_token_attention_bf16_scratch_bytes bytes, 16-byte aligned. E a
// multiple of 8 and of heads; head dims 8, 16 or 32; T <= 16.
extern "C" int ff_token_attention_bf16(
    const void* x_, const void* win, long long ws0, long long ws1,
    const void* bin, const void* wout, long long os0, long long os1,
    const void* bout, void* out_, void* scratch_, long long scratch_bytes,
    long long P, int T, int E, int num_heads, float scale, void* stream) {
  const long long need = ff_token_attention_bf16_scratch_bytes(P, T, E);
  const int hd = num_heads > 0 && E % num_heads == 0 ? E / num_heads : 0;
  if (need < 0 || scratch_bytes < need || (hd != 8 && hd != 16 && hd != 32) ||
      (reinterpret_cast<size_t>(x_) | reinterpret_cast<size_t>(out_) |
       reinterpret_cast<size_t>(scratch_)) % 16)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TaBf16Layout l = ta_bf16_layout(P, T, E);
  char* scratch = static_cast<char*>(scratch_);
  auto piece = [&](long long off) {
    return reinterpret_cast<bf16*>(scratch + off);
  };
  bf16 *wq = piece(l.wq), *bq = piece(l.bq), *wo = piece(l.wo);
  bf16 *qkv = piece(l.qkv), *o = piece(l.o);
  const long long M = P * T;
  const long long total = (long long)l.kp * (l.npq + l.npo) + 3 * E;
  const long long pblocks = (total + 255) / 256;
  ta_bf16_prep_kernel<<<unsigned(pblocks < 264 ? pblocks : 264), 256, 0,
                        s>>>(static_cast<const bf16*>(win), ws0, ws1,
                             static_cast<const bf16*>(bin),
                             static_cast<const bf16*>(wout), os0, os1, E,
                             scale, l.kp, l.npq, l.npo, wq, bq, wo);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = bg_gemm(TaRows{static_cast<const bf16*>(x_), M, E}, M, wq, l.npq,
                  l.kp, l.npq, BgSegEpi{bq, {qkv, nullptr, nullptr}, M,
                                        3 * E, 1},
                  s);
  if (err != cudaSuccess) return int(err);
  // whole pixels a block: a thread each (head, query) of them, at most 256,
  // their rows in at most 48 KB
  const int per_pixel = num_heads * T;
  const long long pixel_bytes = 2LL * T * 3 * E;
  const long long by_threads = 256 / per_pixel;
  const long long by_smem = 49152 / pixel_bytes;
  const int pb = int(by_threads < by_smem ? by_threads : by_smem);
  if (pb < 1) return int(cudaErrorInvalidValue);
  const long long blocks = (P + pb - 1) / pb;
  const size_t smem = size_t(pb * pixel_bytes);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const unsigned threads = unsigned(pb * per_pixel);
  switch (hd) {
    case 8:
      ta_bf16_attend_kernel<8><<<unsigned(blocks), threads, smem, s>>>(
          qkv, o, P, T, E, num_heads, pb);
      break;
    case 16:
      ta_bf16_attend_kernel<16><<<unsigned(blocks), threads, smem, s>>>(
          qkv, o, P, T, E, num_heads, pb);
      break;
    default:
      ta_bf16_attend_kernel<32><<<unsigned(blocks), threads, smem, s>>>(
          qkv, o, P, T, E, num_heads, pb);
  }
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = bg_gemm(TaRows{o, M, E}, M, wo, l.npo, l.kp, l.npo,
                  BgSegEpi{static_cast<const bf16*>(bout),
                           {static_cast<bf16*>(out_), nullptr, nullptr}, M,
                           E, 1},
                  s);
  return int(err);
}
