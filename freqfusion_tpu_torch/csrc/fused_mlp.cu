// Fused transformer FFN half over rows of C channels, fp32:
//   pre-norm  (DRCT)  out = x + res_scale * (gelu(LN(x) W1 + b1) W2 + b2)
//   post-norm (GRL)   out = x + res_scale * LN(gelu(x W1 + b1) W2 + b2)
// with exact (erf) GELU and LayerNorm over C (biased variance, eps given).
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_mlp.py:
// fused_mlp_block (:85), which FREQFUSION_MLP=1 routes DRCT-L's 60 Swin
// FFNs (freqfusion_tpu/models/drct.py:182) and GRL-B's 40 block FFNs
// (freqfusion_tpu/models/grl.py:479) through.
//
// What bounds it on the H100: the two products, 4 C Ch FLOPs a row against
// 8 C bytes of x and out (C = 180..308, Ch = 276..976): 90 to 490 FLOPs a
// byte, far above the card's balance point. On the fp32 CUDA cores that
// is 8.05 ms over chip_smoke.py's six phase-2 shapes (539 GFLOP); the old
// register-tiled FMA body took 25.4 ms, held by FMA issue and the shared
// loads feeding it. So both products run on the tensor cores in 3xTF32
// (tf32_mma.cuh: x = hi + lo, lo*hi + hi*lo + hi*hi, mma.sync m16n8k8,
// fp32 accumulation): 3 x 539 GFLOP / 495 TFLOP/s = 3.27 ms. This body
// takes 10.6-10.7 ms over the six shapes on an H100 at 700 W (the up
// product at C 244 1.33 ms, ~205 TFLOP/s of tensor work; the down 1.11
// ms). mma.sync TF32 itself stays well below the card's dense TF32 peak
// (csrc/bench/mma_sync_ceiling.cu times it alone); what is left is the
// products' own fragment loads and in-register splits, the ring's one
// barrier a stage, and the T and H round trips.
//
// Design. Four launches a call, no library call:
//   1. split W1 and W2 into hi/lo once a call, zero-padded to the tiles,
//      into the caller's scratch, in fragment order: for each k8 block and
//      n-tile, lane (g, t)'s four values side by side, so a product reads
//      a lane's whole B fragment (hi and lo) with one 16-byte load;
//   2. T = LN(x) (pre-norm) or x, zero-padded to kp1 columns, tiled;
//   3. up:   H = gelu(T W1 + b1), 128-row tiles of 128 hidden columns (64
//      where that pads Ch less), H written tiled for the down product;
//   4. down: out = x + res_scale * (LN)(H W2 + b2), 64-row tiles of all of
//      C, so the post-norm LayerNorm and the residual run in the tile.
// The hidden goes through device memory ([Mp, kp2] fp32 in the scratch):
// 8 M Ch bytes a call, 4.8 GB (1.4 ms at 3.35 TB/s) over the six shapes,
// read and written at 270+ tensor FLOPs a byte, under the products. Kept
// on chip instead, a 64-row block must hold T (79 KB at C 308 in fp32,
// 158 KB split), a hidden chunk, both weights' rings and a 64 x C output
// in registers, with two barrier-separated phases a hidden chunk.
// Both products run one pipeline: 8 warps a block (4 for the 64-column up
// tile), each owning 32 rows (two m-tiles) x 8 NT columns; K goes 16
// columns a stage through a ring of 3-4 stages (two or three blocks an
// SM; one for the down product's widest rows, whose registers allow one).
// The activations are written by the launch before in tiled() order, so
// a block's A tile of a stage is one contiguous piece: thread 0 issues a
// stage as three bulk copies (A and the two k8 blocks of W) on the
// stage's mbarrier, and one barrier a stage keeps the refill behind every
// warp's reads. A lane splits its A fragment in registers as it reads it.
// The k8 blocks' K order is permuted (fragment column t is column 2t, t +
// 4 is 2t + 1, in W's split as in A's read), so a lane reads its A
// fragment as two 8-byte pairs, and the pairs of a row are swizzled so
// that a warp's reads hit 32 distinct banks.
// Tried on the H100 in this design's making and not kept (chip_smoke.py
// phase 2 on each version, six shapes): the activations split once a
// block into padded hi/lo planes by the threads that copied them (14.7
// ms); 16 warps, the A tile copied 4 bytes at a time straight into
// fragment order (16.1); 16-byte A copies split in place (16.4): each
// warp spent a large share of every stage issuing copies and splitting,
// in step with the rest of its block, so the tensor pipe idled (a clock64
// profile of timing-only copies); each A row as its own bulk copy (13.5):
// the copy engine queued 128 small copies a stage.
// Zero padding: K past C meets zero W1 rows; N past Ch gives gelu(0 + 0)
// = 0 in H's padding columns, which meet zero W2 rows; N past C gives
// zeros that neither the store nor the LayerNorm's sums read; T's and H's
// padding rows are computed and never stored to out.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kBK = 16;    // K columns a stage: two k8 blocks
constexpr int kUpM = 128;  // up: rows a block (T's and H's row padding)

// A block of WR x WC warps, each 32 rows x 8 NT columns, with a ring of
// `Stages` stages and MinBlocks blocks an SM (128 registers a thread at 2).
// A stage: the A tile ([kBM][kBK], as tiled() lays it out) and the W
// tile's fragments (two k8 blocks of kBN / 8 n-tiles, 128 floats each);
// then an mbarrier a stage.
template <int WR, int WC, int NT, int Stages, int MinBlocks>
struct Tile {
  static constexpr int kThreads = 32 * WR * WC, kWC = WC;
  static constexpr int kStages = Stages, kMinBlocks = MinBlocks;
  static constexpr int kBM = 32 * WR, kBN = 8 * NT * WC;
  static constexpr int kA = kBM * kBK, kW = 2 * 16 * kBN;
  static constexpr int kStage = kA + kW;  // floats
  static constexpr size_t kSmemBytes = size_t(Stages) * kStage * 4 +
                                       Stages * sizeof(uint64_t);
};

// up: 128 x 128 (8 warps, two blocks an SM), or 128 x 64 (4 warps, three
// blocks an SM) where that pads Ch less (Ch 276, 308)
template <int WC>
using UpTile = Tile<4, WC, 8, 4, WC == 2 ? 2 : 3>;

template <int NT>  // 64 x 32 NT; wider than 8, one block an SM
using DownTile = Tile<2, 4, NT, 3, NT <= 8 ? 2 : 1>;

// The activations' tiled layout (T for the up product, H for the down):
// row m, column c of a matrix with `ks` 16-column stages, in row blocks of
// `bm` rows, at [m / bm][c / 16][m % bm][16], so that a block's A tile of
// a stage is one contiguous piece (one bulk copy). Within a row the 8
// column pairs are swizzled (pair p at p ^ 4 on rows with bit 1 set), so
// that a warp's 8-byte fragment reads (rows g, pairs t or 4 + t) hit 32
// distinct banks.
__device__ __forceinline__ long long tiled(long long m, int c, int ks,
                                           int bm) {
  const int r = int(m % bm), p = (c % 16) / 2;
  return (((m / bm) * ks + c / 16) * bm + r) * 16 +
         2 * (p ^ (((r >> 1) & 1) << 2)) + c % 2;
}

// Padded extents of a call, as ops/mlp.py:plan_fused_mlp computes them.
struct FfnPlan {
  int kp1;  // C rounded up to kBK: the up product's K
  int upn;  // hidden columns an up block: 64 or 128, the one padding less
  int np1;  // Ch rounded up to upn: W1's padded columns
  int kp2;  // Ch rounded up to kBK: the down product's K, H's columns
  int nt;   // n-tiles a warp in the down product (of 4 warps across C)
  int cp;   // 32 nt: the down product's padded N
};

int down_tiles(int C) {  // the instantiated widths (n-tiles a warp)
  const int need = (C + 31) / 32;
  const int nts[] = {2, 4, 6, 8, 9, 10, 12};
  for (int nt : nts)
    if (need <= nt) return nt;
  return 0;
}

FfnPlan ffn_plan(int C, int Ch) {
  FfnPlan p;
  p.kp1 = (C + kBK - 1) / kBK * kBK;
  p.upn = (Ch + 63) / 64 * 64 < (Ch + 127) / 128 * 128 ? 64 : 128;
  p.np1 = (Ch + p.upn - 1) / p.upn * p.upn;
  p.kp2 = (Ch + kBK - 1) / kBK * kBK;
  p.nt = down_tiles(C);
  p.cp = 32 * p.nt;
  return p;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// W [K, N] (row-major; k < K, n < N valid) into fragment order over
// [kp / 8][np / 8][32 lanes][4]: unit u is lane (g, t) of a (k8 block,
// n-tile) and holds hi W[2t][g], hi W[2t + 1][g], then the two lo. The k8
// block's rows are taken in the order 0, 2, 4, 6, 1, 3, 5, 7 (fragment
// row t is row 2t, row t + 4 is row 2t + 1), the order in which a lane
// reads A's columns: two adjacent columns, one 8-byte load.
__device__ __forceinline__ void split_weight_unit(const float* __restrict__ w,
                                                  float* __restrict__ fr,
                                                  int K, int N, int np,
                                                  long long u) {
  const int lane = int(u % 32), g = lane / 4, t = lane % 4;
  const long long blk = u / 32;
  const int nt = int(blk % (np / 8)), kb = int(blk / (np / 8));
  const int k = 8 * kb + 2 * t, n = 8 * nt + g;
  const float v0 = k < K && n < N ? w[(long long)k * N + n] : 0.f;
  const float v1 = k + 1 < K && n < N ? w[(long long)(k + 1) * N + n] : 0.f;
  uint4 o;
  split_tf32(v0, o.x, o.z);
  split_tf32(v1, o.y, o.w);
  *reinterpret_cast<uint4*>(fr + 4 * u) = o;
}

// 1. W1 and W2 into fragment order.
__global__ void __launch_bounds__(256)
ffn_split_weights(const float* __restrict__ w1, const float* __restrict__ w2,
                  float* __restrict__ w1fr, float* __restrict__ w2fr, int C,
                  int Ch, FfnPlan p) {
  const long long n1 = (long long)p.kp1 / 8 * (p.np1 / 8) * 32;
  const long long n2 = (long long)p.kp2 / 8 * (p.cp / 8) * 32;
  for (long long u = blockIdx.x * 256LL + threadIdx.x; u < n1 + n2;
       u += gridDim.x * 256LL) {
    if (u < n1)
      split_weight_unit(w1, w1fr, C, Ch, p.np1, u);
    else
      split_weight_unit(w2, w2fr, Ch, C, p.cp, u - n1);
  }
}

// 2. T = LN(x) (norm) or x, zero-padded to kp1 columns and Mp rows (a
// multiple of kUpM), tiled: the up product's A. One warp a row, held in
// registers (C <= 384).
__global__ void __launch_bounds__(256)
ffn_rows(const float* __restrict__ x, const float* __restrict__ ln_s,
         const float* __restrict__ ln_b, float* __restrict__ tbuf, int M,
         int Mp, int C, int kp1, int norm, float eps) {
  const long long m = (blockIdx.x * 256LL + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (m >= Mp) return;
  const float* xr = x + (m < M ? m : 0) * C;
  const int cv = m < M ? C : 0;  // padding rows are zeros
  float v[12];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < cv ? xr[c] : 0.f;
    s += v[i];
  }
  float mu = 0.f, rs = 1.f;
  if (norm) {
    mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const float d = lane + 32 * i < C ? v[i] - mu : 0.f;
      q += d * d;
    }
    rs = rsqrtf(warp_sum(q) / C + eps);
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int c = lane + 32 * i;
    if (c < kp1)
      tbuf[tiled(m, c, kp1 / kBK, kUpM)] =
          c >= cv ? 0.f
          : norm ? fmaf((v[i] - mu) * rs, ln_s[c], ln_b[c])
                 : v[i];
  }
}

// The staged product both launches run: acc (the warp's two m-tiles x NT
// n-tiles) = A W[:, n0..] over `stages` 16-column stages, A the block's
// row block of a tiled() matrix (stage s at atile + s kBM kBK) and W in
// fragment order with `npt` n-tiles a k8 block. Thread 0 issues each stage
// as three bulk copies on the stage's mbarrier; a barrier a stage keeps
// the ring's refill behind every warp's reads.
template <class T, int NT>
struct Product {
  static constexpr int S = T::kStages;

  __device__ __forceinline__ static void run(float (&acc)[NT][2][4],
                                             float* smem,
                                             const float* __restrict__ atile,
                                             int stages,
                                             const float* __restrict__ w,
                                             int npt, int n0) {
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wr = warp / T::kWC, wc = warp % T::kWC;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * T::kStage);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.f;
    if (tid == 0) {
      for (int b = 0; b < S; ++b) mbar_init(&full[b], 1);
      mbar_init_fence();
    }
    __syncthreads();

    auto issue = [&](int s) {  // thread 0
      const int b = s % S;
      float* as = smem + b * T::kStage;
      constexpr uint32_t kABytes = 4 * T::kA, kWBytes = 64 * T::kBN;
      fence_proxy_async();
      mbar_arrive_expect_tx(&full[b], kABytes + 2 * kWBytes);
      bulk_copy(as, atile + (long long)s * T::kA, kABytes, &full[b]);
      const float* src = w + ((long long)2 * s * npt + n0 / 8) * 128;
      bulk_copy(as + T::kA, src, kWBytes, &full[b]);
      bulk_copy(as + T::kA + 16 * T::kBN, src + (long long)npt * 128,
                kWBytes, &full[b]);
    };

    if (tid == 0)
      for (int s = 0; s < S - 1 && s < stages; ++s) issue(s);
    // this lane's fragment rows (32 wr + 16 mt + g, and + 8) and the
    // swizzle of their column pairs
    const int sw = ((g >> 1) & 1) << 2;
    for (int s = 0; s < stages; ++s) {
      if (s + S - 1 < stages) {
        if (s > 0) __syncthreads();  // stage s - 1's buffer is read
        if (tid == 0) issue(s + S - 1);
      }
      mbar_wait(&full[s % S], (s / S) & 1);
      const float* as = smem + (s % S) * T::kStage;
      const float* wk0 = as + T::kA + 4 * (NT * wc * 32 + lane);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // lane (g, t): rows g and g + 8, columns 2t and 2t + 1 of the k8
        // block (fragment columns t and t + 4), split here
        uint32_t fh[2][4], fl[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int o =
              (32 * wr + 16 * mt + g) * kBK + 2 * ((4 * kk + t) ^ sw);
          const float2 r0 = *reinterpret_cast<const float2*>(as + o);
          const float2 r1 =
              *reinterpret_cast<const float2*>(as + o + 8 * kBK);
          split_tf32(r0.x, fh[mt][0], fl[mt][0]);
          split_tf32(r1.x, fh[mt][1], fl[mt][1]);
          split_tf32(r0.y, fh[mt][2], fl[mt][2]);
          split_tf32(r1.y, fh[mt][3], fl[mt][3]);
        }
        const float* wk = wk0 + kk * 16 * T::kBN;
        constexpr int kWhole = NT / 2 * 2;
#pragma unroll
        for (int j = 0; j < kWhole; j += 2) {
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const uint4 f =
                *reinterpret_cast<const uint4*>(wk + 128 * (j + q));
            bh[q][0] = f.x, bh[q][1] = f.y, bl[q][0] = f.z, bl[q][1] = f.w;
          }
          mma_3xtf32_split(*reinterpret_cast<float(*)[2][2][4]>(&acc[j]), fh,
                           fl, bh, bl);
        }
        if constexpr (kWhole < NT) {  // an odd last n-tile
          const uint4 f =
              *reinterpret_cast<const uint4*>(wk + 128 * kWhole);
          const uint32_t bh[1][2] = {{f.x, f.y}}, bl[1][2] = {{f.z, f.w}};
          mma_3xtf32_split(
              *reinterpret_cast<float(*)[1][2][4]>(&acc[kWhole]), fh, fl, bh,
              bl);
        }
      }
    }
  }
};

// 3. H[m0 .. + 128, n0 .. + 128] = gelu(T W1 + b1), tiled for the down
// product (64-row blocks), columns < kp2 stored (padding rows too). Warp
// w: rows 32 (w / 2), columns 64 (w % 2).
template <int WC>
__global__ void __launch_bounds__(UpTile<WC>::kThreads,
                                  UpTile<WC>::kMinBlocks)
ffn_up_kernel(const float* __restrict__ tbuf, const float* __restrict__ w1fr,
              const float* __restrict__ b1, float* __restrict__ h, int Ch,
              FfnPlan p) {
  using T = UpTile<WC>;
  using P = Product<T, 8>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = warp / WC, wc = warp % WC;
  const long long m0 = (long long)blockIdx.y * T::kBM;
  const int n0 = blockIdx.x * T::kBN;
  float acc[8][2][4];
  P::run(acc, smem, tbuf + m0 * p.kp1, p.kp1 / kBK, w1fr, p.np1 / 8, n0);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 64 * wc + 8 * j + 2 * t;
    if (col >= p.kp2) continue;
    const float b0 = col < Ch ? b1[col] : 0.f;
    const float bb = col + 1 < Ch ? b1[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long m = m0 + 32 * wr + 16 * mt + g + 8 * hh;
        *reinterpret_cast<float2*>(h + tiled(m, col, p.kp2 / kBK,
                                             DownTile<2>::kBM)) =
            make_float2(gelu_erf(acc[j][mt][2 * hh] + b0),
                        gelu_erf(acc[j][mt][2 * hh + 1] + bb));
      }
  }
}

// 4. out[m0 .. + 64, :] = x + res_scale * (LN)(H W2 + b2). Warp w: rows
// 32 (w / 4), columns 8 NT (w % 4).
template <int NT>
__global__ void __launch_bounds__(DownTile<NT>::kThreads,
                                  DownTile<NT>::kMinBlocks)
ffn_down_kernel(const float* __restrict__ h, const float* __restrict__ w2fr,
                const float* __restrict__ b2, const float* __restrict__ x,
                const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, float* __restrict__ out,
                int M, int C, FfnPlan p, int prenorm, float res_scale,
                float eps) {
  using T = DownTile<NT>;
  using P = Product<T, NT>;
  constexpr int kBM = T::kBM;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = warp / 4, wc = warp % 4;
  const long long m0 = (long long)blockIdx.x * kBM;
  float acc[NT][2][4];
  P::run(acc, smem, h + m0 * p.kp2, p.kp2 / kBK, w2fr, p.cp / 8, 0);

  // + b2; columns past C hold zeros
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * NT * wc + 8 * j + 2 * t;
    const float bv[2] = {col < C ? b2[col] : 0.f,
                         col + 1 < C ? b2[col + 1] : 0.f};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = col + (e & 1) < C;
        acc[j][mt][e] = in ? acc[j][mt][e] + bv[e & 1] : 0.f;
      }
  }
  if (!prenorm) {
    // LayerNorm over C: a row's 8 NT columns of each of four warps, summed
    // over the quad (t) by shuffles and over the warps in shared memory
    __syncthreads();  // the stage buffers are free
    float* red = smem;  // [2][kBM][4]: sums, then squared deviations
    float mu[2][2], rs[2][2];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = acc[j][mt][2 * hh + e];
              if (pass == 0) {
                s += v;
              } else {
                const bool in = 8 * NT * wc + 8 * j + 2 * t + e < C;
                const float d = in ? v - mu[mt][hh] : 0.f;
                s += d * d;
              }
            }
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          if (t == 0)
            red[(pass * kBM + 32 * wr + 16 * mt + g + 8 * hh) * 4 + wc] = s;
        }
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* rr =
              red + (pass * kBM + 32 * wr + 16 * mt + g + 8 * hh) * 4;
          const float tot = (rr[0] + rr[1]) + (rr[2] + rr[3]);
          if (pass == 0)
            mu[mt][hh] = tot / C;
          else
            rs[mt][hh] = rsqrtf(tot / C + eps);
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * NT * wc + 8 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e >= C) continue;
        const float s = ln_s[col + e], b = ln_b[col + e];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float& v = acc[j][mt][2 * hh + e];
            v = fmaf((v - mu[mt][hh]) * rs[mt][hh], s, b);
          }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * NT * wc + 8 * j + 2 * t;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long m = m0 + 32 * wr + 16 * mt + g + 8 * hh;
        if (m >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + e < C)
            out[m * C + col + e] =
                x[m * C + col + e] + res_scale * acc[j][mt][2 * hh + e];
      }
  }
}

template <int WC>
cudaError_t launch_up(const float* tbuf, const float* w1fr, const float* b1,
                      float* h, int Ch, const FfnPlan& p, int mp,
                      cudaStream_t stream) {
  using T = UpTile<WC>;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_up_kernel<WC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(T::kSmemBytes));
  if (err != cudaSuccess) return err;
  ffn_up_kernel<WC><<<dim3(unsigned(p.np1 / T::kBN), unsigned(mp / kUpM)),
                       T::kThreads, T::kSmemBytes, stream>>>(tbuf, w1fr, b1,
                                                             h, Ch, p);
  return cudaGetLastError();
}

template <int NT>
int launch_down(const float* h, const float* w2fr, const float* b2,
                const float* x, const float* ln_s, const float* ln_b,
                float* out, int M, int C, const FfnPlan& p, int prenorm,
                float res_scale, float eps, cudaStream_t stream) {
  using T = DownTile<NT>;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_down_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(T::kSmemBytes));
  if (err != cudaSuccess) return int(err);
  ffn_down_kernel<NT><<<unsigned((M + T::kBM - 1) / T::kBM), T::kThreads,
                        T::kSmemBytes, stream>>>(
      h, w2fr, b2, x, ln_s, ln_b, out, M, C, p, prenorm, res_scale, eps);
  return int(cudaGetLastError());
}

}  // namespace

// Floats of scratch a call needs: W1 and W2 split ([kp1 / 8][np1 / 8][32]
// [4], [kp2 / 8][cp / 8][32][4]), H [Mp][kp2] and T [Mp][kp1] tiled, Mp =
// M rounded up to 128; -1 for a width the kernel has no tile for.
extern "C" long long ff_fused_mlp_scratch_floats(int M, int C, int Ch) {
  const FfnPlan p = ffn_plan(C, Ch);
  if (!p.nt) return -1;
  const long long mp = (M + kUpM - 1LL) / kUpM * kUpM;
  return 2LL * p.kp1 * p.np1 + 2LL * p.kp2 * p.cp + mp * (p.kp2 + p.kp1);
}

// x, out [M, C]; w1 [C, Ch]; b1 [Ch]; w2 [Ch, C]; b2, ln_s, ln_b [C];
// scratch of ff_fused_mlp_scratch_floats(M, C, Ch) floats (16-byte
// aligned). All fp32 contiguous; C <= 384.
extern "C" int ff_fused_mlp(const float* x, const float* w1, const float* b1,
                            const float* w2, const float* b2,
                            const float* ln_s, const float* ln_b, float* out,
                            float* scratch, long long scratch_floats, int M,
                            int C, int Ch, int prenorm, float res_scale,
                            float eps, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const FfnPlan p = ffn_plan(C, Ch);
  if (!p.nt || M <= 0 ||
      scratch_floats < ff_fused_mlp_scratch_floats(M, C, Ch) ||
      reinterpret_cast<size_t>(scratch) % 16 ||
      (M + kUpM - 1) / kUpM > 65535)
    return int(cudaErrorInvalidValue);
  float* w1fr = scratch;
  float* w2fr = w1fr + 2LL * p.kp1 * p.np1;
  const int mp = (M + kUpM - 1) / kUpM * kUpM;
  float* h = w2fr + 2LL * p.kp2 * p.cp;
  float* tbuf = h + (long long)mp * p.kp2;

  ffn_split_weights<<<264, 256, 0, stream>>>(w1, w2, w1fr, w2fr, C, Ch, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  ffn_rows<<<unsigned((mp + 7) / 8), 256, 0, stream>>>(
      x, ln_s, ln_b, tbuf, M, mp, C, p.kp1, prenorm, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  err = p.upn == 128 ? launch_up<2>(tbuf, w1fr, b1, h, Ch, p, mp, stream)
                     : launch_up<1>(tbuf, w1fr, b1, h, Ch, p, mp, stream);
  if (err != cudaSuccess) return int(err);

#define FF_DOWN(N)                                                          \
  if (p.nt == N)                                                            \
    return launch_down<N>(h, w2fr, b2, x, ln_s, ln_b, out, M, C, p, prenorm, \
                          res_scale, eps, stream);
  FF_DOWN(2)
  FF_DOWN(4)
  FF_DOWN(6)
  FF_DOWN(8)
  FF_DOWN(9)
  FF_DOWN(10)
  FF_DOWN(12)
#undef FF_DOWN
  return int(cudaErrorInvalidValue);
}
