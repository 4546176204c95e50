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
//      a lane's whole B fragment (hi and lo) with one 16-byte load
//      (tf32_gemm.cuh's gemm_split, two jobs);
//   2. T = LN(x) (pre-norm) or x, zero-padded to kp1 columns, tiled
//      (tf32_gemm.cuh's gemm_rows);
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
// Both products run one pipeline (tf32_gemm.cuh's Tile, tiled() layout,
// fragment order and Product, which the NAFBlock's and #11's GEMMs share):
// 8 warps a block (4 for the 64-column up
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

#include "bf16_wgmma.cuh"
#include "tf32_gemm.cuh"

namespace {

// up: rows a block (T's and H's row padding), as gemm_rows pads them
constexpr int kUpM = kGemmRows;

// up: 128 x 128 (8 warps, two blocks an SM), or 128 x 64 (4 warps, three
// blocks an SM) where that pads Ch less (Ch 276, 308)
template <int WC>
using UpTile = Tile<4, WC, 8, 4, WC == 2 ? 2 : 3>;

template <int NT>  // 64 x 32 NT; wider than 8, one block an SM
using DownTile = Tile<2, 4, NT, 3, NT <= 8 ? 2 : 1>;

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

  // 1. W1 and W2 into fragment order
  const SplitJobs<2> jobs{
      {SplitJob{w1, nullptr, w1fr, C, Ch, Ch, p.np1, 0, 1,
                (long long)p.kp1 / 8 * (p.np1 / 8) * 32},
       SplitJob{w2, nullptr, w2fr, Ch, C, C, p.cp, 0, 1,
                (long long)p.kp2 / 8 * (p.cp / 8) * 32}}};
  cudaError_t err = gemm_split(jobs, stream);
  if (err != cudaSuccess) return int(err);
  // 2. T = LN(x) (pre-norm) or x, zero-padded to kp1 columns and mp rows,
  // tiled: the up product's A
  err = gemm_rows<2>(x, C, prenorm ? ln_s : nullptr, ln_b, eps, tbuf, 1, mp,
                     M, C, p.kp1, stream);
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


// ---------------------------------------------------------------------
// The bf16 version (FREQFUSION_EXPERT_DTYPE=bf16): x, the weights and the
// vectors bf16, with the JAX kernel's rounding points (pallas_mlp.py:
// _kernel, :53-68): LN in fp32 and T rounded to bf16 (:58), h = T W1 in
// fp32 plus b1 and the exact GELU in fp32, rounded (:62), y = h W2 + b2 in
// fp32 (post-norm: a second LN in fp32), the output x + res_scale y
// rounded once (:68).
//
// What bounds it on the H100: the two products (4 C Ch FLOPs a row, 539
// GFLOP over chip_smoke.py's six shapes: 0.55 ms at 989 TFLOP/s) against
// x in and out (4 C bytes a row). Two launches, both on bf16_wgmma.cuh's
// wgmma (the weights laid out once per module by ops/wgmma.py and
// streamed by a producer warp's bulk copies through an mbarrier ring):
//   up    64 rows a block (one consumer warpgroup, two blocks an SM):
//         x's rows staged once in the core-matrix order, LN in fp32 in
//         shared memory (bw_ln_inplace) and rounded; then every chunk of
//         BN1 hidden columns (64, 96 or 128, the one padding Ch least): +
//         b1, GELU, rounded, into a shared tile in the order the down
//         launch reads (bw_tiled_off: for 128 rows and each 32 of K, 8 KB;
//         a 64-row block's part is 2 KB pieces), out by bulk stores (two
//         tiles in turn). The exact-erf GELU is the launch's largest cost
//         beside its products (~0.19 ms at C 244, Ch 976 on an H100 at 700
//         W, issue-bound on the fp32 cores: csrc/bench/wgmma_variants.py
//         --ffn-cab); two
//         blocks an SM, or two warpgroups taking turns on the tensor
//         cores, did not hide it;
//   down  128 rows x all of C a block: H streamed (8 KB a stage) with
//         W2's NCH chunks of BN2 columns (NCH BN2 / 2 <= 160 sums a
//         thread), so that each row's C sums sit in one quad of lanes and
//         the post-norm LN needs only shuffles; x's 128 rows arrive as one
//         bulk copy into shared memory, the output is written over them
//         and leaves as one bulk store (a ragged last block, or x or out
//         not 16-byte aligned, goes value pair by pair).
// H goes through device memory in bf16 (4 Ch bytes a row, written and
// read): kept on chip, a 128-row block would hold x's rows, a hidden chunk
// and a C-wide sum through the whole Ch loop, one block an SM with the
// up and down products in one dependent chain.

namespace {

constexpr int kFfRows = 128;     // rows a block (two consumer warpgroups)
constexpr int kFfThreads = 256;  // two consumer warpgroups
constexpr int kFfDownThreads = 384;  // the down launch: + a producer warpgroup
constexpr int kFfDownStages = 4;
constexpr int kFfUpRows = 64;      // the up launch: one consumer warpgroup
constexpr int kFfUpThreads = 160;  // ... and a producer warp
constexpr int kFfUpStages = 4;     // its weight ring
constexpr int kFfMaxC = 320;     // NCH BN2 of the widest down instantiation

// The up launch's hidden chunk: the least padding of Ch among 128, 96 and
// 64, the wider on a tie (ops/wgmma.py:ffn_up_cols).
inline int ffn_up_cols(int ch) {
  const int opts[] = {96, 64};
  int best = 128;
  for (int bn : opts)
    if (bw_up(ch, bn) < bw_up(ch, best)) best = bn;
  return best;
}

// The down launch's chunks (BN2, NCH): the least padding of C with at most
// 160 sums a thread, the wider BN2 on a tie (ops/wgmma.py:ffn_down_cols).
inline void ffn_down_cols(int c, int& bn, int& nch) {
  const int opts[] = {128, 96, 64};
  bn = nch = 0;
  for (int b : opts) {
    const int n = (c + b - 1) / b;
    if (n * b / 2 > 160) continue;
    if (!bn || n * b < nch * bn) bn = b, nch = n;
  }
}

inline int ffn_up_smem(int C, int Ch) {
  const int bn = ffn_up_cols(Ch), kp1 = bw_up(C, kBwK);
  return kBwHead + kFfUpStages * bn * 64 + kFfUpRows * kp1 * 2 +
         2 * kFfUpRows * bn * 2 + bw_up(Ch, bn) * 4 + kFfUpRows * 8 +
         2 * kp1 * 4;
}

inline int ffn_down_smem(int C) {
  int bn, nch;
  ffn_down_cols(C, bn, nch);
  return kBwHead + kFfDownStages * (8192 + nch * bn * 64) + kFfRows * C * 2 +
         3 * nch * bn * 4 + 8;
}

struct FfUpArgs {
  const __nv_bfloat16* x;  // [M, C]
  const void* w1;          // W1's layout: nch chunks x kp1 / 32 stages
  const __nv_bfloat16* b1;
  const __nv_bfloat16 *ln_s, *ln_b;  // [C], or null (post-norm: T = x)
  unsigned char* h;        // [Mp / 128][kp2 / 32][8 KB] (bw_tiled_off)
  long long M;
  int C, Ch, kp1, kp2, nch;
  float eps;
};

// H[m0 .. + 64, :] = bf16(gelu(T W1 + b1)), T = bf16(LN(x)) or x: one
// consumer warpgroup, two blocks an SM, so that one block's staging and
// GELU epilogue can run while the other's wgmmas do. A chunk's 64 rows
// leave as 2 KB pieces (a 16-column half of a k32 stage of the 128-row
// tiled order) by bulk stores, from two tiles in turn.
template <int BN>
__global__ void __launch_bounds__(kFfUpThreads, 2)
ffn_up_wgmma_kernel(const FfUpArgs a) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  constexpr int kRows = kFfUpRows, kThreads = kFfUpThreads - 32;
  constexpr int kTile = kRows * BN * 2;
  BwRing r = bw_ring(ff_smem, BN * 64, kThreads / 32, kFfUpStages);
  unsigned char* as = ff_smem + kBwHead + kFfUpStages * BN * 64;
  unsigned char* tiles = as + kRows * a.kp1 * 2;
  float* b1s = reinterpret_cast<float*>(tiles + 2 * kTile);
  float2* stats = reinterpret_cast<float2*>(b1s + a.nch * BN);
  float* lns = reinterpret_cast<float*>(stats + kRows);
  float* lnb = lns + a.kp1;
  __syncthreads();
  const int tid = threadIdx.x;
  const int nst = a.kp1 / kBwK;
  if (tid >= kThreads) {
    if (tid == kThreads) bw_produce(r, a.w1, a.nch * nst);
    return;
  }
  const long long m0 = (long long)blockIdx.x * kRows;
  bw_vector(b1s, a.b1, a.Ch, a.nch * BN, tid, kThreads);
  if (a.ln_s) {
    bw_vector(lns, a.ln_s, a.C, a.kp1, tid, kThreads);
    bw_vector(lnb, a.ln_b, a.C, a.kp1, tid, kThreads);
  }
  BwRows{a.x, a.M, a.C}.stage(as, nullptr, m0, kRows, a.kp1, tid, kThreads);
  if (a.ln_s) {
    bw_sync(kThreads);
    bw_ln_inplace(as, stats, kRows, a.kp1, a.C, a.eps, lns, lnb, tid,
                  kThreads, [&](int row) { return m0 + row < a.M; });
  }
  fence_proxy_async();  // the staged A, before wgmma reads it
  bw_sync(kThreads);
  // this block's rows in H's 128-row tiled order: a half of each k16 piece
  unsigned char* h0 = a.h + (m0 >> 7) * (a.kp2 / kBwK) * 8192LL +
                      ((m0 >> 6) & 1) * 2048;
  for (int c = 0; c < a.nch; ++c) {
    float acc[BN / 2];
    bw_chunk<BN>(acc, as, kRows, nst, r);
    bw_sync(kThreads);  // the store two chunks back has read the tile
    unsigned char* tile = tiles + (c & 1) * kTile;
    bw_each<BN>(acc, [&](int row, int col, float v0, float v1) {
      const int n = c * BN + col;
      *reinterpret_cast<uint32_t*>(
          tile + (col >> 5) * 4096 + bw_a_off(row, (col & 31) >> 3, kRows) +
          (col & 7) * 2) = pack_bf16(gelu_erf(v0 + b1s[n]),
                                     gelu_erf(v1 + b1s[n + 1]));
    });
    fence_proxy_async();
    bw_sync(kThreads);
    if (tid == 0) {
      // H's columns stop at kp2; 2 KB a 16 columns of these rows
      const int pieces = 2 * (min(BN, a.kp2 - c * BN) / kBwK);
      for (int i = 0; i < pieces; ++i)
        bw_store(h0 + ((long long)c * (BN / kBwK) * 2 + i) * 4096,
                 tile + i * 2048, 2048);
      bw_store_commit();
      bw_store_wait_read<1>();  // the other tile is free again
    }
  }
  if (tid == 0) bw_store_wait<0>();
}

struct FfDownArgs {
  const unsigned char* h;  // [Mp / 128][kp2 / 32][8 KB]
  const void* w2;          // W2's layout: NCH chunks x kp2 / 32 stages
  const __nv_bfloat16 *b2, *ln_s, *ln_b, *x;
  __nv_bfloat16* out;
  long long M;
  int C, kp2, post, bulk;  // bulk: x and out 16-byte aligned
  float res_scale, eps;
};

// out[m0 .. + 128, :] = bf16(x + res_scale (LN)(H W2 + b2)). Three
// warpgroups: two consumers (rows 0-63, 64-127) at 232 registers a thread,
// the producer's (one thread issues) at 40, so that C's sums (up to 160 a
// thread) stay in registers.
template <int BN, int NCH>
__global__ void __launch_bounds__(kFfDownThreads, 1)
ffn_down_wgmma_kernel(const FfDownArgs a) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  constexpr int kStage = 8192 + NCH * BN * 64, kNp = NCH * BN;
  const int C = a.C, nst = a.kp2 / kBwK;
  BwRing r = bw_ring(ff_smem, kStage, kFfThreads / 32, kFfDownStages);
  unsigned char* xs = r.buf + kFfDownStages * kStage;  // x, then out
  float* vs = reinterpret_cast<float*>(xs + kFfRows * C * 2);  // b2 | s | b
  uint64_t* xbar = reinterpret_cast<uint64_t*>(vs + 3 * kNp);
  const long long m0 = (long long)blockIdx.x * kFfRows;
  const bool whole = a.bulk && m0 + kFfRows <= a.M;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(xbar, 1);
    mbar_init_fence();
  }
  if (tid < kFfThreads) {
    bw_vector(vs, a.b2, C, kNp, tid, kFfThreads);
    if (a.post) {
      bw_vector(vs + kNp, a.ln_s, C, kNp, tid, kFfThreads);
      bw_vector(vs + 2 * kNp, a.ln_b, C, kNp, tid, kFfThreads);
    }
  }
  __syncthreads();
  if (tid >= kFfThreads) {
    bw_regs_dec<40>();
    if (tid == kFfThreads) {
      if (whole) {  // x's 128 rows: one contiguous piece
        mbar_arrive_expect_tx(xbar, kFfRows * C * 2);
        bulk_copy(xs, a.x + m0 * C, kFfRows * C * 2, xbar);
      }
      const unsigned char* hb = a.h + blockIdx.x * 8192LL * nst;
      const unsigned char* w = static_cast<const unsigned char*>(a.w2);
      for (int s = 0; s < nst; ++s, ++r.it) {
        const int slot = r.it % r.stages;
        mbar_wait(&r.empty[slot], ((r.it / r.stages) & 1) ^ 1);
        mbar_arrive_expect_tx(&r.full[slot], kStage);
        unsigned char* dst = r.buf + slot * kStage;
        bulk_copy(dst, hb + s * 8192LL, 8192, &r.full[slot]);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          bulk_copy(dst + 8192 + c * BN * 64,
                    w + ((long long)c * nst + s) * BN * 64, BN * 64,
                    &r.full[slot]);
      }
    }
    return;
  }
  bw_regs_inc<232>();
  const int lane = tid & 31, wg = tid >> 7, t = lane & 3;
  // the sums start at b2 (zero past C): v = H W2 + b2 when the loop ends
  float acc[NCH][BN / 2];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      acc[c][i] = vs[c * BN + 8 * (i >> 2) + 2 * t + (i & 1)];
    bw_fence_acc(acc[c]);
  }
  for (int s = 0; s < nst; ++s) {
    const int slot = s % r.stages;
    mbar_wait(&r.full[slot], (s / r.stages) & 1);
    bw_fence();
    const unsigned char* st = r.buf + slot * kStage;
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        bw_mma<BN>(acc[c], bw_desc(st + k * 4096 + wg * 2048),
                   bw_desc(st + 8192 + c * BN * 64 + k * BN * 32), 1);
    bw_commit();
    if (s > 0) {  // the stage before this one is read: release it
      bw_wait<1>();
      if (lane == 0) mbar_arrive(&r.empty[(s - 1) % r.stages]);
    }
  }
  bw_wait<0>();
#pragma unroll
  for (int c = 0; c < NCH; ++c) bw_fence_acc(acc[c]);

  if (a.post) {  // LN over C of rows lane / 4 (h 0) and + 8 (h 1): a quad
    float mu[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mu[(i >> 1) & 1] += acc[c][i];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mu[hh] += __shfl_xor_sync(~0u, mu[hh], 1);
      mu[hh] += __shfl_xor_sync(~0u, mu[hh], 2);
      mu[hh] /= C;
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = c * BN + 8 * (i >> 2) + 2 * t + (i & 1);
        const float d = col < C ? acc[c][i] - mu[(i >> 1) & 1] : 0.f;
        rs[(i >> 1) & 1] += d * d;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(~0u, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(~0u, rs[hh], 2);
      rs[hh] = rsqrtf(rs[hh] / C + a.eps);
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = c * BN + 8 * (i >> 2) + 2 * t + (i & 1);
        const int hh = (i >> 1) & 1;
        acc[c][i] = (acc[c][i] - mu[hh]) * rs[hh] * vs[kNp + col] +
                    vs[2 * kNp + col];
      }
      asm volatile("" ::: "memory");  // a chunk's loads at a time
    }
  }
  if (whole) mbar_wait(xbar, 0);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    bw_frag<BN>([&](int j, int hh, int row, int col0) {
      const int col = c * BN + col0;
      if (col >= C) return;  // C even: col + 1 < C too
      const float v0 = acc[c][4 * j + 2 * hh], v1 = acc[c][4 * j + 2 * hh + 1];
      if (whole) {
        uint32_t* p =
            reinterpret_cast<uint32_t*>(xs + ((long long)row * C + col) * 2);
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(p));
        *p = pack_bf16(xv.x + a.res_scale * v0, xv.y + a.res_scale * v1);
      } else if (m0 + row < a.M) {
        const long long o = (m0 + row) * C + col;
        a.out[o] = __float2bfloat16_rn(bw_f(a.x[o]) + a.res_scale * v0);
        a.out[o + 1] =
            __float2bfloat16_rn(bw_f(a.x[o + 1]) + a.res_scale * v1);
      }
    });
    asm volatile("" ::: "memory");  // a chunk's loads at a time
  }
  if (whole) {
    fence_proxy_async();
    bw_sync(kFfThreads);
    if (tid == 0) {
      bw_store(a.out + m0 * C, xs, kFfRows * C * 2);
      bw_store_commit();
      bw_store_wait<0>();
    }
  }
}

template <int BN>
cudaError_t ffn_up(const FfUpArgs& a, int smem, unsigned blocks,
                   cudaStream_t stream) {
  static int allowed[64] = {};
  cudaError_t err = bw_allow(ffn_up_wgmma_kernel<BN>, smem, allowed);
  if (err != cudaSuccess) return err;
  ffn_up_wgmma_kernel<BN><<<2 * blocks, kFfUpThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BN, int NCH>
cudaError_t ffn_down(const FfDownArgs& a, int smem, unsigned blocks,
                     cudaStream_t stream) {
  static int allowed[64] = {};
  cudaError_t err = bw_allow(ffn_down_wgmma_kernel<BN, NCH>, smem, allowed);
  if (err != cudaSuccess) return err;
  ffn_down_wgmma_kernel<BN, NCH>
      <<<blocks, kFfDownThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool ffn_bf16_refused(long long M, int C, int Ch) {
  return M <= 0 || C <= 0 || Ch <= 0 || C % 2 || C > kFfMaxC ||
         ffn_up_smem(C, Ch) > 227 * 1024 || (M + kFfRows - 1) / kFfRows >
         0x7fffffffLL;
}

}  // namespace

// Bytes of scratch a bf16 call needs: H in the tiled order, M rounded up
// to 128 rows and Ch to 32 columns; -1 for a width the kernels refuse (C
// odd or above 320).
extern "C" long long ff_fused_mlp_bf16_scratch_bytes(long long M, int C,
                                                     int Ch) {
  if (ffn_bf16_refused(M, C, Ch)) return -1;
  return (M + kFfRows - 1) / kFfRows * kFfRows * bw_up(Ch, kBwK) * 2;
}

// Dynamic shared memory of a block of the up (down = 0) or the down launch
// (ops/wgmma.py:plan_ffn_bf16 computes the same).
extern "C" int ff_fused_mlp_bf16_smem(int C, int Ch, int down) {
  return down ? ffn_down_smem(C) : ffn_up_smem(C, Ch);
}

// x, out [M, C] bf16 (C even, at most 320); w1l, w2l: W1 [C, Ch] and W2
// [Ch, C] in wgmma's order (ops/wgmma.py:weight_layout, at bn1 =
// ffn_up_cols(Ch) and bn2 of ffn_down_cols(C)), 16-byte aligned; b1 [Ch],
// b2, ln_s, ln_b [C] bf16; scratch of ff_fused_mlp_bf16_scratch_bytes
// bytes, 16-byte aligned.
extern "C" int ff_fused_mlp_bf16(const void* x, const void* w1l,
                                 const void* b1, const void* w2l,
                                 const void* b2, const void* ln_s,
                                 const void* ln_b, void* out, void* scratch,
                                 long long scratch_bytes, long long M, int C,
                                 int Ch, int bn1, int bn2, int prenorm,
                                 float res_scale, float eps, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  int bn, nch;
  ffn_down_cols(C, bn, nch);
  if (ffn_bf16_refused(M, C, Ch) || bn1 != ffn_up_cols(Ch) || bn2 != bn ||
      scratch_bytes < ff_fused_mlp_bf16_scratch_bytes(M, C, Ch) ||
      (reinterpret_cast<size_t>(scratch) | reinterpret_cast<size_t>(w1l) |
       reinterpret_cast<size_t>(w2l)) % 16)
    return int(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const unsigned blocks = unsigned((M + kFfRows - 1) / kFfRows);
  const int kp1 = bw_up(C, kBwK), kp2 = bw_up(Ch, kBwK);
  unsigned char* h = static_cast<unsigned char*>(scratch);
  const FfUpArgs up{static_cast<const bf*>(x), w1l, static_cast<const bf*>(b1),
                    prenorm ? static_cast<const bf*>(ln_s) : nullptr,
                    static_cast<const bf*>(ln_b), h, M, C, Ch, kp1, kp2,
                    (Ch + bn1 - 1) / bn1, eps};
  const int up_smem = ffn_up_smem(C, Ch);
  cudaError_t err = bn1 == 128 ? ffn_up<128>(up, up_smem, blocks, stream)
                    : bn1 == 96 ? ffn_up<96>(up, up_smem, blocks, stream)
                                : ffn_up<64>(up, up_smem, blocks, stream);
  if (err != cudaSuccess) return int(err);
  const int bulk = ((reinterpret_cast<size_t>(x) |
                     reinterpret_cast<size_t>(out)) % 16) == 0;
  const FfDownArgs down{h, w2l, static_cast<const bf*>(b2),
                        static_cast<const bf*>(ln_s),
                        static_cast<const bf*>(ln_b),
                        static_cast<const bf*>(x), static_cast<bf*>(out), M, C,
                        kp2, !prenorm, bulk, res_scale, eps};
  const int down_smem = ffn_down_smem(C);
#define FF_DOWN_BF16(B, N)                                         \
  if (bn == B && nch == N)                                         \
    return int(ffn_down<B, N>(down, down_smem, blocks, stream));
  FF_DOWN_BF16(64, 1)
  FF_DOWN_BF16(96, 1)
  FF_DOWN_BF16(128, 1)
  FF_DOWN_BF16(96, 2)
  FF_DOWN_BF16(128, 2)
  FF_DOWN_BF16(96, 3)
  FF_DOWN_BF16(64, 5)
#undef FF_DOWN_BF16
  return int(cudaErrorInvalidValue);
}
