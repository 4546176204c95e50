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

#include "bf16_gemm.cuh"
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
// rounded once (:68). Both products run on bf16_gemm.cuh's GEMM, the
// activations through padded bf16 rows in the scratch:
//   1. W1, W2 zero-padded to [kp1][np1] and [kp2][np2] (two launches);
//   2. T = bf16(LN(x)) or x, [M][kp1];
//   3. up:   H = bf16(gelu(T W1 + b1)), [M][kp2];
//   4. down: pre-norm, out = bf16(x + res_scale (H W2 + b2)) in the
//      epilogue; post-norm, y = H W2 + b2 in fp32 [M][C], then
//   5. out = bf16(x + res_scale LN(y)), one warp a row.

namespace {

struct MlpBf16Layout {
  int kp1, np1, kp2, np2;
  long long w1p, w2p, t, h, y, bytes;  // byte offsets into the scratch
};

MlpBf16Layout mlp_bf16_layout(int M, int C, int Ch, int prenorm) {
  MlpBf16Layout l;
  l.kp1 = bg_up(C, kBgK);
  l.np1 = bg_up(Ch, kBgN);
  l.kp2 = bg_up(Ch, kBgK);
  l.np2 = bg_up(C, kBgN);
  l.w1p = 0;
  l.w2p = l.w1p + bg_piece(2LL * l.kp1 * l.np1);
  l.t = l.w2p + bg_piece(2LL * l.kp2 * l.np2);
  l.h = l.t + bg_piece(2LL * M * l.kp1);
  l.y = l.h + bg_piece(2LL * M * l.kp2);
  l.bytes = l.y + (prenorm ? 0 : bg_piece(4LL * M * C));
  return l;
}

struct MlpResidualEpi {  // pre-norm: out = bf16(x + res_scale (v + b2))
  const bf16* x;
  const bf16* b2;
  bf16* out;
  long long M;
  int C;
  float res_scale;
  __device__ __forceinline__ void operator()(long long m, int n, float v0,
                                             float v1) const {
    if (m >= M) return;
    const long long o = m * C + n;
    if (n < C)
      out[o] = bg_round(bg_f(x[o]) + res_scale * (v0 + bg_f(b2[n])));
    if (n + 1 < C)
      out[o + 1] =
          bg_round(bg_f(x[o + 1]) + res_scale * (v1 + bg_f(b2[n + 1])));
  }
};

// post-norm: out[m] = bf16(x[m] + res_scale LN(y[m])), one warp a row
__global__ void __launch_bounds__(256)
mlp_post_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ y,
                     long long M, int C, const bf16* __restrict__ ln_s,
                     const bf16* __restrict__ ln_b, float eps,
                     float res_scale, bf16* __restrict__ out) {
  const long long m = (blockIdx.x * 256LL + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  const float* yr = y + m * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += yr[c];
  const float mu = bg_warp_sum(s) / C;
  float q = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = yr[c] - mu;
    q += d * d;
  }
  const float rs = rsqrtf(bg_warp_sum(q) / C + eps);
  for (int c = lane; c < C; c += 32) {
    const float v = (yr[c] - mu) * rs * bg_f(ln_s[c]) + bg_f(ln_b[c]);
    out[m * C + c] = bg_round(bg_f(x[m * C + c]) + res_scale * v);
  }
}

}  // namespace

// Bytes of scratch a bf16 call needs (see mlp_bf16_layout).
extern "C" long long ff_fused_mlp_bf16_scratch_bytes(int M, int C, int Ch,
                                                     int prenorm) {
  return mlp_bf16_layout(M, C, Ch, prenorm).bytes;
}

// x, out [M, C]; w1 [C, Ch]; b1 [Ch]; w2 [Ch, C]; b2, ln_s, ln_b [C]; all
// bf16 contiguous; scratch of ff_fused_mlp_bf16_scratch_bytes bytes
// (16-byte aligned).
extern "C" int ff_fused_mlp_bf16(const void* x_, const void* w1_,
                                 const void* b1_, const void* w2_,
                                 const void* b2_, const void* ln_s_,
                                 const void* ln_b_, void* out_,
                                 void* scratch_, long long scratch_bytes,
                                 int M, int C, int Ch, int prenorm,
                                 float res_scale, float eps, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* b1 = static_cast<const bf16*>(b1_);
  const bf16* b2 = static_cast<const bf16*>(b2_);
  const bf16* ln_s = static_cast<const bf16*>(ln_s_);
  const bf16* ln_b = static_cast<const bf16*>(ln_b_);
  bf16* out = static_cast<bf16*>(out_);
  char* scratch = static_cast<char*>(scratch_);
  const MlpBf16Layout l = mlp_bf16_layout(M, C, Ch, prenorm);
  if (M <= 0 || C <= 0 || Ch <= 0 || scratch_bytes < l.bytes ||
      reinterpret_cast<size_t>(scratch) % 16)
    return int(cudaErrorInvalidValue);
  bf16* w1p = reinterpret_cast<bf16*>(scratch + l.w1p);
  bf16* w2p = reinterpret_cast<bf16*>(scratch + l.w2p);
  bf16* t = reinterpret_cast<bf16*>(scratch + l.t);
  bf16* h = reinterpret_cast<bf16*>(scratch + l.h);
  float* y = reinterpret_cast<float*>(scratch + l.y);

  cudaError_t err = bg_pad(static_cast<const bf16*>(w1_), Ch, 1, C, l.kp1,
                           Ch, 0, w1p, l.kp1, l.np1, stream);
  if (err == cudaSuccess)
    err = bg_pad(static_cast<const bf16*>(w2_), C, 1, Ch, l.kp2, C, 0, w2p,
                 l.kp2, l.np2, stream);
  if (err == cudaSuccess)
    err = bg_rows(x, M, C, prenorm ? ln_s : nullptr, ln_b, eps, t, l.kp1,
                  stream);
  if (err == cudaSuccess)
    err = bg_gemm(BgRows{t, M, l.kp1}, M, w1p, l.np1, l.kp1, l.np1,
                  BgGeluEpi{b1, h, M, Ch, l.kp2}, stream);
  if (err != cudaSuccess) return int(err);
  if (prenorm)
    return int(bg_gemm(BgRows{h, M, l.kp2}, M, w2p, l.np2, l.kp2, l.np2,
                       MlpResidualEpi{x, b2, out, M, C, res_scale}, stream));
  err = bg_gemm(BgRows{h, M, l.kp2}, M, w2p, l.np2, l.kp2, l.np2,
                BgBiasEpi{b2, y, M, C}, stream);
  if (err != cudaSuccess) return int(err);
  mlp_post_bf16_kernel<<<unsigned((M + 7) / 8), 256, 0, stream>>>(
      x, y, M, C, ln_s, ln_b, eps, res_scale, out);
  return int(cudaGetLastError());
}
