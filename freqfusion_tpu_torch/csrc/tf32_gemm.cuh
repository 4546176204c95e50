// 3xTF32 GEMMs on the tensor cores, each stage a few bulk copies: the
// pieces that the fused FFN (fused_mlp.cu), the NAFBlock (nafblock.cu) and
// the qkv window attention's two projections (window_attention_qkv.cu)
// share, on tf32_mma.cuh's splits, products and copies.
//
// The operands are laid out so that a block's share of a K stage (16
// columns) is a contiguous piece of device memory:
//   - the activations (A) in tiled() order, written so by the launch before
//     (a rows pass, or the producing GEMM's epilogue), zero-padded to whole
//     stages (columns) and 128-row blocks;
//   - the weights (B) split into hi/lo once a call, zero-padded, in
//     fragment order: for each k8 block and n-tile, lane (g, t)'s four
//     values side by side, so a lane reads its whole B fragment with one
//     16-byte load.
// Product<> runs a block of WR x WC warps, each 32 rows (two m-tiles) x 8
// NT columns, over a ring of stages: thread 0 issues a stage as three bulk
// copies (the A tile and two k8 blocks of W) on the stage's mbarrier, one
// barrier a stage keeps the refill behind every warp's reads, and a lane
// splits its A fragment in registers as it reads it. The k8 blocks' K
// order is permuted (fragment column t is column 2t, t + 4 is 2t + 1, in
// W's split as in A's read), so a lane reads its A fragment as two 8-byte
// pairs, and the pairs of a row are swizzled so that a warp's reads hit 32
// distinct banks.
//
// gemm_tf32_kernel<WC, EPI> is the generic product the NAFBlock and #11
// run: 128 rows x 64 WC columns a block (WC 1: 4 warps, three blocks an
// SM; WC 2: 8 warps, two), a four-stage ring, and one of three epilogues:
//   kEpiBias      out = acc + bias, row-major with any row stride;
//   kEpiResidual  out = res + scale * (acc + bias), row-major;
//   kEpiGate      out = (acc_a + bias_a) * (acc_b + bias_b), written in
//                 tiled() order for the next product: the weight's two
//                 halves are interleaved by n-tile (gemm_split_kernel), so
//                 a lane holds output column j of both halves.
// A's rows may come in images of `mpi` rows (a multiple of 128), `hw` of
// them real: a block's rows then lie in one image, whose weight copy it
// reads (the NAFBlock's conv3 takes one scaled W3 an image), and only real
// rows are stored to row-major outputs. Padding rows of A are computed
// (rows never mix in a product) and never stored; padding columns of A
// must be finite (zeros) since they meet zero weight rows.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kBK = 16;  // K columns a stage: two k8 blocks

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

// The activations' tiled layout: row m, column c of a matrix with `ks`
// 16-column stages, in row blocks of `bm` rows, at [m / bm][c / 16]
// [m % bm][16], so that a block's A tile of a stage is one contiguous
// piece (one bulk copy). Within a row the 8 column pairs are swizzled
// (pair p at p ^ 4 on rows with bit 1 set), so that a warp's 8-byte
// fragment reads (rows g, pairs t or 4 + t) hit 32 distinct banks.
__device__ __forceinline__ long long tiled(long long m, int c, int ks,
                                           int bm) {
  const int r = int(m % bm), p = (c % 16) / 2;
  return (((m / bm) * ks + c / 16) * bm + r) * 16 +
         2 * (p ^ (((r >> 1) & 1) << 2)) + c % 2;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Fragment order over [kp / 8][np / 8][32 lanes][4]: unit u is lane (g, t)
// of a (k8 block, n-tile) and holds hi W[2t][g], hi W[2t + 1][g], then the
// two lo. The k8 block's rows are taken in the order 0, 2, 4, 6, 1, 3, 5,
// 7 (fragment row t is row 2t, row t + 4 is row 2t + 1), the order in
// which a lane reads A's columns: two adjacent columns, one 8-byte load.
// frag_unit gives unit u's first row k (it holds k and k + 1) and its
// column n of the padded [kp, np] matrix.
__device__ __forceinline__ void frag_unit(long long u, int np, int& k,
                                          int& n) {
  const int lane = int(u % 32);
  const long long blk = u / 32;
  k = 8 * int(blk / (np / 8)) + 2 * (lane % 4);
  n = 8 * int(blk % (np / 8)) + lane / 4;
}

__device__ __forceinline__ void store_split_unit(float* __restrict__ fr,
                                                 long long u, float v0,
                                                 float v1) {
  uint4 o;
  split_tf32(v0, o.x, o.z);
  split_tf32(v1, o.y, o.w);
  *reinterpret_cast<uint4*>(fr + 4 * u) = o;
}

// The staged product: acc (the warp's two m-tiles x NT n-tiles) = A W[:,
// n0..] over `stages` 16-column stages, A the block's row block of a
// tiled() matrix (stage s at atile + s kBM kBK) and W in fragment order
// with `npt` n-tiles a k8 block. Thread 0 issues each stage as three bulk
// copies on the stage's mbarrier; a barrier a stage keeps the ring's
// refill behind every warp's reads.
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

// ---------------------------------------------------------------------
// The generic GEMM (the NAFBlock's five products, #11's two projections),
// and the weight split and rows pass that feed it and the fused FFN

constexpr int kGemmRows = 128;  // rows a block; A's row blocks and padding

// 128 x 64 WC: 4 warps and three blocks an SM, or 8 warps and two
template <int WC>
using GemmTile = Tile<4, WC, 8, 4, WC == 2 ? 2 : 3>;

// The block width that pads n less (128 on a tie), as
// ops/tf32_gemm.py:plan_gemm picks it.
inline int gemm_cols(int n) {
  return (n + 63) / 64 * 64 < (n + 127) / 128 * 128 ? 64 : 128;
}

inline long long round_up(long long v, long long m) {
  return (v + m - 1) / m * m;
}

enum { kEpiBias = 0, kEpiResidual = 1, kEpiGate = 2 };

struct GemmArgs {
  const float* a;       // tiled() [images * mpi, kp], kGemmRows-row blocks
  const float* w;       // fragment order [kp / 8][np / 8][32][4]
  long long w_image;    // floats between images' weight copies (0: shared)
  int kp, np, n;        // K (a multiple of kBK), padded N, output columns
  int mpi, hw;          // A's rows an image (a multiple of 128), real rows
  const float* bias;    // [n]; kEpiGate: [2 n], the b half at + n
  float* out;           // row-major [images * hw, ldc]; kEpiGate: tiled()
  int ldc;              // kEpiGate: the tiled output's columns (kp's)
  const float* res;     // kEpiResidual: [images * hw, ldc]
  const float* scale;   // kEpiResidual: [n]
};

// The weights' split (gemm_split_kernel): job j's W [K, ldw] (row-major,
// its first N columns; kEpiGate's: columns j and N + j, interleaved by
// n-tile: n-tile 2i holds columns 8i.., 2i + 1 columns N + 8i..), each
// row k scaled by rowscale[copy][k] where given, into `copies` fragment
// copies of units a copy (kp / 8 * np / 8 * 32) each.
struct SplitJob {
  const float* w;
  const float* rowscale;  // [copies, K] or null
  float* fr;
  int K, N, ldw, np, gate, copies;
  long long units;
};

template <int J>
struct SplitJobs {
  SplitJob job[J];
};

template <int J>
__global__ void __launch_bounds__(256) gemm_split_kernel(SplitJobs<J> jobs) {
  long long base[J + 1];
  base[0] = 0;
#pragma unroll
  for (int j = 0; j < J; ++j)
    base[j + 1] = base[j] + jobs.job[j].units * jobs.job[j].copies;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < base[J];
       i += gridDim.x * 256LL) {
    int j = 0;
#pragma unroll
    for (int q = 1; q < J; ++q) j += i >= base[q];
    const SplitJob& s = jobs.job[j];
    const long long local = i - base[j];
    const int copy = int(local / s.units);
    const long long u = local % s.units;
    int k, n;
    frag_unit(u, s.np, k, n);
    int col = n;
    bool ok = n < s.N;
    if (s.gate) {
      const int nt = n / 8, c = 8 * (nt / 2) + n % 8;
      ok = c < s.N;
      col = c + (nt % 2) * s.N;
    }
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kk = k + e;
      v[e] = ok && kk < s.K ? s.w[(long long)kk * s.ldw + col] : 0.f;
      if (s.rowscale && ok && kk < s.K)
        v[e] *= s.rowscale[(long long)copy * s.K + kk];
    }
    store_split_unit(s.fr + copy * s.units * 4, u, v[0], v[1]);
  }
}

template <int J>
cudaError_t gemm_split(const SplitJobs<J>& jobs, cudaStream_t stream) {
  gemm_split_kernel<J><<<264, 256, 0, stream>>>(jobs);
  return cudaGetLastError();
}

constexpr int kGemmMaxC = 2048;  // gemm_rows: a row in a warp's registers

// A in tiled() order from row-major rows: out[tiled(m, c)] = LN(x[row])
// (ln_s given) or x[row], for the images * mpi rows m of A (image m /
// mpi, pixel m % mpi; rows past hw and columns past C are zeros), kp
// columns. One warp a row, held in registers (C <= 32 V).
template <int V>
__global__ void __launch_bounds__(256)
gemm_rows_kernel(const float* __restrict__ x, int ldx,
                 const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, float eps,
                 float* __restrict__ out, long long rows, int mpi, int hw,
                 int C, int kp) {
  const long long m = (blockIdx.x * 256LL + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (m >= rows) return;
  const long long img = m / mpi;
  const int pix = int(m % mpi);
  const int cv = pix < hw ? C : 0;  // padding rows are zeros
  const float* xr = x + (img * hw + (pix < hw ? pix : 0)) * ldx;
  float v[V];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < cv ? xr[c] : 0.f;
    s += v[i];
  }
  float mu = 0.f, rs = 1.f;
  if (ln_s) {
    mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = lane + 32 * i < C ? v[i] - mu : 0.f;
      q += d * d;
    }
    rs = rsqrtf(warp_sum(q) / C + eps);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    if (c < kp)
      out[tiled(m, c, kp / kBK, kGemmRows)] =
          c >= cv ? 0.f
          : ln_s  ? fmaf((v[i] - mu) * rs, ln_s[c], ln_b[c])
                  : v[i];
  }
}

// rows of C <= kGemmMaxC channels into A's tiled order, LayerNorm'd where
// ln_s is given: gemm_rows<2>(...) takes the narrowest V (2, 4, .., 64)
// that holds C
template <int V>
cudaError_t gemm_rows(const float* x, int ldx, const float* ln_s,
                      const float* ln_b, float eps, float* out, int images,
                      int mpi, int hw, int C, int kp, cudaStream_t stream) {
  if constexpr (32 * V < kGemmMaxC) {
    if (C > 32 * V)
      return gemm_rows<2 * V>(x, ldx, ln_s, ln_b, eps, out, images, mpi, hw,
                              C, kp, stream);
  }
  const long long rows = (long long)images * mpi;
  const long long blocks = (rows + 7) / 8;
  if (C > 32 * V || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gemm_rows_kernel<V><<<unsigned(blocks), 256, 0, stream>>>(
      x, ldx, ln_s, ln_b, eps, out, rows, mpi, hw, C, kp);
  return cudaGetLastError();
}

template <int WC, int EPI>
__global__ void __launch_bounds__(GemmTile<WC>::kThreads,
                                  GemmTile<WC>::kMinBlocks)
gemm_tf32_kernel(GemmArgs p) {
  using T = GemmTile<WC>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = warp / WC, wc = warp % WC;
  const int nblocks = p.np / T::kBN;
  const long long m0 = (long long)(blockIdx.x / nblocks) * kGemmRows;
  const int n0 = int(blockIdx.x % nblocks) * T::kBN;
  const long long img = m0 / p.mpi;
  float acc[8][2][4];
  Product<T, 8>::run(acc, smem, p.a + m0 * p.kp, p.kp / kBK,
                     p.w + img * p.w_image, p.np / 8, n0);

  if constexpr (EPI == kEpiGate) {
    // n-tiles j and j + 1 hold output columns c0 + 2t + e of the two
    // halves: c0 = (n0 + 64 wc) / 2 + 4 j
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int c = (n0 + 64 * wc) / 2 + 4 * j + 2 * t;
      if (c >= p.ldc) continue;
      float ba[2], bb[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ba[e] = c + e < p.n ? p.bias[c + e] : 0.f;
        bb[e] = c + e < p.n ? p.bias[p.n + c + e] : 0.f;
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long m = m0 + 32 * wr + 16 * mt + g + 8 * hh;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = c + e < p.n ? (acc[j][mt][2 * hh + e] + ba[e]) *
                                     (acc[j + 1][mt][2 * hh + e] + bb[e])
                               : 0.f;
          *reinterpret_cast<float2*>(
              p.out + tiled(m, c, p.ldc / kBK, kGemmRows)) =
              make_float2(v[0], v[1]);
        }
    }
  } else {
    const bool pairs = p.ldc % 2 == 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 64 * wc + 8 * j + 2 * t;
      if (col >= p.n) continue;
      const bool two = col + 1 < p.n;
      const float b0 = p.bias[col], b1 = two ? p.bias[col + 1] : 0.f;
      float s0 = 0.f, s1 = 0.f;
      if constexpr (EPI == kEpiResidual) {
        s0 = p.scale[col];
        s1 = two ? p.scale[col + 1] : 0.f;
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int pix =
              int(m0 - img * p.mpi) + 32 * wr + 16 * mt + g + 8 * hh;
          if (pix >= p.hw) continue;
          const long long o = (img * p.hw + pix) * p.ldc + col;
          float v0 = acc[j][mt][2 * hh] + b0, v1 = acc[j][mt][2 * hh + 1] + b1;
          if constexpr (EPI == kEpiResidual) {
            v0 = fmaf(s0, v0, p.res[o]);
            if (two) v1 = fmaf(s1, v1, p.res[o + 1]);
          }
          if (two && pairs) {
            *reinterpret_cast<float2*>(p.out + o) = make_float2(v0, v1);
          } else {
            p.out[o] = v0;
            if (two) p.out[o + 1] = v1;
          }
        }
    }
  }
}

template <int WC, int EPI>
cudaError_t gemm_launch_wc(const GemmArgs& a, int images,
                           cudaStream_t stream) {
  using T = GemmTile<WC>;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_tf32_kernel<WC, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(T::kSmemBytes));
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)images * (a.mpi / kGemmRows) * (a.np / T::kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gemm_tf32_kernel<WC, EPI>
      <<<unsigned(blocks), T::kThreads, T::kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// out (EPI) = A W over `images` images of a.mpi rows; a.np is the
// product's width (n, or 2 kp for the gate) rounded up to gemm_cols of it,
// a multiple of 128 exactly where that picks 128.
template <int EPI>
cudaError_t gemm_launch(const GemmArgs& a, int images, cudaStream_t stream) {
  const int cols = a.np % 128 ? 64 : 128;
  if (a.kp % kBK || a.mpi % kGemmRows || a.np % cols ||
      reinterpret_cast<size_t>(a.a) % 16 || reinterpret_cast<size_t>(a.w) % 16)
    return cudaErrorInvalidValue;
  return cols == 128 ? gemm_launch_wc<2, EPI>(a, images, stream)
                     : gemm_launch_wc<1, EPI>(a, images, stream);
}

}  // namespace
