// A whole NAFBlock over NHWC rows, fp32 (NAFNet-SIDD-64, widths 64..1024):
//   u   = LN1(x) W1 + b1                         C -> 2C    (eps 1e-6)
//   g   = (dw3x3(u)[:C] + d[:C]) * (dw3x3(u)[C:] + d[C:])   SimpleGate
//   s   = Wsca mean_hw(g) + bsca                  SCA, [B, C]
//   y   = x + beta * ((g * s) W3 + b3)
//   g2  = (LN2(y) W4 + b4)[:C] * (LN2(y) W4 + b4)[C:]
//   out = y + gamma * (g2 W5 + b5)
// with zero padding for the depthwise conv at the image edges.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_nafblock.py:
// nafblock_fused (:231), which FREQFUSION_NAFBLOCK=1 routes all 36
// NAFBlocks through (freqfusion_tpu/models/nafnet.py:108).
//
// What bounds it on the H100: the five 1x1 products, 12 C^2 FLOPs a pixel,
// 1.35e11 per block at every level (C 64 at 1344x2048 up to C 1024 at
// 84x128): 2.0 ms on the fp32 cores (67 TFLOP/s), 0.82 ms as 3xTF32 on the
// tensor cores (three TF32 products an fp32 one at 495 TFLOP/s). The
// byte floor (x in, out out: 8 C bytes a pixel) is 0.42 ms at level 1.
// The products run in 3xTF32 (tf32_gemm.cuh, as the fused FFN's): x = hi
// + lo, lo*hi + hi*lo + hi*hi on mma.sync, fp32 accumulation; one TF32
// product misses the fp32 tolerance at K up to 1024.
//
// Design: nine launches over [P, C] rows (P = B H W), none a library call;
// the [B, C] SCA product runs between the two entries, in PyTorch, as the
// JAX wrapper runs it between its two Pallas calls.
//   pass A  1. split W1, W4 and W5 into hi/lo fragment order (W4's two
//              halves interleaved by n-tile, so a lane holds column j of
//              both: the gate runs in the product's epilogue);
//           2. T1 = LN1(x), tiled (each row's statistics once);
//           3. conv1: u = T1 W1 + b1, row-major [P, 2C];
//           4. gate: the depthwise 3x3 on both halves, SimpleGate, g
//              written tiled for conv3, and the SCA pool's per-tile
//              channel sums;
//   pass B  5. split W3 with its rows scaled by s, one copy an image:
//              (g * s_b) W3 = g (diag(s_b) W3), so conv3 has no prologue;
//           6. conv3: y = x + beta * (g W3_b + b3), row-major;
//           7. T2 = LN2(y), tiled;
//           8. conv4, gated: g2 = (T2 W4a + b4a) * (T2 W4b + b4b), tiled;
//           9. conv5: out = y + gamma * (g2 W5 + b5).
// The products' A operands are tiled with each image's rows padded to 128,
// so a conv3 block's rows lie in one image and read that image's W3.
// Device memory a pixel: 4 (10 C + 8 kp) bytes (kp = C rounded up to 16;
// 72 C at NAFNet's widths) against the 8 C of the bound; at level 1 (C 64,
// 2.75 M pixels) 12.7 GB, 3.8 ms at 3.35 TB/s, so levels 1-2 are bound by
// the passes' bytes and levels 3-5 by the products. Keeping u or g on chip
// would need conv1's output for a tile plus its halo (the depthwise conv)
// or g recomputed in pass B (4 C^2 (1 + halo) FLOPs a pixel more); both
// are left for a later version.

#include <cuda_runtime.h>
#include <math.h>

#include "bf16_gemm.cuh"
#include "tf32_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGateRun = 8;   // output rows per thread in the gate kernel
constexpr int kGateCols = 8;  // tile columns per gate block
constexpr int kGateCh = 32;   // channels per gate block

// Padded extents and the scratch's layout, as ops/nafblock.py:
// plan_nafblock computes them.
struct NafPlan {
  int kp;         // C rounded up to kBK: every product's K, A's columns
  int mpi;        // H W rounded up to 128: A's rows an image
  int np1;        // conv1's N (2C) padded to its block width
  int np3;        // conv3's and conv5's (C)
  int np4;        // conv4's, the two halves interleaved (2 kp)
  long long w1, w4, w5, w3;  // floats of each split (W3's: one copy)
  long long a;    // floats of a tiled A buffer (B mpi kp)
  long long rows; // floats of the row-major u (pass A) / y (pass B)
  long long total;
};

NafPlan naf_plan(int hw, int C, int B) {
  NafPlan p;
  p.kp = int(round_up(C, kBK));
  p.mpi = int(round_up(hw, kGemmRows));
  p.np1 = int(round_up(2 * C, gemm_cols(2 * C)));
  p.np3 = int(round_up(C, gemm_cols(C)));
  p.np4 = int(round_up(2 * p.kp, gemm_cols(2 * p.kp)));
  p.w1 = 2LL * p.kp * p.np1;
  p.w4 = 2LL * p.kp * p.np4;
  p.w5 = p.w3 = 2LL * p.kp * p.np3;
  p.a = (long long)B * p.mpi * p.kp;
  p.rows = 2LL * B * hw * C;
  p.total = p.w1 + p.w4 + p.w5 + B * p.w3 + 2 * p.a + p.rows;
  return p;
}

struct NafScratch {
  float *w1, *w4, *w5, *w3, *a, *b, *rows;
};

NafScratch naf_scratch(float* s, const NafPlan& p, int B) {
  NafScratch o;
  o.w1 = s;
  o.w4 = o.w1 + p.w1;
  o.w5 = o.w4 + p.w4;
  o.w3 = o.w5 + p.w5;
  o.a = o.w3 + B * p.w3;
  o.b = o.a + p.a;
  o.rows = o.b + p.a;
  return o;
}

SplitJob split_job(const float* w, const float* rowscale, float* fr, int C,
                   int N, int ldw, int np, int gate, int kp, int copies) {
  return SplitJob{w, rowscale, fr, C, N, ldw, np, gate, copies,
                  (long long)kp / 8 * (np / 8) * 32};
}

// g = (dw(u_a) + d_a) * (dw(u_b) + d_b) for a tile of kGateRun rows x
// kGateCols columns x kGateCh channels; threads: channel fastest, then
// column. Each thread walks its column down the tile with a 3 x 3 window
// of both halves in registers. g goes to conv3's A in tiled() order
// (image b's pixel i at row b mpi + i, columns C..kp zeros); partials [B,
// tiles, C] get the tile's channel sums of g.
__global__ void __launch_bounds__(kThreads)
naf_gate_kernel(const float* __restrict__ u, const float* __restrict__ dk,
                const float* __restrict__ db, float* __restrict__ g,
                float* __restrict__ partials, int H, int W, int C, int kp,
                int mpi) {
  __shared__ float red[kThreads / kGateCh][kGateCh];
  const int cl = threadIdx.x % kGateCh, col = threadIdx.x / kGateCh;
  const int c = blockIdx.y * kGateCh + cl;
  const int tiles_x = (W + kGateCols - 1) / kGateCols;
  const int tile = blockIdx.x;
  const int y0 = (tile / tiles_x) * kGateRun;
  const int xx = (tile % tiles_x) * kGateCols + col;
  const int b = blockIdx.z;
  const int C2 = 2 * C;
  const float* ub = u + (long long)b * H * W * C2;
  const long long gb = (long long)b * mpi;
  float sum = 0.f;
  if (c < C && xx < W) {
    float ka[9], kb[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      ka[t] = dk[t * C2 + c];
      kb[t] = dk[t * C2 + C + c];
    }
    const float da = db[c], dbb = db[C + c];
    float wa[3][3], wb[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int d = 0; d < 3; ++d) wa[r][d] = wb[r][d] = 0.f;
#pragma unroll
    for (int r = 1; r < 3; ++r)
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int yy = y0 - 2 + r, xd = xx - 1 + d;
        if (yy >= 0 && yy < H && xd >= 0 && xd < W) {
          const float* px = ub + ((long long)yy * W + xd) * C2;
          wa[r][d] = px[c];
          wb[r][d] = px[C + c];
        }
      }
    for (int i = 0; i < kGateRun; ++i) {
      const int y = y0 + i;
      if (y >= H) break;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        wa[0][d] = wa[1][d];
        wa[1][d] = wa[2][d];
        wb[0][d] = wb[1][d];
        wb[1][d] = wb[2][d];
        const int xd = xx - 1 + d;
        float va = 0.f, vb = 0.f;
        if (y + 1 < H && xd >= 0 && xd < W) {
          const float* px = ub + ((long long)(y + 1) * W + xd) * C2;
          va = px[c];
          vb = px[C + c];
        }
        wa[2][d] = va;
        wb[2][d] = vb;
      }
      float sa = da, sb = dbb;
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          sa = fmaf(wa[r][d], ka[r * 3 + d], sa);
          sb = fmaf(wb[r][d], kb[r * 3 + d], sb);
        }
      const float v = sa * sb;
      g[tiled(gb + (long long)y * W + xx, c, kp / kBK, kGemmRows)] = v;
      sum += v;
    }
  } else if (c < kp && xx < W) {  // A's padding columns
    for (int i = 0; i < kGateRun && y0 + i < H; ++i)
      g[tiled(gb + (long long)(y0 + i) * W + xx, c, kp / kBK, kGemmRows)] =
          0.f;
  }
  red[col][cl] = sum;
  __syncthreads();
  if (col == 0 && c < C) {
    float s = 0.f;
    for (int k = 0; k < kThreads / kGateCh; ++k) s += red[k][cl];
    partials[((long long)b * gridDim.x + tile) * C + c] = s;
  }
}

// The plan of a call, or a zero kp where the call is refused.
NafPlan naf_checked(int B, int H, int W, int C, const float* scratch,
                    long long scratch_floats) {
  NafPlan p = naf_plan(H * W, C, B);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kGemmMaxC ||
      scratch_floats < p.total || reinterpret_cast<size_t>(scratch) % 16)
    p.kp = 0;
  return p;
}

}  // namespace

// Tiles per image of the gate kernel (the partials' middle axis).
extern "C" int ff_nafblock_tiles(int H, int W) {
  return ((H + kGateRun - 1) / kGateRun) * ((W + kGateCols - 1) / kGateCols);
}

// Floats of scratch a call on B images of H W pixels of C channels needs
// (the splits, two tiled A buffers, u / y); -1 for a width it refuses.
extern "C" long long ff_nafblock_scratch_floats(int hw, int C, int B) {
  return C > kGemmMaxC ? -1 : naf_plan(hw, C, B).total;
}

// Pass A. x [B, H, W, C]; ln1 [C] x2; w1 [C, 2C]; b1 [2C]; w4 [C, 2C]; w5
// [C, C]; dk [3, 3, 2C]; db [2C]; partials [B, ff_nafblock_tiles(H, W),
// C]; scratch (16-byte aligned) of ff_nafblock_scratch_floats(H W, C, B)
// floats, which pass B reads. All fp32 contiguous.
extern "C" int ff_nafblock_gate(const float* x, const float* ln1_s,
                                const float* ln1_b, const float* w1,
                                const float* b1, const float* w4,
                                const float* w5, const float* dk,
                                const float* db, float* partials,
                                float* scratch, long long scratch_floats,
                                int B, int H, int W, int C, float eps,
                                void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const NafPlan p = naf_checked(B, H, W, C, scratch, scratch_floats);
  if (!p.kp) return int(cudaErrorInvalidValue);
  const NafScratch s = naf_scratch(scratch, p, B);
  const int hw = H * W;
  const SplitJobs<3> jobs{
      {split_job(w1, nullptr, s.w1, C, 2 * C, 2 * C, p.np1, 0, p.kp, 1),
       split_job(w4, nullptr, s.w4, C, C, 2 * C, p.np4, 1, p.kp, 1),
       split_job(w5, nullptr, s.w5, C, C, C, p.np3, 0, p.kp, 1)}};
  cudaError_t err = gemm_split(jobs, stream);
  if (err == cudaSuccess)
    err = gemm_rows<2>(x, C, ln1_s, ln1_b, eps, s.a, B, p.mpi, hw, C, p.kp,
                       stream);
  if (err == cudaSuccess)
    err = gemm_launch<kEpiBias>(
        GemmArgs{s.a, s.w1, 0, p.kp, p.np1, 2 * C, p.mpi, hw, b1, s.rows,
                 2 * C, nullptr, nullptr},
        B, stream);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned(ff_nafblock_tiles(H, W)),
                  unsigned((C + kGateCh - 1) / kGateCh), unsigned(B));
  naf_gate_kernel<<<grid, kThreads, 0, stream>>>(s.rows, dk, db, s.a,
                                                 partials, H, W, C, p.kp,
                                                 p.mpi);
  return int(cudaGetLastError());
}

// Pass B, after pass A on the same scratch. s [B, C]; x [B, H, W, C]; w3
// [C, C]; b3, beta [C]; ln2 [C] x2; b4 [2C]; b5, gamma [C]; out [B, H, W,
// C].
extern "C" int ff_nafblock_apply(const float* sca, const float* x,
                                 const float* w3, const float* b3,
                                 const float* beta, const float* ln2_s,
                                 const float* ln2_b, const float* b4,
                                 const float* b5, const float* gamma,
                                 float* out, float* scratch,
                                 long long scratch_floats, int B, int H,
                                 int W, int C, float eps, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const NafPlan p = naf_checked(B, H, W, C, scratch, scratch_floats);
  if (!p.kp) return int(cudaErrorInvalidValue);
  const NafScratch s = naf_scratch(scratch, p, B);
  const int hw = H * W;
  float* y = s.rows;
  const SplitJobs<1> jobs{
      {split_job(w3, sca, s.w3, C, C, C, p.np3, 0, p.kp, B)}};
  cudaError_t err = gemm_split(jobs, stream);
  if (err == cudaSuccess)  // y = x + beta * (g W3_b + b3)
    err = gemm_launch<kEpiResidual>(
        GemmArgs{s.a, s.w3, p.w3, p.kp, p.np3, C, p.mpi, hw, b3, y, C, x,
                 beta},
        B, stream);
  if (err == cudaSuccess)
    err = gemm_rows<2>(y, C, ln2_s, ln2_b, eps, s.a, B, p.mpi, hw, C, p.kp,
                       stream);
  if (err == cudaSuccess)  // g2, tiled into the second buffer
    err = gemm_launch<kEpiGate>(
        GemmArgs{s.a, s.w4, 0, p.kp, p.np4, C, p.mpi, hw, b4, s.b, p.kp,
                 nullptr, nullptr},
        B, stream);
  if (err == cudaSuccess)  // out = y + gamma * (g2 W5 + b5)
    err = gemm_launch<kEpiResidual>(
        GemmArgs{s.b, s.w5, 0, p.kp, p.np3, C, p.mpi, hw, b5, out, C, y,
                 gamma},
        B, stream);
  return int(err);
}

// ---------------------------------------------------------------------
// The bf16 version (FREQFUSION_EXPERT_DTYPE=bf16): x, the weights and the
// vectors bf16, with the JAX kernel's rounding points (pallas_nafblock.py:
// _gate_tile :111-137, _apply_kernel :147-174): xn = LN1(x) rounded to
// bf16 (:122) before conv1; conv1's bias, the depthwise taps and
// SimpleGate in fp32; the SCA pool and product in fp32; g s rounded (:157)
// before conv3; y = x + x3 beta kept in fp32 (:161); LN2(y) rounded (:163)
// before conv4; the gate g2 rounded (:170) before conv5; the output
// rounded once (:174). The four products run on bf16_gemm.cuh's GEMM; what
// pass A leaves for pass B (g, fp32) carries no rounding JAX lacks.
//   pass A  1. W1, W3, W4 (its two halves interleaved column by column,
//              so the gate runs in conv4's epilogue) and W5 laid out
//              [kp][np] (four launches);
//           2. T1 = bf16(LN1(x)), [P][kp];
//           3. conv1: u = T1 W1 + b1, fp32 [P][2C];
//           4. g = SimpleGate(dw3x3(u) + db), fp32 [P][C]; the pool's
//              partial sums;
//   the [B, C] SCA product in PyTorch, as for fp32;
//   pass B  5. GS = bf16(g s), [P][kp];
//           6. conv3: y = x + beta (GS W3 + b3), fp32 [P][C];
//           7. T2 = bf16(LN2(y)), [P][kp];
//           8. conv4: g2 = bf16((T2 W4a + b4a) (T2 W4b + b4b)), [P][kp];
//           9. conv5: out = bf16(y + gamma (g2 W5 + b5)).

namespace {

struct NafBf16Layout {
  int kp, np1, np3, np4;
  long long w1p, w3p, w4p, w5p, t1, u, g, gs, y, t2, g2, bytes;
};

NafBf16Layout naf_bf16_layout(long long M, int C) {
  NafBf16Layout l;
  l.kp = bg_up(C, kBgK);
  l.np1 = bg_up(2 * C, kBgN);
  l.np3 = bg_up(C, kBgN);
  l.np4 = 2 * l.kp;
  l.w1p = 0;
  l.w3p = l.w1p + bg_piece(2LL * l.kp * l.np1);
  l.w4p = l.w3p + bg_piece(2LL * l.kp * l.np3);
  l.w5p = l.w4p + bg_piece(2LL * l.kp * l.np4);
  l.t1 = l.w5p + bg_piece(2LL * l.kp * l.np3);
  l.u = l.t1 + bg_piece(2LL * M * l.kp);
  l.g = l.u + bg_piece(8LL * M * C);
  l.gs = l.g + bg_piece(4LL * M * C);
  l.y = l.gs + bg_piece(2LL * M * l.kp);
  l.t2 = l.y + bg_piece(4LL * M * C);
  l.g2 = l.t2 + bg_piece(2LL * M * l.kp);
  l.bytes = l.g2 + bg_piece(2LL * M * l.kp);
  return l;
}

// g[p][c] = (sum_taps u_a k_a + db[c]) (sum_taps u_b k_b + db[C + c]): the
// depthwise 3x3 (zero padding) of u's two halves and SimpleGate, fp32, the
// taps summed in the JAX kernel's order. As csrc/dwconv.cu's kernel: a
// thread owns N channels (2: one 8-byte load a half) of one column and
// walks kNafDwRun rows down it, the 3 x 3 windows of both halves in
// registers.
constexpr int kNafDwRun = 8;

template <int N>
__device__ __forceinline__ void naf_load(float (&v)[N], const float* p,
                                         bool in) {
  if constexpr (N == 2) {
    const float2 t = in ? *reinterpret_cast<const float2*>(p)
                        : make_float2(0.f, 0.f);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = in ? *p : 0.f;
  }
}

template <int N>
__global__ void __launch_bounds__(256)
naf_dwgate_bf16_kernel(const float* __restrict__ u,
                       const bf16* __restrict__ dk,
                       const bf16* __restrict__ db, float* __restrict__ g,
                       int H, int W, int C) {
  const int groups = C / N;
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= W * groups) return;
  const int c = (idx % groups) * N, x = idx / groups;
  const int y0 = blockIdx.y * kNafDwRun;
  const long long C2 = 2LL * C;
  const float* ub = u + (long long)blockIdx.z * H * W * C2;
  float* gb = g + (long long)blockIdx.z * H * W * C;
  float ka[9][N], kb[9][N], ba[N], bb[N];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < N; ++e) {
      ka[t][e] = bg_f(dk[t * C2 + c + e]);
      kb[t][e] = bg_f(dk[t * C2 + C + c + e]);
    }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    ba[e] = bg_f(db[c + e]);
    bb[e] = bg_f(db[C + c + e]);
  }
  // wa/wb[r][d]: row y - 1 + r, column x - 1 + d of each half
  float wa[3][3][N], wb[3][3][N];
  auto row = [&](float (&ra)[3][N], float (&rb)[3][N], int yy) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int xx = x - 1 + d;
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const float* p =
          ub + ((long long)(in ? yy : 0) * W + (in ? xx : 0)) * C2 + c;
      naf_load<N>(ra[d], p, in);
      naf_load<N>(rb[d], p + C, in);
    }
  };
  row(wa[0], wb[0], y0 - 1);
  row(wa[1], wb[1], y0);
  for (int i = 0; i < kNafDwRun; ++i) {
    const int y = y0 + i;
    if (y >= H) break;
    row(wa[2], wb[2], y + 1);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float sa = wa[0][0][e] * ka[0][e], sb = wb[0][0][e] * kb[0][e];
#pragma unroll
      for (int t = 1; t < 9; ++t) {
        sa = sa + wa[t / 3][t % 3][e] * ka[t][e];
        sb = sb + wb[t / 3][t % 3][e] * kb[t][e];
      }
      gb[((long long)y * W + x) * C + c + e] = (sa + ba[e]) * (sb + bb[e]);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int e = 0; e < N; ++e) {
        wa[0][d][e] = wa[1][d][e];
        wa[1][d][e] = wa[2][d][e];
        wb[0][d][e] = wb[1][d][e];
        wb[1][d][e] = wb[2][d][e];
      }
  }
}

template <int N>
cudaError_t naf_dwgate(const float* u, const bf16* dk, const bf16* db,
                       float* g, int B, int H, int W, int C,
                       cudaStream_t stream) {
  const dim3 grid(unsigned((W * (C / N) + 255) / 256),
                  unsigned((H + kNafDwRun - 1) / kNafDwRun), unsigned(B));
  naf_dwgate_bf16_kernel<N><<<grid, 256, 0, stream>>>(u, dk, db, g, H, W, C);
  return cudaGetLastError();
}

// gs[p][j] = bf16(g[p][j] s[p / hw][j]) for j < C, 0 up to kp
__global__ void __launch_bounds__(256)
naf_scale_bf16_kernel(const float* __restrict__ g, const float* __restrict__ s,
                      bf16* __restrict__ gs, int hw, int C, int kp,
                      long long total) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += gridDim.x * 256LL) {
    const long long p = i / kp;
    const int j = int(i % kp);
    gs[i] = bg_round(j < C ? g[p * C + j] * s[(p / hw) * C + j] : 0.f);
  }
}

unsigned naf_grid(long long total) {
  const long long blocks = (total + 255) / 256;
  return unsigned(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

struct NafResidualEpi {  // y = x + beta (v + b3), fp32
  const bf16* x;
  const bf16* b3;
  const bf16* beta;
  float* y;
  long long M;
  int C;
  __device__ __forceinline__ void operator()(long long m, int n, float v0,
                                             float v1) const {
    if (m >= M) return;
    const long long o = m * C + n;
    if (n < C) y[o] = bg_f(x[o]) + (v0 + bg_f(b3[n])) * bg_f(beta[n]);
    if (n + 1 < C)
      y[o + 1] = bg_f(x[o + 1]) + (v1 + bg_f(b3[n + 1])) * bg_f(beta[n + 1]);
  }
};

struct NafGateEpi {  // columns 2j, 2j + 1: W4's column j and C + j
  const bf16* b4;
  bf16* g2;
  long long M;
  int C, kp;
  __device__ __forceinline__ void operator()(long long m, int n, float v0,
                                             float v1) const {
    const int j = n / 2;
    if (m >= M || j >= kp) return;
    g2[m * kp + j] = bg_round(
        j < C ? (v0 + bg_f(b4[j])) * (v1 + bg_f(b4[C + j])) : 0.f);
  }
};

struct NafOutEpi {  // out = bf16(y + gamma (v + b5))
  const float* y;
  const bf16* b5;
  const bf16* gamma;
  bf16* out;
  long long M;
  int C;
  __device__ __forceinline__ void operator()(long long m, int n, float v0,
                                             float v1) const {
    if (m >= M) return;
    const long long o = m * C + n;
    if (n < C) out[o] = bg_round(y[o] + (v0 + bg_f(b5[n])) * bg_f(gamma[n]));
    if (n + 1 < C)
      out[o + 1] =
          bg_round(y[o + 1] + (v1 + bg_f(b5[n + 1])) * bg_f(gamma[n + 1]));
  }
};

}  // namespace

// Bytes of scratch a bf16 call on B H W = M pixels of C channels needs.
extern "C" long long ff_nafblock_bf16_scratch_bytes(long long M, int C) {
  return naf_bf16_layout(M, C).bytes;
}

// Pass A, bf16. x [B, H, W, C]; ln1 [C] x2; w1 [C, 2C]; b1 [2C]; w3, w5
// [C, C]; w4 [C, 2C]; dk [3, 3, 2C]; db [2C]: bf16 contiguous. partials
// [B, ceil(H W / 256), C] fp32; scratch of ff_nafblock_bf16_scratch_bytes
// bytes (16-byte aligned), which pass B reads.
extern "C" int ff_nafblock_gate_bf16(const void* x_, const void* ln1_s,
                                     const void* ln1_b, const void* w1,
                                     const void* b1, const void* w3,
                                     const void* w4, const void* w5,
                                     const void* dk, const void* db,
                                     float* partials, void* scratch_,
                                     long long scratch_bytes, int B, int H,
                                     int W, int C, float eps, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long M = (long long)B * H * W;
  const NafBf16Layout l = naf_bf16_layout(M, C);
  char* sc = static_cast<char*>(scratch_);
  if (M <= 0 || C <= 0 || B > 65535 || scratch_bytes < l.bytes ||
      reinterpret_cast<size_t>(sc) % 16)
    return int(cudaErrorInvalidValue);
  auto b = [&](long long off) { return reinterpret_cast<bf16*>(sc + off); };
  auto f = [&](long long off) { return reinterpret_cast<float*>(sc + off); };
  auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  cudaError_t err =
      bg_pad(in(w1), 2 * C, 1, C, l.kp, 2 * C, 0, b(l.w1p), l.kp, l.np1,
             stream);
  if (err == cudaSuccess)
    err = bg_pad(in(w3), C, 1, C, l.kp, C, 0, b(l.w3p), l.kp, l.np3, stream);
  if (err == cudaSuccess)
    err = bg_pad(in(w4), 2 * C, 1, C, l.kp, 2 * C, 1, b(l.w4p), l.kp, l.np4,
                 stream);
  if (err == cudaSuccess)
    err = bg_pad(in(w5), C, 1, C, l.kp, C, 0, b(l.w5p), l.kp, l.np3, stream);
  if (err == cudaSuccess)
    err = bg_rows(in(x_), M, C, in(ln1_s), in(ln1_b), eps, b(l.t1), l.kp,
                  stream);
  if (err == cudaSuccess)
    err = bg_gemm(BgRows{b(l.t1), M, l.kp}, M, b(l.w1p), l.np1, l.kp, l.np1,
                  BgBiasEpi{in(b1), f(l.u), M, 2 * C}, stream);
  if (err != cudaSuccess) return int(err);
  err = C % 2 ? naf_dwgate<1>(f(l.u), in(dk), in(db), f(l.g), B, H, W, C,
                              stream)
               : naf_dwgate<2>(f(l.u), in(dk), in(db), f(l.g), B, H, W, C,
                              stream);
  if (err == cudaSuccess)
    err = bg_colsum(f(l.g), B, H * W, C, partials, stream);
  return int(err);
}

// Pass B, bf16, after pass A on the same scratch. s [B, C] fp32; x [B, H,
// W, C], b3, beta [C], ln2 [C] x2, b4 [2C], b5, gamma [C], out [B, H, W,
// C]: bf16.
extern "C" int ff_nafblock_apply_bf16(const float* sca, const void* x_,
                                      const void* b3, const void* beta,
                                      const void* ln2_s, const void* ln2_b,
                                      const void* b4, const void* b5,
                                      const void* gamma, void* out,
                                      void* scratch_, long long scratch_bytes,
                                      int B, int H, int W, int C, float eps,
                                      void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long M = (long long)B * H * W;
  const NafBf16Layout l = naf_bf16_layout(M, C);
  char* sc = static_cast<char*>(scratch_);
  if (M <= 0 || C <= 0 || scratch_bytes < l.bytes ||
      reinterpret_cast<size_t>(sc) % 16)
    return int(cudaErrorInvalidValue);
  auto b = [&](long long off) { return reinterpret_cast<bf16*>(sc + off); };
  auto f = [&](long long off) { return reinterpret_cast<float*>(sc + off); };
  auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  naf_scale_bf16_kernel<<<naf_grid(M * l.kp), 256, 0, stream>>>(
      f(l.g), sca, b(l.gs), H * W, C, l.kp, M * l.kp);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = bg_gemm(BgRows{b(l.gs), M, l.kp}, M, b(l.w3p), l.np3, l.kp, l.np3,
                  NafResidualEpi{in(x_), in(b3), in(beta), f(l.y), M, C},
                  stream);
  if (err == cudaSuccess)
    err = bg_rows(f(l.y), M, C, in(ln2_s), in(ln2_b), eps, b(l.t2), l.kp,
                  stream);
  if (err == cudaSuccess)
    err = bg_gemm(BgRows{b(l.t2), M, l.kp}, M, b(l.w4p), l.np4, l.kp, l.np4,
                  NafGateEpi{in(b4), b(l.g2), M, C, l.kp}, stream);
  if (err == cudaSuccess)
    err = bg_gemm(BgRows{b(l.g2), M, l.kp}, M, b(l.w5p), l.np3, l.kp, l.np3,
                  NafOutEpi{f(l.y), in(b5), in(gamma), static_cast<bf16*>(out),
                            M, C},
                  stream);
  return int(err);
}
