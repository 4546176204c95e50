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
