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

#include "bf16_wgmma.cuh"
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
// rounded once (:174). The four products run on bf16_wgmma.cuh's GEMM
// (wgmma, each weight laid out once per module in wgmma's order by
// ops/wgmma.py, streamed by bulk copies through an mbarrier ring); what
// goes between the two entries (g, fp32) carries no rounding JAX lacks.
// At C <= 256 (NAFNet's levels 1-3, where the bytes bind):
//   pass A  one launch (naf_gate_wgmma_kernel) a 2-D tile of pixels with
//           its one-pixel halo (8 x 16 halo pixels, 6 x 14 out): LN1 as A
//           is staged (the raw rows by 16-byte loads, the statistics and
//           the normalisation in shared memory), conv1 over the halo's
//           rows (1.52x conv1's FLOPs), 64 channels of u (fp32, both
//           halves) at a time into shared memory, the depthwise 3x3 and
//           SimpleGate from there, g written (fp32) and the pool's
//           per-tile sums, so u never reaches device memory;
//   the [B, C] SCA product in PyTorch, as for fp32;
//   pass B  one launch (naf_apply_wgmma_kernel), a 64-row block holding
//           whole rows: A = bf16(g s) staged; conv3 with y = x + beta (.
//           + b3) kept in shared memory (fp32); LN2 of y staged as
//           conv4's A; conv4 gated in its epilogue into conv5's A; conv5
//           with out = bf16(y + gamma (. + b5)), written once.
// Above C 256 (levels 4-5: 43,008 and 10,752 rows, the products bind) a
// block a 64-row slab of A, whole K, leaves most SMs idle and y and two A
// buffers no longer fit in its shared memory, so every product runs on
// bw_tiled (both operands streamed, 128 x 128 a block) and the A operands
// go through device memory in the tiled order: pass A is LN1's rows pass,
// conv1 writing u (fp32, interleaved) and the depthwise gate over 8 x 8
// tiles (naf_dwgate_kernel, with the pool's sums); pass B the GS rows
// pass, conv3 writing y (fp32), the LN2 rows pass, conv4 writing g2 (in
// the tiled order) and conv5.
// Device memory a pixel, by this count: at C <= 256 pass A reads x (2 C;
// the halo's rows again, from L2) and writes g (4 C), pass B reads g (4 C)
// and x (2 C) and writes out (2 C): 14 C bytes against the bound's 4 C (x
// in, out out), 62 C in the first bf16 version. Above C 256, 58 C: LN1,
// GS, T2 and g2 written and read (16 C), u (16 C), y written and read
// twice (12 C), x twice, g and out.

namespace {

constexpr int kNafBn1 = 128;  // conv1's chunk: 64 channels, both halves
constexpr int kNafUPad = 8;   // u's shared rows: kNafBn1 + 8 floats
constexpr int kNafOutH = 6;   // a gate tile's output rows (8 halo rows)

// Pass B's chunk width (its three weights' layouts): 64 below C 128.
inline int naf_apply_bn(int C) { return C <= 64 ? 64 : 128; }
// C <= 256: the two fused kernels; above, products on bw_tiled (C, 1024 at
// most, a multiple of 64 there)
inline bool naf_fused(int C) { return C <= 256; }
constexpr int kNafDwTile = 8;  // the depthwise kernel's tile: 8 x 8 pixels

inline long long naf_piece(long long bytes) {
  return (bytes + 255) / 256 * 256;
}

inline int naf_gate_smem(int C, int stages) {
  constexpr int bm = 128;
  return bw_smem_bytes(bm, bw_up(C, kBwK), kNafBn1,
                       bm * (kNafBn1 + kNafUPad) * 4 + bm * 8 + 4 * 64 * 4 +
                           4 * C * 4 + 20 * 64 * 4 + bm,
                       stages);
}

// The gate kernel's ring: the deepest of 4, 3, 2 stages that lets two
// blocks share an SM (233472 bytes, 1 KB reserved a block), else 4.
inline int naf_gate_stages(int C) {
  for (int st = 4; st >= 2; --st)
    if (naf_gate_smem(C, st) <= 233472 / 2 - 1024) return st;
  return 4;
}

inline int naf_apply_smem(int C) {
  const int kp = bw_up(C, kBwK);
  return bw_smem_bytes(64, kp, naf_apply_bn(C), 0) + 64 * kp * 2 +
         64 * (kp + 8) * 4 + 64 * 8 + 8 * kp * 4;
}

// The scratch: g (fp32, [M][C]); above C 256 also y (fp32) and g2 (bf16).
// The scratch: g (fp32, [M][C]); above C 256 also y (fp32), two A
// operands in the tiled order (bw_tiled_off: LN1, then GS, then T2; and
// g2), M rounded up to 128 rows, K to 32, and u (fp32, [M][2C], its
// halves interleaved).
struct NafBf16Layout {
  long long g, y, at, g2, u, bytes;
};

NafBf16Layout naf_bf16_layout(long long M, int C) {
  const long long tiled = 2 * ((M + 127) / 128 * 128) * bw_up(C, kBwK);
  const bool split = !naf_fused(C);
  NafBf16Layout l;
  l.g = 0;
  l.y = l.g + naf_piece(4 * M * C);
  l.at = l.y + (split ? naf_piece(4 * M * C) : 0);
  l.g2 = l.at + (split ? naf_piece(tiled) : 0);
  l.u = l.g2 + (split ? naf_piece(tiled) : 0);
  l.bytes = l.u + (split ? naf_piece(8 * M * C) : 0);
  return l;
}

struct NafGateArgs {
  const __nv_bfloat16 *x, *ln_s, *ln_b;
  const void* w1;  // conv1's layout: halves interleaved, 128 a chunk
  const __nv_bfloat16 *b1, *dk, *db;
  float* g;
  float* partials;  // [B, tiles, C]
  int B, H, W, C, tiles_x, tiles_y, stages;
  float eps;
};

// Pass A. Block: one tile of one image; halo row r is pixel (y0 - 1 + r /
// kTw, x0 - 1 + r % kTw). Each chunk of conv1 (64 channels c0 .. c0 + 63,
// a and b halves interleaved by column) goes to shared memory as u (zero
// outside the image, the depthwise conv's padding); then thread t gates
// channel c0 + t % 64 along segments of output rows, a 3 x 3 window of
// both halves (float2) sliding along the row, the taps summed in the JAX
// kernel's order, and sums its outputs for the pool.
__global__ void __launch_bounds__(288, 2)
naf_gate_wgmma_kernel(const NafGateArgs a) {
  extern __shared__ __align__(128) unsigned char naf_smem[];
  constexpr int WGS = 2;  // 128 halo rows: 8 x 16 pixels
  constexpr int kBm = 64 * WGS, kThreads = 128 * WGS, kTw = 8 * WGS;
  constexpr int kOw = kTw - 2, kSegs = WGS, kSw = kOw / kSegs;
  constexpr int kUs = kNafBn1 + kNafUPad;
  const int C = a.C, kp = bw_up(C, kBwK), C2 = 2 * C;
  BwRing r = bw_ring(naf_smem, kNafBn1 * 64, 4 * WGS, a.stages);
  unsigned char* as = naf_smem + kBwHead + a.stages * kNafBn1 * 64;
  float* us = reinterpret_cast<float*>(as + kBm * kp * 2);
  float2* stats = reinterpret_cast<float2*>(us + kBm * kUs);
  float* red = reinterpret_cast<float*>(stats + kBm);
  float* b1s = red + kThreads;  // conv1's bias [2C], fp32
  float* t0 = b1s + C2;  // the first chunk's taps [9][2][64], bias [2][64]
  float* lns = t0 + 20 * 64;  // LN1's scale and bias [C] each, fp32
  float* lnb = lns + C;
  unsigned char* inside = reinterpret_cast<unsigned char*>(lnb + C);
  __syncthreads();
  const int tid = threadIdx.x, nch = (C + 63) / 64;
  if (tid >= kThreads) {
    if (tid == kThreads) bw_produce(r, a.w1, nch * (kp / kBwK));
    return;
  }
  const int tiles = a.tiles_x * a.tiles_y;
  const int b = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int y0 = (t / a.tiles_x) * kNafOutH, x0 = (t % a.tiles_x) * kOw;
  BW_MARK(0);
  BW_SPAN(30);
  auto pixel = [&](int hr) -> long long {
    const int y = y0 - 1 + hr / kTw, x = x0 - 1 + hr % kTw;
    return y < 0 || y >= a.H || x < 0 || x >= a.W
               ? -1LL
               : ((long long)b * a.H + y) * a.W + x;
  };
  for (int i = tid; i < kBm; i += kThreads) inside[i] = pixel(i) >= 0;
  bw_vector(b1s, a.b1, C2, C2, tid, kThreads);
  bw_vector(lns, a.ln_s, C, C, tid, kThreads);
  bw_vector(lnb, a.ln_b, C, C, tid, kThreads);
  for (int i = tid; i < 20 * 64; i += kThreads) {
    const int k = i / 128, h = (i / 64) % 2, ch = i % 64;
    t0[i] = ch >= C ? 0.f
            : k < 9 ? bw_f(a.dk[k * C2 + h * C + ch])
                    : bw_f(a.db[h * C + ch]);
  }
  bw_stage(as, kBm, kp, tid, kThreads, [&](int hr, int q) {  // raw rows
    const long long px = pixel(hr);
    return px < 0 ? make_uint4(0, 0, 0, 0)
                  : bw_load8(a.x + px * C + 8 * q, C - 8 * q);
  });
  bw_sync(kThreads);
  bw_ln_inplace(as, stats, kBm, kp, C, a.eps, lns, lnb, tid, kThreads,
                [&](int hr) { return inside[hr] != 0; });
  fence_proxy_async();  // the staged A, before wgmma reads it
  bw_sync(kThreads);
  BW_MARK(1);
  const unsigned char* aw = as + (tid >> 7) * 2048;
  const int j = tid & 63;
  for (int c = 0; c < nch; ++c) {
    const int ch = 64 * c + j;
    float acc[kNafBn1 / 2];
    bw_chunk<kNafBn1>(acc, aw, kBm, kp / kBwK, r);
    BW_MARK(2 + 3 * (c & 7));
    bw_each<kNafBn1>(acc, [&](int row, int col, float v0, float v1) {
      const int cc = 64 * c + col / 2;  // the column pair's channel
      *reinterpret_cast<float2*>(us + row * kUs + col) =
          inside[row] && cc < C ? make_float2(v0 + b1s[cc], v1 + b1s[C + cc])
                                : make_float2(0.f, 0.f);
    });
    bw_sync(kThreads);
    BW_MARK(3 + 3 * (c & 7));
    float sum = 0.f;
    if (ch < C) {
      // the taps: the first chunk's staged with A, a later one's read now
      float ka[9], kb[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        ka[k] = c ? bw_f(a.dk[k * C2 + ch]) : t0[k * 128 + j];
        kb[k] = c ? bw_f(a.dk[k * C2 + C + ch]) : t0[k * 128 + 64 + j];
      }
      const float ba = c ? bw_f(a.db[ch]) : t0[9 * 128 + j];
      const float bb = c ? bw_f(a.db[C + ch]) : t0[9 * 128 + 64 + j];
      for (int it = tid >> 6; it < kNafOutH * kSegs; it += kThreads / 64) {
        const int oy = it % kNafOutH, ox0 = (it / kNafOutH) * kSw;
        // w[r][d]: u at halo row oy + r, column ox + d (output column
        // ox's 3 x 3 window); .x the a half, .y the b half
        auto U = [&](int hy, int hx) {
          return *reinterpret_cast<const float2*>(us + (hy * kTw + hx) * kUs +
                                                  2 * j);
        };
        float2 w[3][3];
#pragma unroll
        for (int rr = 0; rr < 3; ++rr) {
          w[rr][1] = U(oy + rr, ox0);
          w[rr][2] = U(oy + rr, ox0 + 1);
        }
#pragma unroll
        for (int i = 0; i < kSw; ++i) {
          const int ox = ox0 + i;
#pragma unroll
          for (int rr = 0; rr < 3; ++rr) {
            w[rr][0] = w[rr][1];
            w[rr][1] = w[rr][2];
            w[rr][2] = U(oy + rr, ox + 2);
          }
          float sa = w[0][0].x * ka[0], sb = w[0][0].y * kb[0];
#pragma unroll
          for (int k = 1; k < 9; ++k) {
            sa = sa + w[k / 3][k % 3].x * ka[k];
            sb = sb + w[k / 3][k % 3].y * kb[k];
          }
          const float v = (sa + ba) * (sb + bb);
          const int y = y0 + oy, x = x0 + ox;
          if (y < a.H && x < a.W) {
            a.g[(((long long)b * a.H + y) * a.W + x) * C + ch] = v;
            sum += v;
          }
        }
      }
    }
    red[(tid >> 6) * 64 + j] = sum;
    bw_sync(kThreads);  // u read by every thread; the sums in
    BW_MARK(4 + 3 * (c & 7));
    if (tid < 64 && 64 * c + tid < C) {
      float s = 0.f;
      for (int k = 0; k < kThreads / 64; ++k) s += red[k * 64 + tid];
      a.partials[((long long)b * tiles + t) * C + 64 * c + tid] = s;
    }
  }
  BW_SPAN(31);
}

// A = bf16(g s_b) of rows m0 + r (image b = m / hw): conv3's prologue.
struct NafGsRows {
  const float* g;
  const float* s;
  long long M;
  int hw, C;
  __device__ __forceinline__ void stage(unsigned char* as, unsigned char*,
                                        long long m0, int bm, int kp,
                                        int tid, int threads) const {
    const long long b0 = m0 / hw, edge = (b0 + 1) * hw;  // image b0 ends
    bw_stage(as, bm, kp, tid, threads, [&](int r, int q) {
      const long long m = m0 + r;
      const int valid = C - 8 * q;
      if (m >= M || valid <= 0) return make_uint4(0, 0, 0, 0);
      float v[8], sv[8];
      bw_get8(v, g + m * C + 8 * q, valid);
      bw_get8(sv, s + (m < edge ? b0 : m / hw) * C + 8 * q, valid);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= sv[i];
      return bw_pack8(v);
    });
  }
};

struct NafApplyArgs {
  const float *g, *sca;
  const __nv_bfloat16* x;
  const void *w3, *w4, *w5;  // layouts at naf_apply_bn(C) (w4 interleaved)
  const __nv_bfloat16 *b3, *beta, *ln_s, *ln_b, *b4, *b5, *gamma;
  __nv_bfloat16* out;
  long long M;
  int hw, C;
  float eps;
};

// Pass B at C <= 256: 64 rows a block, one warpgroup; W3, W4 and W5
// stream through one ring in that order. The vectors wait in shared memory
// (vs: b3, beta, b5, gamma, then b4); x joins y and the output leaves y
// row by row, so that device memory sees whole rows.
template <int BN>
__global__ void __launch_bounds__(160)
naf_apply_wgmma_kernel(const NafApplyArgs a) {
  extern __shared__ __align__(128) unsigned char naf_smem[];
  const int C = a.C, kp = bw_up(C, kBwK), ys = kp + 8, nst = kp / kBwK;
  BwRing r = bw_ring(naf_smem, BN * 64, 4);
  unsigned char* a1 = naf_smem + kBwHead + kBwStages * BN * 64;  // GS, T2
  unsigned char* a3 = a1 + 64 * kp * 2;                           // g2
  float* y = reinterpret_cast<float*>(a3 + 64 * kp * 2);          // [64][ys]
  float2* stats = reinterpret_cast<float2*>(y + 64 * ys);
  float* vs = reinterpret_cast<float*>(stats + 64);  // [4][kp], [2 kp],
                                                     // [2][kp]
  const long long m0 = (long long)blockIdx.x * 64;
  __syncthreads();
  const int tid = threadIdx.x, n3 = (C + BN - 1) / BN;
  const int n4 = (2 * C + BN - 1) / BN;
  if (tid >= 128) {
    if (tid == 128) {
      bw_produce(r, a.w3, n3 * nst);
      bw_produce(r, a.w4, n4 * nst);
      bw_produce(r, a.w5, n3 * nst);
    }
    return;
  }
  BW_MARK(32);
  BW_SPAN(62);
  const float *b3 = vs, *beta = vs + kp, *b5 = vs + 2 * kp,
              *gamma = vs + 3 * kp, *b4 = vs + 4 * kp;
  bw_vector(vs, a.b3, C, kp, tid, 128);
  bw_vector(vs + kp, a.beta, C, kp, tid, 128);
  bw_vector(vs + 2 * kp, a.b5, C, kp, tid, 128);
  bw_vector(vs + 3 * kp, a.gamma, C, kp, tid, 128);
  bw_vector(vs + 4 * kp, a.b4, 2 * C, 2 * kp, tid, 128);
  const float *ln_s = vs + 6 * kp, *ln_b = vs + 7 * kp;
  bw_vector(vs + 6 * kp, a.ln_s, C, kp, tid, 128);
  bw_vector(vs + 7 * kp, a.ln_b, C, kp, tid, 128);
  NafGsRows{a.g, a.sca, a.M, a.hw, C}.stage(a1, nullptr, m0, 64, kp, tid,
                                            128);
  fence_proxy_async();
  bw_sync(128);
  BW_MARK(33);
  const int half = C / 2, pairs = 64 * half;  // pair e: row e / half
  for (int c = 0; c < n3; ++c) {  // y = GS W3 + b3, for now
    float acc[BN / 2];
    bw_chunk<BN>(acc, a1, 64, nst, r);
    bw_each<BN>(acc, [&](int row, int col, float v0, float v1) {
      const int n = c * BN + col;
      if (n < C)
        *reinterpret_cast<float2*>(y + row * ys + n) =
            make_float2(v0 + b3[n], v1 + b3[n + 1]);
    });
  }
  bw_sync(128);
  BW_MARK(34);
  // y = x + beta (GS W3 + b3), fp32: x's pairs row by row, 16 loads in
  // flight a thread
  for (int e0 = tid; e0 < pairs; e0 += 128 * 16) {
    __nv_bfloat162 xv[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int e = e0 + 128 * k, row = e / half;
      xv[k] = e < pairs && m0 + row < a.M
                  ? __ldg(reinterpret_cast<const __nv_bfloat162*>(
                        a.x + (m0 + row) * C + 2 * (e % half)))
                  : __floats2bfloat162_rn(0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int e = e0 + 128 * k, row = e / half, n = 2 * (e % half);
      if (e < pairs) {
        float2* yp = reinterpret_cast<float2*>(y + row * ys + n);
        const float2 x = __bfloat1622float2(xv[k]);
        *yp = make_float2(x.x + yp->x * beta[n], x.y + yp->y * beta[n + 1]);
      }
    }
  }
  bw_sync(128);  // y whole; every wgmma on GS retired
  BW_MARK(35);
  {              // LN2's statistics: two threads a row
    const int row = tid >> 1, h = tid & 1, c0 = h * (C / 2);
    const int c1 = h ? C : C / 2;
    const float* yr = y + row * ys;
    float s = 0.f;
    for (int i = c0; i < c1; ++i) s += yr[i];
    s += __shfl_xor_sync(~0u, s, 1);
    const float mu = s / C;
    float q = 0.f;
    for (int i = c0; i < c1; ++i) {
      const float d = yr[i] - mu;
      q += d * d;
    }
    q += __shfl_xor_sync(~0u, q, 1);
    if (!h) stats[row] = make_float2(mu, rsqrtf(q / C + a.eps));
  }
  bw_sync(128);
  BW_MARK(36);
  bw_stage(a1, 64, kp, tid, 128, [&](int rr, int q) {  // T2 = bf16(LN2(y))
    const int valid = C - 8 * q;
    if (valid <= 0) return make_uint4(0, 0, 0, 0);
    float v[8], sc[8], bi[8];
    bw_get8(v, y + rr * ys + 8 * q, valid);
    bw_get8(sc, ln_s + 8 * q, valid);
    bw_get8(bi, ln_b + 8 * q, valid);
    const float2 st = stats[rr];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = i < valid ? (v[i] - st.x) * st.y * sc[i] + bi[i] : 0.f;
    return bw_pack8(v);
  });
  fence_proxy_async();
  bw_sync(128);
  BW_MARK(37);
  for (int c = 0; c < n4; ++c) {  // g2 = bf16(gate), conv5's A
    float acc[BN / 2];
    bw_chunk<BN>(acc, a1, 64, nst, r);
    bw_each<BN>(acc, [&](int row, int col, float v0, float v1) {
      const int jj = (c * BN + col) / 2;
      if (jj < kp)
        *reinterpret_cast<__nv_bfloat16*>(a3 + bw_a_off(row, jj >> 3, 64) +
                                          (jj & 7) * 2) =
            __float2bfloat16_rn(jj < C ? (v0 + b4[jj]) * (v1 + b4[C + jj])
                                       : 0.f);
    });
  }
  fence_proxy_async();
  bw_sync(128);
  BW_MARK(38);
  for (int c = 0; c < n3; ++c) {  // y + gamma (g2 W5 + b5), in y's place
    float acc[BN / 2];
    bw_chunk<BN>(acc, a3, 64, nst, r);
    bw_each<BN>(acc, [&](int row, int col, float v0, float v1) {
      const int n = c * BN + col;
      if (n < C) {
        float2* yp = reinterpret_cast<float2*>(y + row * ys + n);
        *yp = make_float2(yp->x + (v0 + b5[n]) * gamma[n],
                          yp->y + (v1 + b5[n + 1]) * gamma[n + 1]);
      }
    });
  }
  bw_sync(128);
  BW_MARK(39);
  for (int e = tid; e < pairs; e += 128) {  // out, row by row
    const int row = e / half, n = 2 * (e % half);
    if (m0 + row < a.M) {
      const float2 o = *reinterpret_cast<const float2*>(y + row * ys + n);
      *reinterpret_cast<uint32_t*>(a.out + (m0 + row) * C + n) =
          pack_bf16(o.x, o.y);
    }
  }
  BW_MARK(40);
  BW_SPAN(63);
}

// Pass B above C 256, three launches: y, then g2, then out. Each reads its
// vectors from shared memory (vs: b3 and beta, b4, b5 and gamma) and the
// rows it adds (x, y) as the tile leaves.
struct NafYEpi {  // y = x + beta (v + b3), fp32
  NafApplyArgs a;
  float* y;
  static constexpr int kVecs = 2;
  __device__ __forceinline__ const __nv_bfloat16* vec(int k) const {
    return k ? a.beta : a.b3;
  }
  __device__ __forceinline__ int n() const { return a.C; }
  __device__ __forceinline__ float2 load(long long m, int n) const {
    return m < a.M && n < a.C
               ? __bfloat1622float2(__ldg(
                     reinterpret_cast<const __nv_bfloat162*>(a.x + m * a.C +
                                                             n)))
               : make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ float2 stage(int n, float v0, float v1,
                                          const float* vs, int) const {
    return make_float2(v0 + vs[n], v1 + vs[n + 1]);
  }
  __device__ __forceinline__ void operator()(long long m, int n, float2 t,
                                             const float* vs, int np,
                                             float2 x) const {
    if (m < a.M && n < a.C)
      *reinterpret_cast<float2*>(y + m * a.C + n) = make_float2(
          x.x + t.x * vs[np + n], x.y + t.y * vs[np + n + 1]);
  }
};

struct NafG2Epi {  // g2 = bf16((v_a + b4a) (v_b + b4b)), interleaved
  NafApplyArgs a;
  unsigned char* g2;  // conv5's A, in the tiled order
  long long Mp;       // M rounded up to 128: the rows g2 holds
  int kp;
  static constexpr int kVecs = 1;
  __device__ __forceinline__ const __nv_bfloat16* vec(int) const {
    return a.b4;
  }
  __device__ __forceinline__ int n() const { return 2 * a.C; }
  __device__ __forceinline__ BwNone load(long long, int) const { return {}; }
  __device__ __forceinline__ uint32_t stage(int n, float v0, float v1,
                                            const float* vs, int) const {
    const int j = n / 2 < a.C ? n / 2 : 0;
    return pack_bf16((v0 + vs[j]) * (v1 + vs[a.C + j]), 0.f);
  }
  __device__ __forceinline__ void operator()(long long m, int n, uint32_t t,
                                             const float*, int,
                                             BwNone) const {
    const int j = n / 2;  // zeros past M and C: conv5's padding
    if (m < Mp && j < kp)
      *reinterpret_cast<unsigned short*>(g2 + bw_tiled_off(m, j, kp)) =
          m < a.M && j < a.C ? (unsigned short)(t & 0xffff) : 0;
  }
};

struct NafOutEpi {  // out = bf16(y + gamma (v + b5))
  NafApplyArgs a;
  const float* y;
  static constexpr int kVecs = 2;
  __device__ __forceinline__ const __nv_bfloat16* vec(int k) const {
    return k ? a.gamma : a.b5;
  }
  __device__ __forceinline__ int n() const { return a.C; }
  __device__ __forceinline__ float2 load(long long m, int n) const {
    return m < a.M && n < a.C
               ? __ldg(reinterpret_cast<const float2*>(y + m * a.C + n))
               : make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ float2 stage(int n, float v0, float v1,
                                          const float* vs, int) const {
    return make_float2(v0 + vs[n], v1 + vs[n + 1]);
  }
  __device__ __forceinline__ void operator()(long long m, int n, float2 t,
                                             const float* vs, int np,
                                             float2 yv) const {
    if (m < a.M && n < a.C)
      *reinterpret_cast<uint32_t*>(a.out + m * a.C + n) =
          pack_bf16(yv.x + t.x * vs[np + n], yv.y + t.y * vs[np + n + 1]);
  }
};

// A in the tiled order (bw_tiled_off) from rows of C channels (at most
// 1024; bf16 or fp32), a warp a row: with kLn bf16(LN(row) s + b) (the
// statistics from registers, both passes), else bf16(row s_b) (image b =
// m / hw); zeros past C and for rows M .. Mp - 1.
template <bool kLn, typename T>
__global__ void __launch_bounds__(256)
naf_tiled_rows_kernel(const T* __restrict__ src,
                      const float* __restrict__ sca,
                      const __nv_bfloat16* __restrict__ ln_s,
                      const __nv_bfloat16* __restrict__ ln_b,
                      unsigned char* __restrict__ at, long long M,
                      long long Mp, int hw, int C, int kp, float eps) {
  const long long m = blockIdx.x * 8LL + threadIdx.x / 32;
  const int lane = threadIdx.x & 31, kq = kp / 8;
  if (m >= Mp) return;
  float v[4][8];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = lane + 32 * j;
    if (q < kq && m < M) {
      bw_get8(v[j], src + m * C + 8 * q, C - 8 * q);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[j][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) s += v[j][i];
  }
  if (kLn) {
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(~0u, s, o);
    const float mu = s / C;
    float q2 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = 8 * (lane + 32 * j) + i < C ? v[j][i] - mu : 0.f;
        q2 += d * d;
      }
    for (int o = 16; o > 0; o >>= 1) q2 += __shfl_xor_sync(~0u, q2, o);
    const float rs = rsqrtf(q2 / C + eps);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = lane + 32 * j, valid = C - 8 * q;
      if (q >= kq) continue;
      float sc[8], bi[8];
      bw_get8(sc, ln_s + 8 * q, valid);
      bw_get8(bi, ln_b + 8 * q, valid);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[j][i] = i < valid && m < M
                      ? (v[j][i] - mu) * rs * sc[i] + bi[i] : 0.f;
    }
  } else if (m < M) {
    const float* sb = sca + (m / hw) * C;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = lane + 32 * j;
      if (q >= kq) continue;
      float sv[8];
      bw_get8(sv, sb + 8 * q, C - 8 * q);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[j][i] *= sv[i];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = lane + 32 * j;
    if (q < kq)
      *reinterpret_cast<uint4*>(at + bw_tiled_off(m, 8 * q, kp)) =
          bw_pack8(v[j]);
  }
}

template <bool kLn, typename T>
cudaError_t naf_tiled_rows(const T* src, const float* sca,
                           const __nv_bfloat16* ln_s,
                           const __nv_bfloat16* ln_b, unsigned char* at,
                           long long M, int hw, int C, float eps,
                           cudaStream_t stream) {
  const long long Mp = (M + 127) / 128 * 128;
  naf_tiled_rows_kernel<kLn, T><<<unsigned(Mp / 8), 256, 0, stream>>>(
      src, sca, ln_s, ln_b, at, M, Mp, hw, C, bw_up(C, kBwK), eps);
  return cudaGetLastError();
}

// u = conv1 + b1 (fp32, [M][2C], columns 2j and 2j + 1 the halves' channel
// j, as conv1's interleaved layout leaves them).
struct NafUEpi {
  const __nv_bfloat16* b1;
  float* u;
  long long M;
  int C;
  static constexpr int kVecs = 1;
  __device__ __forceinline__ const __nv_bfloat16* vec(int) const {
    return b1;
  }
  __device__ __forceinline__ int n() const { return 2 * C; }
  __device__ __forceinline__ BwNone load(long long, int) const { return {}; }
  __device__ __forceinline__ float2 stage(int n, float v0, float v1,
                                          const float* vs, int) const {
    const int j = n / 2 < C ? n / 2 : 0;
    return make_float2(v0 + vs[j], v1 + vs[C + j]);
  }
  __device__ __forceinline__ void operator()(long long m, int n, float2 t,
                                             const float*, int,
                                             BwNone) const {
    if (m < M && n < 2 * C)
      *reinterpret_cast<float2*>(u + m * 2 * C + n) = t;
  }
};

// g = SimpleGate(dw3x3(u) + db) from the interleaved u above C 256, and the
// pool's sums a tile: a block is an 8 x 8 tile of pixels x 32 channels
// (thread: channel c0 + t % 32, column t / 32, walking the tile's rows with
// the 3 x 3 window of both halves, float2, in registers; zero padding),
// the taps summed in the JAX kernel's order; partials [B, tiles, C].
__global__ void __launch_bounds__(256)
naf_dwgate_kernel(const float* __restrict__ u,
                  const __nv_bfloat16* __restrict__ dk,
                  const __nv_bfloat16* __restrict__ db,
                  float* __restrict__ g, float* __restrict__ partials, int H,
                  int W, int C) {
  __shared__ float red[8][32];
  const int j = threadIdx.x % 32, col = threadIdx.x / 32;
  const int ch = blockIdx.y * 32 + j, b = blockIdx.z;
  const int tiles_x = (W + kNafDwTile - 1) / kNafDwTile;
  const int y0 = (blockIdx.x / tiles_x) * kNafDwTile;
  const int x = (blockIdx.x % tiles_x) * kNafDwTile + col;
  const long long C2 = 2LL * C;
  const float* ub = u + (long long)b * H * W * C2;
  float sum = 0.f;
  if (ch < C && x < W) {
    float ka[9], kb[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      ka[k] = bw_f(dk[k * C2 + ch]);
      kb[k] = bw_f(dk[k * C2 + C + ch]);
    }
    const float ba = bw_f(db[ch]), bb = bw_f(db[C + ch]);
    auto U = [&](int yy, int xx) {
      return yy < 0 || yy >= H || xx < 0 || xx >= W
                 ? make_float2(0.f, 0.f)
                 : __ldg(reinterpret_cast<const float2*>(
                       ub + ((long long)yy * W + xx) * C2 + 2 * ch));
    };
    float2 w[3][3];  // w[r][d]: row y - 1 + r, column x - 1 + d
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      w[1][d] = U(y0 - 1, x - 1 + d);
      w[2][d] = U(y0, x - 1 + d);
    }
    for (int i = 0; i < kNafDwTile && y0 + i < H; ++i) {
      const int y = y0 + i;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        w[0][d] = w[1][d];
        w[1][d] = w[2][d];
        w[2][d] = U(y + 1, x - 1 + d);
      }
      float sa = w[0][0].x * ka[0], sb = w[0][0].y * kb[0];
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        sa = sa + w[k / 3][k % 3].x * ka[k];
        sb = sb + w[k / 3][k % 3].y * kb[k];
      }
      const float v = (sa + ba) * (sb + bb);
      g[(((long long)b * H + y) * W + x) * C + ch] = v;
      sum += v;
    }
  }
  red[col][j] = sum;
  __syncthreads();
  if (col == 0 && ch < C) {
    float t = 0.f;
    for (int k = 0; k < 8; ++k) t += red[k][j];
    partials[((long long)b * gridDim.x + blockIdx.x) * C + ch] = t;
  }
}

cudaError_t naf_gate_launch(const NafGateArgs& a, cudaStream_t stream) {
  static int allowed[64] = {};
  const int bytes = naf_gate_smem(a.C, a.stages);
  cudaError_t err = bw_allow(naf_gate_wgmma_kernel, bytes, allowed);
  if (err != cudaSuccess) return err;
  naf_gate_wgmma_kernel<<<unsigned(a.B * a.tiles_x * a.tiles_y), 288, bytes,
                          stream>>>(a);
  return cudaGetLastError();
}

template <int BN>
cudaError_t naf_apply_launch(const NafApplyArgs& a, cudaStream_t stream) {
  static int allowed[64] = {};
  const int bytes = naf_apply_smem(a.C);
  cudaError_t err = bw_allow(naf_apply_wgmma_kernel<BN>, bytes, allowed);
  if (err != cudaSuccess) return err;
  naf_apply_wgmma_kernel<BN>
      <<<unsigned((a.M + 63) / 64), 160, bytes, stream>>>(a);
  return cudaGetLastError();
}

bool naf_bf16_refused(long long M, int C) {
  return M <= 0 || C <= 0 || C % 2 || C > 1024 || (M + 63) / 64 > 0x7fffffff;
}

}  // namespace

#ifdef BW_PROFILE
extern "C" int ff_bw_prof_naf(void* dst) {  // csrc/bench/wgmma_variants.py
  void* at = nullptr;
  cudaError_t err = cudaMemcpyFromSymbol(dst, bw_prof, sizeof(bw_prof));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&at, bw_prof);
  if (err == cudaSuccess) err = cudaMemset(at, 0, sizeof(bw_prof));
  return int(err);  // read, then cleared for the next call
}
#endif

// Gate tiles a bf16 call's image of H x W pixels at C channels has (the
// partials' middle axis).
extern "C" int ff_nafblock_bf16_tiles(int H, int W, int C) {
  if (!naf_fused(C))
    return ((H + kNafDwTile - 1) / kNafDwTile) *
           ((W + kNafDwTile - 1) / kNafDwTile);
  return ((H + kNafOutH - 1) / kNafOutH) * ((W + 13) / 14);
}

// Bytes of scratch a bf16 call on B H W = M pixels of C channels needs;
// -1 for a width it refuses (odd, or above 1024).
extern "C" long long ff_nafblock_bf16_scratch_bytes(long long M, int C) {
  return naf_bf16_refused(M, C) ? -1 : naf_bf16_layout(M, C).bytes;
}

// Pass A, bf16. x [B, H, W, C]; ln1 [C] x2; w1l conv1's layout
// (ops/wgmma.py:weight_layout of [C, 2C], halves interleaved, 128 columns
// a chunk), 16-byte aligned; b1 [2C]; dk [3, 3, 2C]; db [2C]: bf16
// contiguous. partials [B, ff_nafblock_bf16_tiles(H, W, C), C] fp32;
// scratch of ff_nafblock_bf16_scratch_bytes bytes (16-byte aligned), which
// pass B reads.
extern "C" int ff_nafblock_gate_bf16(const void* x, const void* ln1_s,
                                     const void* ln1_b, const void* w1l,
                                     const void* b1, const void* dk,
                                     const void* db, float* partials,
                                     void* scratch, long long scratch_bytes,
                                     int B, int H, int W, int C, float eps,
                                     void* stream_) {
  const long long M = (long long)B * H * W;
  if (naf_bf16_refused(M, C) || scratch_bytes < naf_bf16_layout(M, C).bytes ||
      reinterpret_cast<size_t>(scratch) % 16 ||
      reinterpret_cast<size_t>(w1l) % 16)
    return int(cudaErrorInvalidValue);
  auto in = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  float* g = static_cast<float*>(scratch);
  if (!naf_fused(C)) {  // LN1 tiled, conv1 on bw_tiled, then the gate
    const NafBf16Layout l = naf_bf16_layout(M, C);
    char* sc = static_cast<char*>(scratch);
    unsigned char* at = reinterpret_cast<unsigned char*>(sc + l.at);
    float* u = reinterpret_cast<float*>(sc + l.u);
    cudaError_t err = naf_tiled_rows<true>(in(x), nullptr, in(ln1_s),
                                           in(ln1_b), at, M, H * W, C, eps,
                                           stream);
    if (err == cudaSuccess)
      err = bw_tiled<128>(BwTiled{at, w1l, M, bw_up(C, kBwK), (C + 63) / 64},
                          NafUEpi{in(b1), u, M, C}, stream);
    if (err != cudaSuccess) return int(err);
    naf_dwgate_kernel<<<dim3(unsigned(ff_nafblock_bf16_tiles(H, W, C)),
                             unsigned((C + 31) / 32), unsigned(B)),
                        256, 0, stream>>>(u, in(dk), in(db), g, partials, H,
                                          W, C);
    return int(cudaGetLastError());
  }
  const NafGateArgs a{in(x), in(ln1_s), in(ln1_b), w1l, in(b1), in(dk),
                      in(db), g, partials, B, H, W, C, (W + 13) / 14,
                      (H + kNafOutH - 1) / kNafOutH, naf_gate_stages(C),
                      eps};
  if ((long long)B * a.tiles_x * a.tiles_y > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  return int(naf_gate_launch(a, stream));
}

// Pass B, bf16, after pass A on the same scratch. s [B, C] fp32; x [B, H,
// W, C]; w3l, w4l, w5l the layouts of conv3 [C, C], conv4 [C, 2C] (halves
// interleaved) and conv5 [C, C] at naf_apply_bn(C) columns a chunk
// (16-byte aligned); b3, beta, ln2 [C] x2, b4 [2C], b5, gamma [C], out [B,
// H, W, C]: bf16.
extern "C" int ff_nafblock_apply_bf16(
    const float* sca, const void* x, const void* w3l, const void* b3,
    const void* beta, const void* ln2_s, const void* ln2_b, const void* w4l,
    const void* b4, const void* w5l, const void* b5, const void* gamma,
    void* out, void* scratch_, long long scratch_bytes, int B, int H, int W,
    int C, float eps, void* stream_) {
  const long long M = (long long)B * H * W;
  if (naf_bf16_refused(M, C) || scratch_bytes < naf_bf16_layout(M, C).bytes ||
      reinterpret_cast<size_t>(scratch_) % 16 ||
      (reinterpret_cast<size_t>(w3l) | reinterpret_cast<size_t>(w4l) |
       reinterpret_cast<size_t>(w5l)) % 16)
    return int(cudaErrorInvalidValue);
  auto in = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  const NafBf16Layout l = naf_bf16_layout(M, C);
  char* sc = static_cast<char*>(scratch_);
  const NafApplyArgs a{reinterpret_cast<const float*>(sc + l.g), sca, in(x),
                       w3l, w4l, w5l, in(b3), in(beta), in(ln2_s),
                       in(ln2_b), in(b4), in(b5), in(gamma),
                       static_cast<__nv_bfloat16*>(out), M, H * W, C, eps};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (naf_fused(C))
    return int(naf_apply_bn(C) == 64 ? naf_apply_launch<64>(a, stream)
                                     : naf_apply_launch<128>(a, stream));
  // above C 256: both operands streamed (bw_tiled), 128 rows x 128
  // columns a block; A made in the tiled order by the rows passes and by
  // conv4's epilogue
  const int kp = bw_up(C, kBwK), n3 = (C + 127) / 128;
  const int n4 = (2 * C + 127) / 128;
  const long long Mp = (M + 127) / 128 * 128;
  float* y = reinterpret_cast<float*>(sc + l.y);
  unsigned char* at = reinterpret_cast<unsigned char*>(sc + l.at);
  unsigned char* g2 = reinterpret_cast<unsigned char*>(sc + l.g2);
  cudaError_t err = naf_tiled_rows<false>(a.g, sca, nullptr, nullptr, at, M,
                                          H * W, C, eps, stream);
  if (err == cudaSuccess)  // y = x + beta (GS W3 + b3)
    err = bw_tiled<128>(BwTiled{at, w3l, M, kp, n3}, NafYEpi{a, y}, stream);
  if (err == cudaSuccess)  // T2 = bf16(LN2(y))
    err = naf_tiled_rows<true>(y, nullptr, a.ln_s, a.ln_b, at, M, H * W, C,
                               eps, stream);
  if (err == cudaSuccess)  // g2, tiled
    err = bw_tiled<128>(BwTiled{at, w4l, M, kp, n4},
                        NafG2Epi{a, g2, Mp, kp}, stream);
  if (err == cudaSuccess)  // out = bf16(y + gamma (g2 W5 + b5))
    err = bw_tiled<128>(BwTiled{g2, w5l, M, kp, n3}, NafOutEpi{a, y},
                        stream);
  return int(err);
}
