// Stage 3 of the fusion net's hierarchical fusion plus to_rgb, at HR, fp32:
//   a   = gelu(conv3x3(s3_in) + b)          76 -> 64
//   a   = gelu(conv3x3(a) + b)              64 -> 32
//   f   = a * sigmoid(gelu(a G0 + g0) g2 + g2b)   SpatialGate, 32 -> 8 -> 1
//   f3  = f + scale * conv3x3(gelu(conv3x3(f)))  FusionResBlock, no biases
//         + rw23 * s3_in[..., :32]                cross-stage residual
//   out = sigmoid(conv3x3(gelu(conv3x3(f3) + b)) + b)   to_rgb, 32 -> 16 -> 3
// with exact (erf) GELU and zero padding at the image edges.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_hier.py:
// hier_stage3_fused (:147), which FREQFUSION_HIER=1 routes the full-HR
// stage of the hierarchical fusion through
// (freqfusion_tpu/models/fusion/hierarchical.py:97): one call a request,
// 1344x2048 at the 336x512 bucket.
//
// What bounds it on the H100: the six 3x3 convs, 9 x 2 x 9520 FLOPs per
// pixel (471.7 GFLOP at 1344x2048: 7.04 ms on the fp32 cores at 67
// TFLOP/s, 2.86 ms as three TF32 products at 495 TFLOP/s) against 79
// channels of 4 bytes in and out per pixel (0.87 GB, 0.26 ms at 3.35
// TB/s). The old body ran the convs as register-tiled fp32 FMA loops
// (27.4 ms on an H100 at 700 W), held by FMA issue. So
// every conv runs on the tensor cores in 3xTF32, as an implicit GEMM
// (csrc/conv3x3_tf32.cuh, #15's convolution without its LayerNorm): 9.5-9.6
// ms there, the convs at ~125-150 TFLOP/s of tensor work.
//
// The TPU kernel runs the chain in one halo-6 pass. On this card a 16 x 16
// output tile's 28 x 28 x 76 input block is 238 KB, over a block's 227 KB,
// and the chain's stages want different tiles, so the call is seven
// launches through two scratch tensors at HR (64 and 32 channels, NHWC):
// the six convs' weights split once into fragment order, conv0 (two
// blocks of 4 n-tiles a tile: 8 n-tiles a warp spill at 128 registers),
// conv1 with the SpatialGate in its epilogue (its 32 channels
// are one block's: the squeeze's sums go over a lane quad by shuffles),
// the residual block's two convs (the second with both residuals in its
// epilogue, in place), all four on 24 x 16 tiles (3 m-tiles a warp),
// to_rgb's two convs on 32 x 16 tiles (2 and 1
// n-tiles; the last, Cout 3 padded to 8, writes the output in the input's
// layout). Each intermediate makes one round trip through device memory,
// about 1.6 KB a pixel in all (4.4 GB, 1.3 ms at 3.35 TB/s). Zero padding
// comes from each conv reading a whole image from device memory.
//
// bf16 (ff_hier_stage3_bf16): see its note below, after the fp32 entry.

#include "conv3x3_tf32.cuh"

using namespace conv3x3_tf32;

namespace {

// n-tiles a block of each conv (conv0, conv1, r0, r2, t0, t2)
constexpr int kNT[6] = {4, 4, 4, 4, 2, 1};

struct HierPlan {
  int cin[6], cout[6], cinp[6], coutp[6];
  long long off[7];  // floats: conv i's split weights at off[i]
};

// The fp32 convs' extents: stages of 8 channels, 18 cinp coutp floats of
// split weights a conv.
HierPlan hier_plan(int Cin, int C1) {
  const int c2 = C1 / 2, ct = C1 / 4;
  const int cin[6] = {Cin, C1, c2, c2, c2, ct};
  const int cout[6] = {C1, c2, c2, c2, ct, 3};
  HierPlan q;
  q.off[0] = 0;
  for (int i = 0; i < 6; ++i) {
    q.cin[i] = cin[i];
    q.cout[i] = cout[i];
    q.cinp[i] = (cin[i] + kCK - 1) / kCK * kCK;
    q.coutp[i] = (cout[i] + 8 * kNT[i] - 1) / (8 * kNT[i]) * 8 * kNT[i];
    q.off[i + 1] = q.off[i] + 18LL * q.cinp[i] * q.coutp[i];
  }
  return q;
}

}  // namespace

// Floats of scratch ff_hier_stage3 needs: the six convs' weights split,
// 18 cinp coutp floats each.
extern "C" long long ff_hier_scratch_floats(int Cin, int C1) {
  return hier_plan(Cin, C1).off[6];
}

// s3 [B, H, W, Cin] and out [B, H, W, 3], NHWC-contiguous or (nchw)
// NCHW-contiguous; conv kernels [3, 3, Cin', Cout'] with C1 = 64 (bc):
// w0 (Cin -> C1) + b0, w2 (C1 -> C1/2) + b2, r0 / r2 (C1/2 -> C1/2, no
// bias), t0 (C1/2 -> C1/4) + t0b, t2 (C1/4 -> 3) + t2b; the gate's g0
// [C1/2, C1/8] + g0b, g2 [C1/8] + g2b [1]; scale, rw23 one float each on
// the card; scratch buf64 [B, H, W, C1], buf32 [B, H, W, C1/2] and the
// split weights' (ff_hier_scratch_floats, 16-byte aligned). All fp32.
extern "C" int ff_hier_stage3(const float* s3, int nchw, const float* w0,
                              const float* b0, const float* w2,
                              const float* b2, const float* g0,
                              const float* g0b, const float* g2,
                              const float* g2b, const float* r0,
                              const float* r2, const float* t0,
                              const float* t0b, const float* t2,
                              const float* t2b, const float* scale,
                              const float* rw23, float* buf64, float* buf32,
                              float* scratch, long long scratch_floats,
                              float* out, int B, int H, int W, int Cin, int C1,
                              void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (C1 != 64 || Cin < C1 / 2 || scratch_floats < ff_hier_scratch_floats(
                                                       Cin, C1) ||
      reinterpret_cast<size_t>(scratch) % 16)
    return int(cudaErrorInvalidValue);
  const HierPlan q = hier_plan(Cin, C1);
  const float* w[6] = {w0, w2, r0, r2, t0, t2};
  SplitJobs<6> jobs;
  for (int i = 0; i < 6; ++i)
    jobs.job[i] = split_job(hwio(w[i], 3, q.cin[i], q.cout[i]),
                            scratch + q.off[i], q.cin[i], q.cout[i],
                            q.coutp[i], kNT[i]);
  cudaError_t e = split(jobs, stream);
  if (e != cudaSuccess) return int(e);

  const int c2 = C1 / 2, ct = C1 / 4;
  const T4 in = tensor(s3, H, W, Cin, nchw);
  const T4 a64 = tensor(buf64, H, W, C1, 0), a32 = tensor(buf32, H, W, c2, 0);
  const T4 g32 = tensor(buf64, H, W, c2, 0), r16 = tensor(buf64, H, W, ct, 0);
  const int vec_in = vec_ok(s3, Cin, nchw);
  auto wt = [&](int i) { return scratch + q.off[i]; };
  int err;

  Conv p = plain(in, Cin, vec_in, wt(0), b0, C1, q.coutp[0], kGelu, buf64,
                 a64, H, W);
  if ((err = launch<4, 3>(p, B, stream))) return err;
  p = plain(a64, C1, 1, wt(1), b2, c2, q.coutp[1], kGelu, buf32, a32, H, W);
  p.g0 = g0;
  p.g0b = g0b;
  p.g2 = g2;
  p.g2b = g2b;
  if ((err = launch<4, 3, kSpatialGate>(p, B, stream))) return err;
  p = plain(a32, c2, 1, wt(2), nullptr, c2, q.coutp[2], kGelu, buf64, g32, H,
            W);
  if ((err = launch<4, 3>(p, B, stream))) return err;
  p = plain(g32, c2, 1, wt(3), nullptr, c2, q.coutp[3], kNone, buf32, a32, H,
            W);
  p.r1 = a32;
  p.alpha = scale;
  p.r2 = in;  // its first c2 channels
  p.beta = rw23;
  if ((err = launch<4, 3>(p, B, stream))) return err;
  p = plain(a32, c2, 1, wt(4), t0b, ct, q.coutp[4], kGelu, buf64, r16, H, W);
  if ((err = launch<2, 4>(p, B, stream))) return err;
  p = plain(r16, ct, 1, wt(5), t2b, 3, q.coutp[5], kSigmoid, out,
            tensor(out, H, W, 3, nchw), H, W);
  return launch<1, 4>(p, B, stream);
}


// ---------------------------------------------------------------------------
// bf16 (ff_hier_stage3_bf16, FREQFUSION_HIER=1 with the fusion net in bf16:
// the JAX kernel on bf16 s3_in and weights), with the JAX kernel's rounding
// points (pallas_hier.py:56-98): each conv's input rounded to bf16 (zero
// outside the image), fp32 sums, the bias added in fp32, GELU in fp32; the
// gate's two 1x1 operands rounded to bf16; f = a sigmoid(g) kept in fp32 for
// the residual, its bf16 rounding what block_0 reads; f3 = f + scale rb +
// rw23 s3_in[..., :32] in fp32, rounded for to_rgb_0; the output the
// sigmoid, then rounded. A value that stays in fp32 on the TPU and goes
// through device memory here (f) goes in fp32.
//
// What bounds it on the H100: the six convs, 471.7 GFLOP at 1344x2048,
// 0.48 ms at 989 TFLOP/s; s3_in's 76 channels in and 3 out are 0.43 GB,
// 0.13 ms at 3.35 TB/s.
//
// Design: six launches of one kernel, hier_wgmma_kernel<Cinp, N, rows,
// epilogue>, each conv on wgmma as the bf16 CAB's convs run (cab.cu): a
// block stages the halo of its output rows once, [8-channel group][halo
// pixel][8 values], so that 8 consecutive pixels of a halo row are one
// core matrix; the A operand of tap (dy, dx) for 64 consecutive output
// pixels of a row is that halo through a descriptor whose start moves by
// (dy 66 + dx) 16 bytes. No im2col, no pack launch. The weights come laid
// out once per module (ops/wgmma.py:conv_layouts, [Cin / 16][tap][core
// matrices], from the module's views of its parameters) and each block
// copies all of them into shared memory once (92 KB at conv0), for it is
// persistent: one block an SM walks the tiles (rows x 64 pixels), a
// staging warpgroup filling the next tile's halo (a ring of two) while two
// consumer warpgroups, half the rows each, run the current one's wgmmas
// and epilogue (64 sums a thread at most). But for conv0, whose staging
// gathers, setmaxnreg hands the staging warpgroup's registers to the
// consumers (56 and 224 a thread: 168 x 384, the block's whole
// allocation): at ptxas's 168 for all, block_0's GELU epilogue spilled.
//   conv0     76 -> 64, 4 rows a tile (its 64 sums a thread): the staging
//             warpgroup gathers s3_in's 8-channel groups from the NHWC
//             tensor or the module's NCHW view itself (zeros past channel
//             76 and outside the image); + b0, GELU;
//   conv1     64 -> 32, 8 rows, + b2, GELU, the SpatialGate in the
//             epilogue (the squeeze on mma.sync, as conv3x3_tf32.cuh's bf16
//             gate: a pixel's 32 channels lie in one quad), f fp32 out and
//             its bf16 rounding;
//   block_0   32 -> 32, 8 rows, GELU;
//   block_2   32 -> 32, 8 rows, f3 = f + scale rb + rw23 s3_in[..., :32];
//   to_rgb_0  32 -> 16, 8 rows, + t0b, GELU;
//   to_rgb_2  16 -> 3 (N 8), 8 rows, + t2b, sigmoid, out in s3_in's layout.
// The bf16 intermediates lie group-planar, [Cout / 8][B H W][8], so that a
// halo row of one group is one bulk copy (66 pixels x 16 bytes, issued by
// one staging thread; its lanes zero what lies outside the image) and a
// warp's epilogue stores of one group are whole 128-byte lines (lanes on
// consecutive pixels): the epilogues store straight from the fragments,
// with no staging tile. What crosses device memory a pixel, the halos'
// re-reads counted ((rows + 2) 66 / (rows 64): 1.55 at conv0's 4 rows,
// 1.29 at 8): s3_in ~235 bytes, a0 128 out and ~165 in, f 128 (fp32) and
// 64 (bf16) out, f 128 in again, rb's GELU and f3 64 out and ~82 in each,
// s3_in's first 32 channels 64, to_rgb_0's GELU 32 out and ~41 in, the
// output 6: ~1.37 KB, ~3.8 GB at 1344x2048 (~1.1 ms at 3.35 TB/s). No
// stage is fused behind a halo: a variant that ran block_0 with block_2
// and to_rgb_0 with to_rgb_2 as pairs (the first conv's output kept in
// shared memory as the second's halo, 8 rows x 62 columns a tile, the
// first conv over 10 x 64) kept ~180 bytes a pixel out of device memory
// but took 1.07 ms for the four convs against these launches' 0.97 on an
// H100 (the two convs in turn in each block, the first one's work 1.29x).

#include "bf16_wgmma.cuh"

namespace {

using hb16 = __nv_bfloat16;

constexpr int kHbSeg = 64;       // output pixels of an m-tile: a row's
constexpr int kHbHw = kHbSeg + 2;  // halo columns
constexpr int kHbHead = 128;     // the barriers, at the head of smem
constexpr int kHbThreads = 384;  // two consumer warpgroups, one staging
constexpr int kHbWeightChunk = 16384;  // bytes of a weight bulk copy

enum HbEpi { kHbGelu = 0, kHbGate = 1, kHbRes = 2, kHbRgb = 3 };

// A conv: Cin padded to CINP (16s), Cout to N, R output rows a tile.
template <int CINP, int N, int R>
struct HbConv {
  static constexpr int kGroups = CINP / 8;
  static constexpr int kHalo = (R + 2) * kHbHw;  // halo pixels
  static constexpr int kHaloBytes = kGroups * kHalo * 16;
  static constexpr int kWeightBytes = 9 * CINP * N * 2;
  static constexpr int kSmem = kHbHead + kWeightBytes + 2 * kHaloBytes;
  static_assert(CINP % 16 == 0 && R % 2 == 0 && kSmem <= 232448,
                "a block's smem; half the rows a consumer warpgroup");
};

// The six convs: (Cin padded, N, rows), as ops/hier.py:plan_hier_bf16.
constexpr int kHbCinp[6] = {80, 64, 32, 32, 32, 16};
constexpr int kHbN[6] = {64, 32, 32, 32, 16, 8};
constexpr int kHbRows[6] = {4, 8, 8, 8, 8, 8};

struct HbT {  // a bf16 tensor [B, H, W, C] by its strides (elements)
  const hb16* p;
  long long sb, sy, sx, sc;
};

struct HbArgs {
  const hb16* src;     // planar input [Cinp / 8][B H W][8]
  HbT s3;              // conv0's input (gather) and block_2's residual
  int cin;             // s3's channels
  const void* w;       // the conv's layout (ops/wgmma.py:conv_layout at N)
  const hb16* bias;    // [Cout] or null
  hb16* out;           // planar output [N / 8][B H W][8]
  float* f;            // kHbGate: f out, kHbRes: f in, [B H W][32] fp32
  const hb16 *g0, *g0b, *g2, *g2b;  // kHbGate: [32, 8], [8], [8], [1]
  const hb16 *scale, *rw23;         // kHbRes
  hb16* rgb;           // kHbRgb: [B, H, W, 3] by its strides
  long long ob, oy, ox, oc;
  int B, H, W;
};

__device__ __forceinline__ float hb_f(hb16 v) { return __bfloat162float(v); }

// Tile t: image b, first row y0, first column x0.
template <int R>
__device__ __forceinline__ void hb_tile(const HbArgs& a, long long t, int& b,
                                        int& y0, int& x0) {
  const int tx = (a.W + kHbSeg - 1) / kHbSeg, ty = (a.H + R - 1) / R;
  x0 = int(t % tx) * kHbSeg;
  y0 = int((t / tx) % ty) * R;
  b = int(t / ((long long)tx * ty));
}

template <int CINP, int N, int R, int EPI, bool GATHER>
__global__ void __launch_bounds__(kHbThreads, 1)
hier_wgmma_kernel(const HbArgs a) {
  using C = HbConv<CINP, N, R>;
  static_assert(EPI != kHbGate || N == 32, "the gate's squeeze: 32 channels");
  extern __shared__ __align__(128) unsigned char hb_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(hb_smem);  // [2]
  uint64_t* empty = full + 2;                              // [2]
  uint64_t* wbar = full + 4;
  unsigned char* ws = hb_smem + kHbHead;
  unsigned char* halo = ws + C::kWeightBytes;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long tiles = (long long)a.B * ((a.H + R - 1) / R) *
                          ((a.W + kHbSeg - 1) / kHbSeg);
  const long long bhw = (long long)a.B * a.H * a.W;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 4);   // a staging warp each
      mbar_init(&empty[s], 8);  // a consumer warp each
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= 256) {  // the staging warpgroup
    if constexpr (!GATHER) bw_regs_dec<56>();
    const int st = tid - 256;
    if (st == 0) {  // the weights, once
      mbar_arrive_expect_tx(wbar, C::kWeightBytes);
      for (int o = 0; o < C::kWeightBytes; o += kHbWeightChunk)
        bulk_copy(ws + o, static_cast<const unsigned char*>(a.w) + o,
                  min(kHbWeightChunk, C::kWeightBytes - o), wbar);
    }
    int i = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
      const int s = i & 1;
      int b, y0, x0;
      hb_tile<R>(a, t, b, y0, x0);
      mbar_wait(&empty[s], ((i >> 1) & 1) ^ 1);
      unsigned char* hs = halo + s * C::kHaloBytes;
      if constexpr (GATHER) {
        // item e: group e / kHalo, halo pixel e % kHalo (consecutive
        // threads on consecutive pixels), 8 channels, zeros past Cin and
        // outside the image; 8 items' loads in flight a thread
        constexpr int kItems = C::kGroups * C::kHalo, kBatch = 8;
        const bool vec = a.s3.sc == 1;
        for (int e0 = st; e0 < kItems; e0 += 128 * kBatch) {
          uint4 v[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int e = e0 + 128 * k, p = e % C::kHalo, c0 = 8 * (e / C::kHalo);
            const int y = y0 - 1 + p / kHbHw, x = x0 - 1 + p % kHbHw;
            v[k] = make_uint4(0u, 0u, 0u, 0u);
            if (e < kItems && y >= 0 && y < a.H && x >= 0 && x < a.W &&
                c0 < a.cin) {
              const hb16* q = a.s3.p + b * a.s3.sb + y * a.s3.sy +
                              x * a.s3.sx + c0 * a.s3.sc;
              if (vec) {
                v[k] = bw_load8(q, a.cin - c0);
              } else {
                const unsigned short* u = reinterpret_cast<const unsigned short*>(q);
                uint32_t w[8];
#pragma unroll
                for (int c = 0; c < 8; ++c)
                  w[c] = c0 + c < a.cin ? __ldg(u + c * a.s3.sc) : 0u;
                v[k] = make_uint4(w[0] | w[1] << 16, w[2] | w[3] << 16,
                                  w[4] | w[5] << 16, w[6] | w[7] << 16);
              }
            }
          }
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int e = e0 + 128 * k;
            if (e < kItems) *reinterpret_cast<uint4*>(hs + e * 16) = v[k];
          }
        }
        fence_proxy_async();  // the halo, before wgmma reads it
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      } else {
        // the halo's rows of each group by bulk copies of the pixels inside
        // the image; the lanes zero the rest first
        const int xs = max(x0 - 1, 0), xe = min(x0 + kHbSeg + 1, a.W);
        const bool edge = x0 == 0 || xe < x0 + kHbSeg + 1 || y0 == 0 ||
                          y0 + R + 1 > a.H;
        if (edge) {
          for (int e = st; e < C::kGroups * C::kHalo; e += 128) {
            const int p = e % C::kHalo;
            const int y = y0 - 1 + p / kHbHw, x = x0 - 1 + p % kHbHw;
            if (y < 0 || y >= a.H || x < 0 || x >= a.W)
              *reinterpret_cast<uint4*>(hs + e * 16) =
                  make_uint4(0u, 0u, 0u, 0u);
          }
          fence_proxy_async();  // the zeros, before wgmma reads them
        }
        __syncwarp();
        if (lane == 0) {
          if (st == 0) {
            const int y_lo = max(y0 - 1, 0), y_hi = min(y0 + R + 1, a.H);
            const uint32_t row = uint32_t(xe - xs) * 16;
            mbar_arrive_expect_tx(
                &full[s], uint32_t(C::kGroups * (y_hi - y_lo)) * row);
            for (int g = 0; g < C::kGroups; ++g)
              for (int y = y_lo; y < y_hi; ++y)
                bulk_copy(hs + (g * C::kHalo + (y - y0 + 1) * kHbHw +
                                (xs - x0 + 1)) * 16,
                          a.src + (g * bhw + ((long long)b * a.H + y) * a.W +
                                   xs) * 8,
                          row, &full[s]);
          } else {
            mbar_arrive(&full[s]);
          }
        }
      }
    }
    return;
  }
  // the consumer warpgroups, cw taking rows R / 2 cw .. of a tile: d[4 j +
  // 2 h + e] of its m-tile r is output row y0 + R / 2 cw + r, pixel x0 +
  // 16 warp + g + 8 h (warp of 4 in the warpgroup), channel 8 j + 2 t + e
  if constexpr (!GATHER) bw_regs_inc<224>();
  constexpr int kR = R / 2;
  const int cw = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  mbar_wait(wbar, 0);
  // the squeeze's G0 as mma.sync B fragments: k16 block kb, unit g
  uint32_t gb[2][2] = {{0u, 0u}, {0u, 0u}};
  float gw[2] = {0.f, 0.f}, gbias[2] = {0.f, 0.f}, g2b = 0.f;
  if constexpr (EPI == kHbGate) {
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      const int ci = 16 * kb + 2 * t;
      gb[kb][0] = pack_bf16(hb_f(a.g0[ci * 8 + g]), hb_f(a.g0[(ci + 1) * 8 + g]));
      gb[kb][1] = pack_bf16(hb_f(a.g0[(ci + 8) * 8 + g]),
                            hb_f(a.g0[(ci + 9) * 8 + g]));
    }
    gw[0] = hb_f(a.g2[2 * t]);
    gw[1] = hb_f(a.g2[2 * t + 1]);
    gbias[0] = hb_f(a.g0b[2 * t]);
    gbias[1] = hb_f(a.g0b[2 * t + 1]);
    g2b = hb_f(a.g2b[0]);
  }
  float bv[N / 8][2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t + e;
      bv[j][e] = a.bias && (EPI != kHbRgb || c < 3) ? hb_f(a.bias[c]) : 0.f;
    }
  const float scale = EPI == kHbRes ? hb_f(a.scale[0]) : 0.f;
  const float rw23 = EPI == kHbRes ? hb_f(a.rw23[0]) : 0.f;
  int i = 0;
  for (long long tt = blockIdx.x; tt < tiles; tt += gridDim.x, ++i) {
    const int s = i & 1;
    int b, y0, x0;
    hb_tile<R>(a, tt, b, y0, x0);
    mbar_wait(&full[s], (i >> 1) & 1);
    const unsigned char* hs = halo + s * C::kHaloBytes;
    float acc[kR][N / 2];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int k = 0; k < N / 2; ++k) acc[r][k] = 0.f;
      bw_fence_acc(acc[r]);
    }
    bw_fence();
#pragma unroll
    for (int kk = 0; kk < CINP / 16; ++kk)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int r = 0; r < kR; ++r)
          bw_mma<N>(acc[r],
                    bw_desc_at(hs + (2 * kk * C::kHalo +
                                     (kR * cw + r + tap / 3) * kHbHw +
                                     tap % 3) * 16,
                               C::kHalo * 16, 128),
                    bw_desc(ws + (kk * 9 + tap) * N * 32), kk > 0 || tap > 0);
    bw_commit();
    bw_wait<0>();
#pragma unroll
    for (int r = 0; r < kR; ++r) bw_fence_acc(acc[r]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the halo read: refill it
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int y = y0 + kR * cw + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = x0 + 16 * warp + g + 8 * h;
        const bool in = y < a.H && x < a.W;
        const long long px = ((long long)b * a.H + y) * a.W + x;
        float v[N / 8][2];
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) v[j][e] = acc[r][4 * j + 2 * h + e] + bv[j][e];
        if constexpr (EPI == kHbGelu || EPI == kHbGate)
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) v[j][e] = gelu_erf(v[j][e]);
        if constexpr (EPI == kHbRes) {
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const int c = 8 * j + 2 * t;
            if (in) {
              const float2 fv = __ldg(reinterpret_cast<const float2*>(
                  a.f + px * 32 + c));
              const hb16* q = a.s3.p + b * a.s3.sb + y * a.s3.sy +
                              x * a.s3.sx + c * a.s3.sc;
              v[j][0] = fv.x + scale * v[j][0] + rw23 * hb_f(q[0]);
              v[j][1] = fv.y + scale * v[j][1] + rw23 * hb_f(q[a.s3.sc]);
            }
          }
        }
        if constexpr (EPI == kHbRgb) {
          if (in)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 2 * t + e;
              if (c < 3)
                a.rgb[b * a.ob + y * a.oy + x * a.ox + c * a.oc] =
                    __float2bfloat16_rn(sigmoidf(v[0][e]));
            }
        } else if constexpr (EPI != kHbGate) {
          if (in)
#pragma unroll
            for (int j = 0; j < N / 8; ++j)
              *reinterpret_cast<uint32_t*>(a.out + (j * bhw + px) * 8 + 2 * t) =
                  pack_bf16(v[j][0], v[j][1]);
        } else {
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) acc[r][4 * j + 2 * h + e] = v[j][e];
        }
      }
      if constexpr (EPI == kHbGate) {
        // acc[r] holds a = gelu(conv1 + b2) for both rows; the squeeze
        // (a rounded to bf16) G0 on mma.sync, as conv3x3_tf32.cuh's bf16
        // gate: the sums of channel groups 2 kb and 2 kb + 1 are the A
        // fragment of k16 block kb, G0's rows 16 kb .. its B fragment; d =
        // units 2t, 2t + 1 of rows g and g + 8
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kb = 0; kb < 2; ++kb) {
          const float* lo = acc[r] + 4 * (2 * kb);
          const float* hi = acc[r] + 4 * (2 * kb + 1);
          const uint32_t fa[4] = {pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
                                  pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3])};
          mma_bf16(d, fa, gb[kb][0], gb[kb][1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float gs = round_bf16(gelu_erf(d[2 * h] + gbias[0])) * gw[0] +
                     round_bf16(gelu_erf(d[2 * h + 1] + gbias[1])) * gw[1];
          gs += __shfl_xor_sync(0xffffffffu, gs, 1);
          gs += __shfl_xor_sync(0xffffffffu, gs, 2);
          const float gate = sigmoidf(gs + g2b);
          const int x = x0 + 16 * warp + g + 8 * h;
          if (y >= a.H || x >= a.W) continue;
          const long long px = ((long long)b * a.H + y) * a.W + x;
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const float f0 = acc[r][4 * j + 2 * h] * gate;
            const float f1 = acc[r][4 * j + 2 * h + 1] * gate;
            *reinterpret_cast<float2*>(a.f + px * 32 + 8 * j + 2 * t) =
                make_float2(f0, f1);
            *reinterpret_cast<uint32_t*>(a.out + (j * bhw + px) * 8 + 2 * t) =
                pack_bf16(f0, f1);
          }
        }
      }
    }
  }
}

template <int I, int EPI, bool GATHER>
cudaError_t hb_conv(const HbArgs& a, cudaStream_t s) {
  constexpr int kCinp = kHbCinp[I], kN = kHbN[I], kR = kHbRows[I];
  using C = HbConv<kCinp, kN, kR>;
  auto kernel = hier_wgmma_kernel<kCinp, kN, kR, EPI, GATHER>;
  static int allowed[64] = {};
  cudaError_t err = bw_allow(kernel, C::kSmem, allowed);
  int dev = 0, sms = 0, per = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                        kHbThreads, C::kSmem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)a.B * ((a.H + kR - 1) / kR) *
                          ((a.W + kHbSeg - 1) / kHbSeg);
  const long long most = (long long)sms * (per > 1 ? per : 1);
  const long long grid = tiles < most ? tiles : most;
  kernel<<<unsigned(grid), kHbThreads, C::kSmem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The plan of bf16 conv i (0 conv0, 1 conv1, 2 block_0, 3 block_2, 4
// to_rgb_0, 5 to_rgb_2), as ops/hier.py:plan_hier_bf16 computes it: into
// out[0..4] Cin padded, N, rows a tile, halo pixels, a block's shared
// memory. Returns -1 for no such conv.
extern "C" int ff_hier_bf16_plan(int i, int* out) {
  if (i < 0 || i > 5) return -1;
  const int smem[6] = {HbConv<80, 64, 4>::kSmem, HbConv<64, 32, 8>::kSmem,
                       HbConv<32, 32, 8>::kSmem, HbConv<32, 32, 8>::kSmem,
                       HbConv<32, 16, 8>::kSmem, HbConv<16, 8, 8>::kSmem};
  out[0] = kHbCinp[i];
  out[1] = kHbN[i];
  out[2] = kHbRows[i];
  out[3] = (kHbRows[i] + 2) * kHbHw;
  out[4] = smem[i];
  return 0;
}

// The bf16 version: s3 and out bf16, NHWC-contiguous or (nchw)
// NCHW-contiguous, 32 <= Cin <= 80, C1 64; the six conv weights in
// ops/wgmma.py:conv_layout's order at N 64, 32, 32, 32, 16, 8 (w0l, w2l,
// r0l, r2l, t0l, t2l), 16-byte aligned; the biases, the gate's g0 [C1/2,
// C1/8] (contiguous), g0b, g2 [C1/8], g2b [1], scale and rw23 bf16. Scratch,
// 16-byte aligned: bufa [B H W 64] bf16 (conv0's output, group-planar; then
// block_0's in its first half and f3 in its second, then to_rgb_0's in its
// first quarter), bff [B, H, W, 32] fp32 (f), bfh [B H W 32] bf16 (f
// rounded, group-planar).
extern "C" int ff_hier_stage3_bf16(
    const void* s3, int nchw, const void* w0l, const void* b0,
    const void* w2l, const void* b2, const void* g0, const void* g0b,
    const void* g2, const void* g2b, const void* r0l, const void* r2l,
    const void* t0l, const void* t0b, const void* t2l, const void* t2b,
    const void* scale, const void* rw23, void* bufa, float* bff, void* bfh,
    void* out, int B, int H, int W, int Cin, int C1, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const void* al[] = {w0l, w2l, r0l, r2l, t0l, t2l, bufa, bff, bfh};
  for (const void* v : al)
    if (reinterpret_cast<size_t>(v) % 16) return int(cudaErrorInvalidValue);
  if (C1 != 64 || Cin < C1 / 2 || Cin > kHbCinp[0] || B < 1 || H < 1 ||
      W < 1)
    return int(cudaErrorInvalidValue);
  using bf = hb16;
  const long long bhw = (long long)B * H * W;
  auto c = [](const void* v) { return static_cast<const bf*>(v); };
  bf* A = static_cast<bf*>(bufa);
  bf* fh = static_cast<bf*>(bfh);
  const HbT s3t = nchw ? HbT{c(s3), (long long)Cin * H * W, W, 1,
                             (long long)H * W}
                       : HbT{c(s3), (long long)H * W * Cin,
                             (long long)W * Cin, Cin, 1};
  HbArgs a{};
  a.s3 = s3t;
  a.cin = Cin;
  a.B = B;
  a.H = H;
  a.W = W;
  cudaError_t err;
  // conv0: s3 -> bufa (8 groups)
  a.w = w0l;
  a.bias = c(b0);
  a.out = A;
  if ((err = hb_conv<0, kHbGelu, true>(a, stream)) != cudaSuccess)
    return int(err);
  // conv1 + the gate: bufa -> f (fp32) and its rounding (bfh)
  a.src = A;
  a.w = w2l;
  a.bias = c(b2);
  a.out = fh;
  a.f = bff;
  a.g0 = c(g0);
  a.g0b = c(g0b);
  a.g2 = c(g2);
  a.g2b = c(g2b);
  if ((err = hb_conv<1, kHbGate, false>(a, stream)) != cudaSuccess)
    return int(err);
  // block_0: bfh -> bufa's first half
  a.src = fh;
  a.w = r0l;
  a.bias = nullptr;
  a.out = A;
  if ((err = hb_conv<2, kHbGelu, false>(a, stream)) != cudaSuccess)
    return int(err);
  // block_2 + both residuals: bufa's first half -> its second (f3)
  a.src = A;
  a.w = r2l;
  a.out = A + 4 * bhw * 8;
  a.scale = c(scale);
  a.rw23 = c(rw23);
  if ((err = hb_conv<3, kHbRes, false>(a, stream)) != cudaSuccess)
    return int(err);
  // to_rgb_0: f3 -> bufa's first quarter
  a.src = A + 4 * bhw * 8;
  a.w = t0l;
  a.bias = c(t0b);
  a.out = A;
  if ((err = hb_conv<4, kHbGelu, false>(a, stream)) != cudaSuccess)
    return int(err);
  // to_rgb_2: -> out, in s3's layout
  a.src = A;
  a.w = t2l;
  a.bias = c(t2b);
  a.rgb = static_cast<bf*>(out);
  if (nchw) {
    a.ob = 3LL * H * W, a.oy = W, a.ox = 1, a.oc = (long long)H * W;
  } else {
    a.ob = 3LL * H * W, a.oy = 3LL * W, a.ox = 3, a.oc = 1;
  }
  return int(hb_conv<5, kHbRgb, false>(a, stream));
}
