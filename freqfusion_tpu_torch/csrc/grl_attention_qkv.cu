// GRL mixed attention with its 6-way qkv projection: the window half's q,
// k, v projected from x_rolled (x rolled by (-s, -s) for shifted blocks,
// else x), the stripe half's from x, with wqkv's column segments qw | kw |
// vw | qs | ks | vs (each C/2 of [C, 3C]), then both halves' attention.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_attention.py:
// fused_grl_mixed_attention_qkv_nhwc (:795), which FREQFUSION_GRL_QKV=1
// routes GRL-B's 40 blocks through (freqfusion_tpu/models/grl.py:403).
//
// What bounds it on the H100: operations. The projection is 2 * 180 * 540
// FLOPs a pixel, about six times the attention's, 39.4 GFLOP a 336x512
// call: 0.24 ms as three TF32 products each at 495 TFLOP/s (0.59 ms on the
// fp32 cores); its bytes (x, x_rolled, the anchor and two C/2 outputs
// once) are 0.23 ms.
//
// Design: the window_attention_qkv.cu route, launches on the caller's
// stream, each written here or in tf32_gemm.cuh / grl_attention.cuh:
//   1. both halves' weights (columns 0..3C2 and 3C2..6C2) split into
//      hi/lo fragment order, zero-padded (one launch, two jobs);
//   2. x_rolled (x where unshifted) into the GEMM's tiled A layout;
//   3. the window half's q|k|v = A W_w + b_w, tf32_gemm.cuh's 3xTF32 GEMM,
//      row-major [M, 3 C2] into the scratch;
//   4. (shifted only) x into the tiled A layout;
//   5. the stripe half's q|k|v = A W_s + b_s into a second [M, 3 C2];
//   6. grl_attention.cuh's body, each half reading its q|k|v as the
//      column thirds of its scratch rows: a tile row is one bulk copy.
// The TPU kernel keeps q/k/v in VMEM to save their HBM round trip. Here
// the round trip (6 C2 floats a pixel written and read, ~0.2 ms a call)
// buys the projection its tensor-core GEMM: the in-block fp32 projection
// this replaces ran at ~6% of the fp32 cores' bound's rate, each head's
// block re-reading the tile's x.
//
// bf16 form: ff_grl_mixed_attention_qkv_nhwc_bf16, for the bf16 expert
// mode, with the JAX kernel's rounding points (_grl_qkv_body, :459-489, on
// bf16 operands): each half's q | k | v = bf16(x W + b) with fp32 sums and
// bias add (:475-481), then #2's bf16 mixed attention (grl_attention.cu,
// _grl_mixed_core at bf16: q, k and the anchors normalised and rounded,
// the softmaxes in fp32 rounded before their products, x1 and both
// outputs rounded). Launches, no library call:
//   1. the two halves' weight columns zero-padded to [kp][np] bf16
//      (bf16_gemm.cuh's bg_pad, a launch each);
//   2. x_rolled (x where unshifted) into rows padded to kp (bg_rows: Cin
//      180 is 360 bytes a row, not the 16-byte multiple the GEMM's copies
//      take);
//   3. the window half's q | k | v on bf16_gemm.cuh's GEMM (bf16 mma.sync,
//      fp32 sums), the epilogue writing qw, kw, vw as three contiguous
//      [B, H, W, C2] bf16 tensors, the layout #2's bf16 entry takes;
//   4. (shifted only) x into padded rows; 5. the stripe half's qs, ks, vs;
//   6. #2's bf16 kernel (ff_grl_mixed_attention_nhwc_bf16) as it is.
// What bounds it: at 336x512 the projection is 33.4 GFLOP a call, 0.03 ms
// at 989 TFLOP/s, and x (twice where shifted), the anchor and the two
// outputs ~0.19 GB, 0.06 ms; this first version moves the six halves and
// the padded rows through device memory besides.

#include "bf16_gemm.cuh"
#include "grl_attention.cuh"
#include "tf32_gemm.cuh"

// grl_attention.cu: #2's bf16 kernel (halves and anchor bf16; scales,
// biases and mask fp32)
extern "C" int ff_grl_mixed_attention_nhwc_bf16(
    const void* qw, const void* kw, const void* vw, const void* qs,
    const void* ks, const void* vs, const void* anchor, const float* scale_w,
    const float* scale_s1, const float* scale_s2, const float* bias_w,
    const float* bias_s1, const float* bias_s2, const float* mask,
    void* out_w, void* out_s, int B, int H, int W, int C2, int heads_w,
    int heads_s, int ws, int df, void* stream);

namespace {

// Padded extents and the scratch's layout, as ops/attention.py:
// plan_grl_qkv_projections computes them.
struct GrlQkvPlan {
  int kp;          // Cin rounded up to kBK: the products' K
  int np;          // 3 C2 padded to its block width
  int mp;          // M rounded up to 128: A's rows
  long long w, a, qkv, total;  // floats: one half's split, A, one q|k|v
};

GrlQkvPlan grl_qkv_plan(long long M, int Cin, int C2) {
  GrlQkvPlan p;
  p.kp = int(round_up(Cin, kBK));
  p.np = int(round_up(3 * C2, gemm_cols(3 * C2)));
  p.mp = int(round_up(M, kGemmRows));
  p.w = 2LL * p.kp * p.np;
  p.a = (long long)p.mp * p.kp;
  p.qkv = round_up(M * 3 * C2, 4);
  p.total = 2 * p.w + p.a + 2 * p.qkv;
  return p;
}

}  // namespace

// Floats of scratch a call on M pixels of Cin channels (halves of C2)
// needs: both halves' split weights, the tiled A (x_rolled, then x) and
// both halves' q|k|v; -1 for widths it refuses.
extern "C" long long ff_grl_qkv_scratch_floats(long long M, int Cin,
                                               int C2) {
  if (Cin > kGemmMaxC || C2 <= 0 || M <= 0 || M > 0x7fffff00LL) return -1;
  return grl_qkv_plan(M, Cin, C2).total;
}

// x [B, H, W, Cin]; x_rolled the same shape, or null (unshifted: the
// window half projects from x); anchor [B, H/2, W/2, C2]; wqkv
// [Cin, 6 C2], bqkv [6 C2] (qw | kw | vw | qs | ks | vs); scales, biases
// and mask as ff_grl_mixed_attention_nhwc; out_w, out_s [B, H, W, C2];
// scratch (16-byte aligned) of ff_grl_qkv_scratch_floats(B H W, Cin, C2)
// floats. All fp32 contiguous; ws 8, df 2.
extern "C" int ff_grl_mixed_attention_qkv_nhwc(
    const float* x, const float* x_rolled, const float* anchor,
    const float* wqkv, const float* bqkv, const float* scale_w,
    const float* scale_s1, const float* scale_s2, const float* bias_w,
    const float* bias_s1, const float* bias_s2, const float* mask,
    float* out_w, float* out_s, float* scratch, long long scratch_floats,
    int B, int H, int W, int Cin, int C2, int heads_w, int heads_s, int ws,
    int df, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * H * W;
  const long long need = ff_grl_qkv_scratch_floats(M, Cin, C2);
  if (ws != kGrlWs || df != kGrlWs / kGrlAws || need < 0 ||
      scratch_floats < need || reinterpret_cast<size_t>(scratch) % 16)
    return int(cudaErrorInvalidValue);
  const GrlQkvPlan p = grl_qkv_plan(M, Cin, C2);
  float* ww = scratch;
  float* wsp = ww + p.w;
  float* a = wsp + p.w;
  float* qkv_w = a + p.a;
  float* qkv_s = qkv_w + p.qkv;
  const long long units = (long long)p.kp / 8 * (p.np / 8) * 32;
  const SplitJobs<2> jobs{
      {SplitJob{wqkv, nullptr, ww, Cin, 3 * C2, 6 * C2, p.np, 0, 1, units},
       SplitJob{wqkv + 3 * C2, nullptr, wsp, Cin, 3 * C2, 6 * C2, p.np, 0, 1,
                units}}};
  const int m = int(M);
  auto project = [&](const float* src, const float* w, const float* bias,
                     float* out, bool rows) {
    cudaError_t err = cudaSuccess;
    if (rows)
      err = gemm_rows<2>(src, Cin, nullptr, nullptr, 0.f, a, 1, p.mp, m, Cin,
                         p.kp, s);
    if (err == cudaSuccess)
      err = gemm_launch<kEpiBias>(
          GemmArgs{a, w, 0, p.kp, p.np, 3 * C2, p.mp, m, bias, out, 3 * C2,
                   nullptr, nullptr},
          1, s);
    return err;
  };
  cudaError_t err = gemm_split(jobs, s);
  if (err == cudaSuccess)
    err = project(x_rolled ? x_rolled : x, ww, bqkv, qkv_w, true);
  if (err == cudaSuccess)
    err = project(x, wsp, bqkv + 3 * C2, qkv_s, x_rolled != nullptr);
  if (err != cudaSuccess) return int(err);
  const GrlArgs g{
      {GrlHalf{qkv_w, qkv_w + C2, qkv_w + 2 * C2, 3 * C2, 1, heads_w,
               scale_w, nullptr, bias_w, nullptr, mask, out_w},
       GrlHalf{qkv_s, qkv_s + C2, qkv_s + 2 * C2, 3 * C2, 1, heads_s,
               scale_s1, scale_s2, bias_s1, bias_s2, nullptr, out_s}},
      anchor, H, W, C2};
  return int(grl_attention_launch(g, B, s));
}

namespace {

// The bf16 call's scratch (byte offsets), each piece 256-byte aligned:
// the two halves' padded weights, the padded rows, the six halves.
struct GrlQkvBf16Layout {
  int kp, np;  // Cin padded to 32, 3 C2 to 64
  long long w[2], a, half[6], bytes;
};

GrlQkvBf16Layout grl_qkv_bf16_layout(long long M, int Cin, int C2) {
  GrlQkvBf16Layout l;
  l.kp = bg_up(Cin, kBgK);
  l.np = bg_up(3 * C2, kBgN);
  l.w[0] = 0;
  l.w[1] = bg_piece(2LL * l.kp * l.np);
  l.a = 2 * l.w[1];
  long long off = l.a + bg_piece(2 * M * l.kp);
  for (int i = 0; i < 6; ++i) {
    l.half[i] = off;
    off += bg_piece(2 * M * C2);
  }
  l.bytes = off;
  return l;
}

}  // namespace

// Bytes of scratch a bf16 call on M pixels of Cin channels, halves of C2,
// needs (grl_qkv_bf16_layout); -1 for widths it refuses.
extern "C" long long ff_grl_qkv_bf16_scratch_bytes(long long M, int Cin,
                                                   int C2) {
  if (M <= 0 || Cin <= 0 || Cin > 2048 || C2 <= 0 || C2 % 2) return -1;
  return grl_qkv_bf16_layout(M, Cin, C2).bytes;
}

// As ff_grl_mixed_attention_qkv_nhwc with x, x_rolled (or null), the
// anchor, wqkv, bqkv and both outputs bf16, the scales, biases and mask
// fp32 (8-byte aligned); scratch of ff_grl_qkv_bf16_scratch_bytes(B H W,
// Cin, C2) bytes, 16-byte aligned. C2 even.
extern "C" int ff_grl_mixed_attention_qkv_nhwc_bf16(
    const void* x_, const void* x_rolled_, const void* anchor,
    const void* wqkv_, const void* bqkv_, const float* scale_w,
    const float* scale_s1, const float* scale_s2, const float* bias_w,
    const float* bias_s1, const float* bias_s2, const float* mask,
    void* out_w, void* out_s, void* scratch_, long long scratch_bytes, int B,
    int H, int W, int Cin, int C2, int heads_w, int heads_s, int ws, int df,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * H * W;
  const long long need = ff_grl_qkv_bf16_scratch_bytes(M, Cin, C2);
  if (need < 0 || scratch_bytes < need ||
      reinterpret_cast<size_t>(scratch_) % 16)
    return int(cudaErrorInvalidValue);
  const GrlQkvBf16Layout l = grl_qkv_bf16_layout(M, Cin, C2);
  char* scratch = static_cast<char*>(scratch_);
  auto piece = [&](long long off) {
    return reinterpret_cast<bf16*>(scratch + off);
  };
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* xr = x_rolled_ ? static_cast<const bf16*>(x_rolled_) : x;
  const bf16* wqkv = static_cast<const bf16*>(wqkv_);
  const bf16* bqkv = static_cast<const bf16*>(bqkv_);
  bf16* a = piece(l.a);
  bf16* h[6];
  for (int i = 0; i < 6; ++i) h[i] = piece(l.half[i]);
  cudaError_t err = cudaSuccess;
  for (int half = 0; half < 2 && err == cudaSuccess; ++half)
    err = bg_pad(wqkv + 3 * C2 * half, 6 * C2, 1, Cin, l.kp, 3 * C2, 0,
                 piece(l.w[half]), l.kp, l.np, s);
  // the window half from x_rolled, the stripe half from x (the rows pass
  // again only where the two differ)
  for (int half = 0; half < 2 && err == cudaSuccess; ++half) {
    if (half == 0 || x_rolled_)
      err = bg_rows(half ? x : xr, M, Cin, nullptr, nullptr, 0.f, a, l.kp,
                    s);
    if (err == cudaSuccess)
      err = bg_gemm(BgRows{a, M, l.kp}, M, piece(l.w[half]), l.np, l.kp,
                    l.np,
                    BgSegEpi{bqkv + 3 * C2 * half,
                             {h[3 * half], h[3 * half + 1], h[3 * half + 2]},
                             M, C2, 3},
                    s);
  }
  if (err != cudaSuccess) return int(err);
  return ff_grl_mixed_attention_nhwc_bf16(
      h[0], h[1], h[2], h[3], h[4], h[5], anchor, scale_w, scale_s1,
      scale_s2, bias_w, bias_s1, bias_s2, mask, out_w, out_s, B, H, W, C2,
      heads_w, heads_s, ws, df, stream);
}
