// DRCT window attention with its qkv and output projections, fp32:
//     out = (softmax(q k^T * scale + bias + mask) v) Wproj + bproj,
//     q | k | v = x Wqkv + bqkv
// per ws x ws window and head, straight from NHWC x.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_attention.py:
// fused_window_attention_qkv_nhwc (:709), which FREQFUSION_ATTN_QKV=1
// routes DRCT-L's 60 Swin blocks through
// (freqfusion_tpu/models/drct.py:116).
//
// What bounds it on the H100: operations. At DRCT-L's widths (C = 180..308,
// window 16) a pixel costs 8 C^2 FLOPs of projections and 4 * 256 C of
// attention, 9.5 ms a call at 336x512 on the fp32 cores (67 TFLOP/s);
// the bytes of x and out are 0.3 ms of it at 3.35 TB/s. Every product
// runs in 3xTF32 on the tensor cores (three TF32 products an fp32 one at
// 495 TFLOP/s: 0.76 ms a call at C 244); the fp32 register-tiled SGEMM
// this replaces ran the projections at 26-29 TFLOP/s.
//
// Design: six launches on the caller's stream, each written here or in
// window_attention.cuh / tf32_gemm.cuh, with no library call:
//   1. Wqkv and Wproj split into hi/lo fragment order, zero-padded;
//   2. x into the GEMM's tiled A layout (K padded to 16 with zeros);
//   3. qkv = x Wqkv + bqkv, tf32_gemm.cuh's 3xTF32 GEMM, written
//      row-major into a [B, H, W, 3C] scratch;
//   4. the window attention of window_attention.cuh (3xTF32 on the
//      tensor cores, a cp.async K/V ring), reading q, k and v as the
//      column thirds of that scratch (row stride 3 C), into a
//      [B, H, W, C] scratch;
//   5. the attention's output into the tiled A layout;
//   6. out = attn Wproj + bproj, the same GEMM.
// The TPU kernel keeps q/k/v in VMEM to save their HBM round trip; here
// that round trip (write and re-read 4 C floats a pixel, about 0.5 ms a
// call at C = 308) is a twentieth of the operations' bound, while fusing
// the projections into the attention block would cost it the shared
// memory its Q tile and K/V ring hold (one head's K/V at hd 122 alone is
// 250 KB, over a block's 227 KB; one window's x at C 308 is 315 KB). So
// the projections stay separate launches, on the GEMM the NAFBlock's
// products share. Its A is read as bulk copies of tiled() stages, so x and
// the attention's output each take a rows pass into that layout (read C,
// write kp floats a pixel: ~0.13 ms a pass at C 308), which is cheaper
// than copying row-major A into shared memory by every warp of a block
// (fused_mlp.cu's notes: 1.3-1.5x slower there).
//
// bf16 form: ff_window_attention_qkv_nhwc_bf16, for the bf16 expert mode,
// with the JAX kernel's rounding points (_qkv_kernel_body, :655-678, run
// on bf16 operands): qkv = bf16(x Wqkv + bqkv) with the products' sums
// and the bias add in fp32 (:666); #1's bf16 attention (window_attention.cu,
// _attn_heads at dt bf16: the q-scale rounded, logits, bias and mask in
// fp32, the softmax in fp32 and normalised before it is rounded, P V in
// fp32, each head rounded); out = bf16(attn Wproj + bproj) (:676). Seven
// launches, no library call:
//   1. Wqkv and Wproj zero-padded to [kp][np] bf16 (bf16_gemm.cuh's
//      bg_pad, two launches);
//   2. x into rows padded to kp (bg_rows: C 180 is 360 bytes a row, not
//      the 16-byte multiple the GEMM's copies take);
//   3. q | k | v = bf16(x Wqkv + bqkv) on bf16_gemm.cuh's GEMM (bf16
//      mma.sync m16n8k16, fp32 sums), whose epilogue writes q, k and v as
//      three contiguous [B, H, W, C] bf16 tensors;
//   4. the bf16 window attention of #1 (ff_window_attention_nhwc_bf16)
//      over them, as it is, into a [B, H, W, C] bf16 scratch;
//   5. that into padded rows; 6. out = bf16(attn Wproj + bproj), the same
//      GEMM.
// The epilogue writes q, k and v apart (and not one [M, 3C] tensor with
// the attention reading column thirds through a row stride) because it
// moves the same bytes either way and #1's bf16 body then runs unchanged,
// the kernel the default bf16 route times. What bounds it is the same as
// in fp32 at half the bytes: at 336x512 and C 180 the products are 47
// GFLOP a call, 0.05 ms at 989 TFLOP/s, and x and out 0.12 GB, 0.04 ms;
// this first version moves q, k, v, the attention's output and two padded
// row copies through device memory besides (~0.5 GB a call at C 180).

#include "bf16_gemm.cuh"
#include "tf32_gemm.cuh"
#include "window_attention.cuh"

// window_attention.cu: #1's bf16 kernel (q, k, v, out [B, H, W, C] bf16;
// bias [heads, N, N] bf16; mask [nW, N, N] fp32 or null)
extern "C" int ff_window_attention_nhwc_bf16(const void* q, const void* k,
                                             const void* v, const void* bias,
                                             const float* mask, void* out,
                                             int B, int H, int W, int C,
                                             int num_heads, int ws,
                                             float scale, void* stream);

namespace {

// Padded extents and the scratch's layout, as ops/attention.py:
// plan_qkv_projections computes them.
struct QkvPlan {
  int kpi, kpc;    // Cin and C rounded up to kBK: the two products' K
  int npq, npp;    // 3C and C padded to their block widths
  int mp;          // M rounded up to 128: A's rows
  long long wq, wp, a, total;  // floats: the two splits, the A buffer
};

QkvPlan qkv_plan(long long M, int Cin, int C) {
  QkvPlan p;
  p.kpi = int(round_up(Cin, kBK));
  p.kpc = int(round_up(C, kBK));
  p.npq = int(round_up(3 * C, gemm_cols(3 * C)));
  p.npp = int(round_up(C, gemm_cols(C)));
  p.mp = int(round_up(M, kGemmRows));
  p.wq = 2LL * p.kpi * p.npq;
  p.wp = 2LL * p.kpc * p.npp;
  p.a = (long long)p.mp * (p.kpi > p.kpc ? p.kpi : p.kpc);
  p.total = p.wq + p.wp + p.a;
  return p;
}

}  // namespace

// Floats of scratch a call on M pixels of Cin channels, C out, needs (the
// two splits and the tiled A, which x and then the attention's output
// take); -1 for widths it refuses.
extern "C" long long ff_window_attention_qkv_scratch_floats(long long M,
                                                            int Cin, int C) {
  if (Cin > kGemmMaxC || C > kGemmMaxC || M > 0x7fffff00LL) return -1;
  return qkv_plan(M, Cin, C).total;
}

// x [B, H, W, Cin]; wqkv [Cin, 3C] (q | k | v columns), bqkv [3C];
// wproj [C, C] ([in, out]), bproj [C]; bias [heads, N, N]; mask [nW, N, N]
// or null; qkv [B, H, W, 3C] and attn [B, H, W, C] scratch; out
// [B, H, W, C]; scratch (16-byte aligned) of
// ff_window_attention_qkv_scratch_floats(B H W, Cin, C) floats. All fp32
// contiguous; H % ws == 0 == W % ws. hdp and vec: the attention's plan
// (ops/attention.py:plan_window_attention, row stride 3 C).
extern "C" int ff_window_attention_qkv_nhwc(
    const float* x, const float* wqkv, const float* bqkv, const float* wproj,
    const float* bproj, const float* bias, const float* mask, float* qkv,
    float* attn, float* out, float* scratch, long long scratch_floats,
    int B, int H, int W, int Cin, int C, int num_heads, int ws, float scale,
    int hdp, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * H * W;
  const long long need = ff_window_attention_qkv_scratch_floats(M, Cin, C);
  if (M <= 0 || need < 0 || scratch_floats < need ||
      reinterpret_cast<size_t>(scratch) % 16)
    return int(cudaErrorInvalidValue);
  const QkvPlan p = qkv_plan(M, Cin, C);
  float* wq = scratch;
  float* wp = wq + p.wq;
  float* a = wp + p.wp;
  const SplitJobs<2> jobs{
      {SplitJob{wqkv, nullptr, wq, Cin, 3 * C, 3 * C, p.npq, 0, 1,
                (long long)p.kpi / 8 * (p.npq / 8) * 32},
       SplitJob{wproj, nullptr, wp, C, C, C, p.npp, 0, 1,
                (long long)p.kpc / 8 * (p.npp / 8) * 32}}};
  const int m = int(M);
  cudaError_t err = gemm_split(jobs, s);
  if (err == cudaSuccess)
    err = gemm_rows<2>(x, Cin, nullptr, nullptr, 0.f, a, 1, p.mp, m, Cin,
                       p.kpi, s);
  if (err == cudaSuccess)
    err = gemm_launch<kEpiBias>(
        GemmArgs{a, wq, 0, p.kpi, p.npq, 3 * C, p.mp, m, bqkv, qkv,
                 3 * C, nullptr, nullptr},
        1, s);
  if (err == cudaSuccess)
    err = window_attention_launch(qkv, qkv + C, qkv + 2 * C, 3 * C, bias,
                                  mask, attn, B, H, W, C, num_heads, ws,
                                  scale, hdp, vec, s);
  if (err == cudaSuccess)
    err = gemm_rows<2>(attn, C, nullptr, nullptr, 0.f, a, 1, p.mp, m, C,
                       p.kpc, s);
  if (err == cudaSuccess)
    err = gemm_launch<kEpiBias>(
        GemmArgs{a, wp, 0, p.kpc, p.npp, C, p.mp, m, bproj, out, C,
                 nullptr, nullptr},
        1, s);
  return int(err);
}

namespace {

// The bf16 call's scratch (byte offsets), each piece 256-byte aligned.
struct QkvBf16Layout {
  int kpi, kpc, npq, npp;  // the products' K (Cin, C padded to 32), N
  long long wq, wp, a, q, k, v, attn, bytes;
};

QkvBf16Layout qkv_bf16_layout(long long M, int Cin, int C) {
  QkvBf16Layout l;
  l.kpi = bg_up(Cin, kBgK);
  l.kpc = bg_up(C, kBgK);
  l.npq = bg_up(3 * C, kBgN);
  l.npp = bg_up(C, kBgN);
  const int ka = l.kpi > l.kpc ? l.kpi : l.kpc;
  l.wq = 0;
  l.wp = l.wq + bg_piece(2LL * l.kpi * l.npq);
  l.a = l.wp + bg_piece(2LL * l.kpc * l.npp);
  l.q = l.a + bg_piece(2 * M * ka);
  l.k = l.q + bg_piece(2 * M * C);
  l.v = l.k + bg_piece(2 * M * C);
  l.attn = l.v + bg_piece(2 * M * C);
  l.bytes = l.attn + bg_piece(2 * M * C);
  return l;
}

}  // namespace

// Bytes of scratch a bf16 call on M pixels of Cin channels, C out, needs
// (qkv_bf16_layout); -1 for widths it refuses.
extern "C" long long ff_window_attention_qkv_bf16_scratch_bytes(
    long long M, int Cin, int C) {
  if (M <= 0 || Cin <= 0 || C <= 0 || Cin > 2048 || C > 2048 || C % 2)
    return -1;
  return qkv_bf16_layout(M, Cin, C).bytes;
}

// As ff_window_attention_qkv_nhwc, all bf16 but the mask (fp32, 8-byte
// aligned, or null): x [B, H, W, Cin]; wqkv [Cin, 3C], bqkv [3C], wproj
// [C, C], bproj [C], bias [heads, N, N] (4-byte aligned); out [B, H, W,
// C]; scratch of ff_window_attention_qkv_bf16_scratch_bytes(B H W, Cin, C)
// bytes, 16-byte aligned. C even; N = ws * ws a multiple of 16 up to 256;
// head dims up to 128.
extern "C" int ff_window_attention_qkv_nhwc_bf16(
    const void* x_, const void* wqkv_, const void* bqkv_, const void* wproj_,
    const void* bproj_, const void* bias, const float* mask, void* out_,
    void* scratch_, long long scratch_bytes, int B, int H, int W, int Cin,
    int C, int num_heads, int ws, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * H * W;
  const long long need = ff_window_attention_qkv_bf16_scratch_bytes(M, Cin,
                                                                    C);
  if (need < 0 || scratch_bytes < need ||
      reinterpret_cast<size_t>(scratch_) % 16)
    return int(cudaErrorInvalidValue);
  const QkvBf16Layout l = qkv_bf16_layout(M, Cin, C);
  char* scratch = static_cast<char*>(scratch_);
  auto piece = [&](long long off) {
    return reinterpret_cast<bf16*>(scratch + off);
  };
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* bqkv = static_cast<const bf16*>(bqkv_);
  const bf16* bproj = static_cast<const bf16*>(bproj_);
  bf16* out = static_cast<bf16*>(out_);
  bf16 *wq = piece(l.wq), *wp = piece(l.wp), *a = piece(l.a);
  bf16 *q = piece(l.q), *k = piece(l.k), *v = piece(l.v);
  bf16* attn = piece(l.attn);
  cudaError_t err = bg_pad(static_cast<const bf16*>(wqkv_), 3 * C, 1, Cin,
                           l.kpi, 3 * C, 0, wq, l.kpi, l.npq, s);
  if (err == cudaSuccess)
    err = bg_pad(static_cast<const bf16*>(wproj_), C, 1, C, l.kpc, C, 0, wp,
                 l.kpc, l.npp, s);
  if (err == cudaSuccess)
    err = bg_rows(x, M, Cin, nullptr, nullptr, 0.f, a, l.kpi, s);
  if (err == cudaSuccess)
    err = bg_gemm(BgRows{a, M, l.kpi}, M, wq, l.npq, l.kpi, l.npq,
                  BgSegEpi{bqkv, {q, k, v}, M, C, 3}, s);
  if (err != cudaSuccess) return int(err);
  const int rc = ff_window_attention_nhwc_bf16(q, k, v, bias, mask, attn, B,
                                               H, W, C, num_heads, ws, scale,
                                               stream);
  if (rc != 0) return rc;
  err = bg_rows(static_cast<const bf16*>(attn), M, C, nullptr, nullptr, 0.f,
                a, l.kpc, s);
  if (err == cudaSuccess)
    err = bg_gemm(BgRows{a, M, l.kpc}, M, wp, l.npp, l.kpc, l.npp,
                  BgSegEpi{bproj, {out, nullptr, nullptr}, M, C, 1}, s);
  return int(err);
}
