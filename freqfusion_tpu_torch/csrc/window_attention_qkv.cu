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

#include "tf32_gemm.cuh"
#include "window_attention.cuh"

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
