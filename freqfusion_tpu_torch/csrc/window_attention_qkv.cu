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
// _attn_heads at dt bf16: the q-scale rounded, logits in fp32 plus the
// bias and the mask, the mask cast to bf16 as the JAX wrapper casts it
// (:773), the softmax in fp32 and normalised before it is rounded, P V in
// fp32, each head rounded); out = bf16(attn Wproj + bproj) (:676). Three
// launches, no library call, no per-call weight pass (the two weights come
// laid out in wgmma's order, once per module: ops/wgmma.py):
//   1. q | k | v = bf16(x Wqkv + bqkv) on bf16_wgmma.cuh's GEMM (wgmma
//      m64nBNk16, 64 rows a block: one warpgroup, three blocks an SM,
//      where two warpgroups of 128 rows held one and took 1.08-1.31x as
//      long, csrc/bench/wgmma_variants.py; x staged from its rows as they
//      lie, the weight streamed by bulk copies through an mbarrier ring),
//      whose epilogue writes q, k and v as three contiguous [B, H, W, C]
//      bf16 tensors;
//   2. the bf16 window attention of #1 (ff_window_attention_nhwc_bf16)
//      over them, as it is, into a [B, H, W, C] bf16 scratch;
//   3. out = bf16(attn Wproj + bproj), the same GEMM reading that scratch
//      as it lies.
// The epilogue writes q, k and v apart (and not one [M, 3C] tensor with
// the attention reading column thirds through a row stride) because it
// moves the same bytes either way and #1's bf16 body then runs unchanged,
// the kernel the default bf16 route times. What bounds it: the
// operations, 8 C^2 FLOPs a pixel of products (47 GFLOP a call at 336x512
// and C 180, 0.05 ms at 989 TFLOP/s) besides #1's; device memory moves x
// in, q, k, v out and back, the attention's output out and back, and out:
// 20 C bytes a pixel (0.07 ms a call at C 180).

#include "bf16_wgmma.cuh"
#include "tf32_gemm.cuh"
#include "window_attention.cuh"

// window_attention.cu: #1's bf16 kernel (q, k, v, out [B, H, W, C] bf16;
// bias [heads, N, N] and mask [nW, N, N] (or null) bf16)
extern "C" int ff_window_attention_nhwc_bf16(const void* q, const void* k,
                                             const void* v, const void* bias,
                                             const void* mask, void* out,
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
  long long q, k, v, attn, bytes;
};

QkvBf16Layout qkv_bf16_layout(long long M, int C) {
  const long long piece = (2 * M * C + 255) / 256 * 256;
  return QkvBf16Layout{0, piece, 2 * piece, 3 * piece, 4 * piece};
}

// Cin's staged rows: 64 rows a block, K padded to 32 (80 KB at most).
constexpr int kQkvMaxK = 640;

// out_s[m, c] = bf16(v + bias[n]) for n = s width + c < segs width: the
// product's columns cut into `segs` (at most 3) contiguous [M, width] bf16
// tensors, width even (q | k | v, or the one output); the bias staged in
// shared memory (vs).
struct QkvSegEpi {
  const __nv_bfloat16* bias;
  __nv_bfloat16 *out0, *out1, *out2;
  long long M;
  int width, segs;
  static constexpr int kVecs = 1;
  __device__ __forceinline__ const __nv_bfloat16* vec(int) const {
    return bias;
  }
  __device__ __forceinline__ int n() const { return segs * width; }
  __device__ __forceinline__ BwNone load(long long, int) const { return {}; }
  __device__ __forceinline__ uint32_t stage(int n, float v0, float v1,
                                            const float* vs, int) const {
    return pack_bf16(v0 + vs[n], v1 + vs[n + 1]);
  }
  __device__ __forceinline__ void operator()(long long m, int n, uint32_t t,
                                             const float*, int,
                                             BwNone) const {
    if (m >= M || n >= segs * width) return;
    const bool s0 = n < width, s1 = n < 2 * width;
    __nv_bfloat16* o = s0 ? out0 : s1 ? out1 : out2;
    const int c = s0 ? n : s1 ? n - width : n - 2 * width;
    *reinterpret_cast<uint32_t*>(o + m * width + c) = t;
  }
};

template <int BN>
cudaError_t qkv_project(const __nv_bfloat16* a, long long M, int K,
                        const void* wl, int N, const __nv_bfloat16* bias,
                        __nv_bfloat16* o0, __nv_bfloat16* o1,
                        __nv_bfloat16* o2, int segs, cudaStream_t s) {
  const BwGemm g{wl, M, bw_up(K, kBwK), (N + BN - 1) / BN};
  return bw_gemm<1, BN>(g, BwRows{a, M, K},
                        QkvSegEpi{bias, o0, o1, o2, M, N / segs, segs}, 0,
                        s);
}

cudaError_t qkv_project(int bn, const __nv_bfloat16* a, long long M, int K,
                        const void* wl, int N, const __nv_bfloat16* bias,
                        __nv_bfloat16* o0, __nv_bfloat16* o1,
                        __nv_bfloat16* o2, int segs, cudaStream_t s) {
  if (bn != bw_cols(N)) return cudaErrorInvalidValue;
  if (bn == 64)
    return qkv_project<64>(a, M, K, wl, N, bias, o0, o1, o2, segs, s);
  return qkv_project<96>(a, M, K, wl, N, bias, o0, o1, o2, segs, s);
}

}  // namespace

#ifdef BW_PROFILE
extern "C" int ff_bw_prof_qkv(void* dst) {  // csrc/bench/wgmma_variants.py
  void* at = nullptr;
  cudaError_t err = cudaMemcpyFromSymbol(dst, bw_prof, sizeof(bw_prof));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&at, bw_prof);
  if (err == cudaSuccess) err = cudaMemset(at, 0, sizeof(bw_prof));
  return int(err);  // read, then cleared for the next call
}
#endif

// Bytes of scratch a bf16 call on M pixels of Cin channels, C out, needs
// (q, k, v and the attention's output); -1 for widths it refuses.
extern "C" long long ff_window_attention_qkv_bf16_scratch_bytes(
    long long M, int Cin, int C) {
  if (M <= 0 || Cin <= 0 || C <= 0 || Cin % 2 || C % 2 ||
      bw_up(Cin, kBwK) > kQkvMaxK || bw_up(C, kBwK) > kQkvMaxK)
    return -1;
  return qkv_bf16_layout(M, C).bytes;
}

// As ff_window_attention_qkv_nhwc, all bf16 (the mask 16-byte aligned, or
// null): x [B, H, W, Cin]; wq and wp the two weights in
// wgmma's order (ops/wgmma.py:weight_layout of wqkv [Cin, 3C] at bnq
// columns a chunk and of wproj [C, C] at bnp; bnq = bw_cols(3 C), bnp =
// bw_cols(C)), 16-byte aligned; bqkv [3C], bproj [C], bias [heads, N, N]
// (16-byte aligned); out [B, H, W, C]; scratch of
// ff_window_attention_qkv_bf16_scratch_bytes(B H W, Cin, C) bytes,
// 16-byte aligned. Cin and C even; N = ws * ws a multiple of 16 up to
// 256; head dims up to 128.
extern "C" int ff_window_attention_qkv_nhwc_bf16(
    const void* x_, const void* wq, const void* bqkv_, const void* wp,
    const void* bproj_, const void* bias, const void* mask, void* out_,
    void* scratch_, long long scratch_bytes, int B, int H, int W, int Cin,
    int C, int num_heads, int ws, float scale, int bnq, int bnp,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * H * W;
  const long long need = ff_window_attention_qkv_bf16_scratch_bytes(M, Cin,
                                                                    C);
  if (need < 0 || scratch_bytes < need ||
      reinterpret_cast<size_t>(scratch_) % 16)
    return int(cudaErrorInvalidValue);
  const QkvBf16Layout l = qkv_bf16_layout(M, C);
  char* scratch = static_cast<char*>(scratch_);
  auto piece = [&](long long off) {
    return reinterpret_cast<__nv_bfloat16*>(scratch + off);
  };
  __nv_bfloat16 *q = piece(l.q), *k = piece(l.k), *v = piece(l.v);
  __nv_bfloat16* attn = piece(l.attn);
  cudaError_t err = qkv_project(
      bnq, static_cast<const __nv_bfloat16*>(x_), M, Cin, wq, 3 * C,
      static_cast<const __nv_bfloat16*>(bqkv_), q, k, v, 3, s);
  if (err != cudaSuccess) return int(err);
  const int rc = ff_window_attention_nhwc_bf16(q, k, v, bias, mask, attn, B,
                                               H, W, C, num_heads, ws, scale,
                                               stream);
  if (rc != 0) return rc;
  return int(qkv_project(bnp, attn, M, C, wp, C,
                         static_cast<const __nv_bfloat16*>(bproj_),
                         static_cast<__nv_bfloat16*>(out_), nullptr, nullptr,
                         1, s));
}
