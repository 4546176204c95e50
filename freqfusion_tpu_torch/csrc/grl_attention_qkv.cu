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
// outputs rounded; the mask in bf16 as the JAX wrapper casts it, :882).
// Two launches, no library call, no per-call weight pass:
//   1. the six halves qw, kw, vw (from x_rolled, x where unshifted) and
//      qs, ks, vs (from x) on bf16_wgmma.cuh's wgmma (grl_qkv_wgmma_kernel:
//      a block 64 rows, one consumer warpgroup and a producer warp). The
//      weight comes laid out once per module (ops/wgmma.py:segment_layouts:
//      each 90-column segment of wqkv padded to its own chunk of BN
//      columns, so that one chunk's sums are exactly one output tensor's)
//      and streams through an mbarrier ring by bulk copies. The block
//      stages its rows of x_rolled and x (360-byte rows at GRL-B: no bulk
//      copy lands them in core-matrix order, so the consumers do, 8- and
//      16-byte loads), runs the window half's three chunks on x_rolled's
//      rows and the stripe half's three on x's, and each chunk's epilogue
//      (+ bias in fp32, rounded) writes the block's [64][C2] piece of that
//      output, one contiguous 16-byte aligned piece of it (11,520 bytes at
//      GRL-B), into a shared tile that leaves by one bulk store (bw_store;
//      two tiles, so that a chunk's store overlaps the next chunk's
//      products; a ragged last block stores its rows' bytes);
//   2. #2's bf16 kernel (ff_grl_mixed_attention_nhwc_bf16) as it is: its
//      persistent blocks read the six halves' tile rows by bulk copies.
// What bounds it: at 336x512 the projection is 33.4 GFLOP a call (0.03 ms
// at 989 TFLOP/s); x (twice where shifted), the six halves out and back
// in, the anchor and the two outputs ~0.45 GB (0.13 ms at 3.35 TB/s).

#include "bf16_wgmma.cuh"
#include "grl_attention.cuh"
#include "tf32_gemm.cuh"

// grl_attention.cu: #2's bf16 kernel (halves, anchor and mask bf16, the
// mask in ops/attention.py:grl_mask_layout's order; scales and biases fp32)
extern "C" int ff_grl_mixed_attention_nhwc_bf16(
    const void* qw, const void* kw, const void* vw, const void* qs,
    const void* ks, const void* vs, const void* anchor, const float* scale_w,
    const float* scale_s1, const float* scale_s2, const float* bias_w,
    const float* bias_s1, const float* bias_s2, const void* mask,
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

// The projection's A and the weight's chunks: x_rolled's rows (the window
// half) and x's (the stripe half), K padded to 32.
struct GrlQkvBf16 {
  const __nv_bfloat16* xr;  // x_rolled, or x where unshifted
  const __nv_bfloat16* x;
  const void* w;            // segment layout: 6 chunks x kp / 32 stages
  const __nv_bfloat16* bias;  // [6 C2]
  __nv_bfloat16* out[6];    // qw, kw, vw, qs, ks, vs: [M, C2] each
  long long M;
  int K, kp, C2;
};

// One block's rows staged once or twice (x_rolled and x), the weight's six
// chunks streamed, each chunk's [64][C2] piece out by one bulk store.
template <int BN>
__global__ void __launch_bounds__(160)
grl_qkv_wgmma_kernel(const GrlQkvBf16 a) {
  extern __shared__ __align__(128) unsigned char bw_smem[];
  constexpr int kRows = 64;
  BwRing r = bw_ring(bw_smem, BN * 64, 4);
  const bool two = a.xr != a.x;
  unsigned char* a0 = bw_smem + kBwHead + kBwStages * BN * 64;
  unsigned char* a1 = two ? a0 + kRows * a.kp * 2 : a0;
  const int tile_bytes = bw_up(kRows * a.C2 * 2, 16);
  unsigned char* tiles = a0 + (two ? 2 : 1) * kRows * a.kp * 2;
  float* vs = reinterpret_cast<float*>(tiles + 2 * tile_bytes);
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid >= 128) {
    if (tid == 128) bw_produce(r, a.w, 6 * (a.kp / kBwK));
    return;
  }
  const long long m0 = (long long)blockIdx.x * kRows;
  for (int i = tid; i < 6 * BN; i += 128) {
    const int sg = i / BN, c = i % BN;
    vs[i] = c < a.C2 ? __bfloat162float(a.bias[sg * a.C2 + c]) : 0.f;
  }
  BwRows{a.xr, a.M, a.K}.stage(a0, nullptr, m0, kRows, a.kp, tid, 128);
  if (two) BwRows{a.x, a.M, a.K}.stage(a1, nullptr, m0, kRows, a.kp, tid, 128);
  fence_proxy_async();  // the staged A, before wgmma reads it
  bw_sync(128);
  const long long left = a.M - m0;
  const int rows = left < kRows ? int(left) : kRows;
  const uint32_t bytes = uint32_t(rows * a.C2 * 2);
  const uint32_t bulk = bytes & ~15u;  // the rest (a ragged block's) stored
  for (int c = 0; c < 6; ++c) {
    float acc[BN / 2];
    bw_chunk<BN>(acc, c < 3 ? a0 : a1, kRows, a.kp / kBwK, r);
    unsigned char* tile = tiles + (c & 1) * tile_bytes;
    // the store two chunks back read this tile before it is filled again
    if (tid == 0) bw_store_wait_read<1>();
    bw_sync(128);
    const float* bv = vs + c * BN;
    bw_each<BN>(acc, [&](int row, int col, float v0, float v1) {
      if (col < a.C2)
        *reinterpret_cast<uint32_t*>(tile + (row * a.C2 + col) * 2) =
            pack_bf16(v0 + bv[col], v1 + bv[col + 1]);
    });
    fence_proxy_async();  // the tile, before the bulk store reads it
    bw_sync(128);
    unsigned char* dst =
        reinterpret_cast<unsigned char*>(a.out[c] + m0 * a.C2);
    if (tid == 0 && bulk) {
      bw_store(dst, tile, bulk);
      bw_store_commit();
    }
    for (uint32_t i = bulk + 2 * tid; i < bytes; i += 256)
      *reinterpret_cast<__nv_bfloat16*>(dst + i) =
          *reinterpret_cast<const __nv_bfloat16*>(tile + i);
  }
  if (tid == 0) bw_store_wait<0>();
}

// The chunk width of C2 columns: the narrowest instantiated wgmma width
// that holds them (ops/wgmma.py:segment_cols).
inline int grl_qkv_cols(int c2) {
  return c2 <= 48 ? 48 : c2 <= 64 ? 64 : c2 <= 96 ? 96 : 128;
}

inline int grl_qkv_smem(int kp, int c2, bool two) {
  const int bn = grl_qkv_cols(c2);
  return bw_smem_bytes(64, kp, bn,
                       (two ? 64 * kp * 2 : 0) + 2 * bw_up(64 * c2 * 2, 16) +
                           6 * bn * 4);
}

template <int BN>
cudaError_t grl_qkv_project(const GrlQkvBf16& a, cudaStream_t s) {
  static int allowed[64] = {};
  const int bytes = grl_qkv_smem(a.kp, a.C2, a.xr != a.x);
  const long long blocks = (a.M + 63) / 64;
  if (bytes > 227 * 1024 || blocks > 0x7fffffffLL ||
      reinterpret_cast<size_t>(a.w) % 16)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 6; ++i)
    if (reinterpret_cast<size_t>(a.out[i]) % 16) return cudaErrorInvalidValue;
  if (blocks <= 0) return cudaSuccess;
  cudaError_t err = bw_allow(grl_qkv_wgmma_kernel<BN>, bytes, allowed);
  if (err != cudaSuccess) return err;
  grl_qkv_wgmma_kernel<BN><<<unsigned(blocks), 160, bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch a bf16 call on M pixels of Cin channels, halves of C2,
// needs: the six halves, each 256-byte aligned; -1 for widths it refuses
// (Cin even, K padded to 32 at most 640; C2 even, at most 128).
extern "C" long long ff_grl_qkv_bf16_scratch_bytes(long long M, int Cin,
                                                   int C2) {
  if (M <= 0 || Cin <= 0 || Cin % 2 || bw_up(Cin, kBwK) > 640 || C2 <= 0 ||
      C2 % 2 || C2 > 128)
    return -1;
  return 6 * ((2 * M * C2 + 255) / 256 * 256);
}

// As ff_grl_mixed_attention_qkv_nhwc with x, x_rolled (or null), the
// anchor, bqkv and both outputs bf16, wqkv bf16 in the segment layout
// (ops/wgmma.py:segment_layout of wqkv [Cin, 6 C2] at bn =
// grl_qkv_cols(C2) columns a chunk, 16-byte aligned); the scales and
// biases fp32 (8-byte aligned); the mask as #2's bf16 kernel takes it
// (bf16 in grl_mask_layout's order, 16-byte aligned); scratch of
// ff_grl_qkv_bf16_scratch_bytes(B H W, Cin, C2) bytes, 16-byte aligned.
extern "C" int ff_grl_mixed_attention_qkv_nhwc_bf16(
    const void* x_, const void* x_rolled_, const void* anchor,
    const void* wl, const void* bqkv_, const float* scale_w,
    const float* scale_s1, const float* scale_s2, const float* bias_w,
    const float* bias_s1, const float* bias_s2, const void* mask,
    void* out_w, void* out_s, void* scratch_, long long scratch_bytes, int B,
    int H, int W, int Cin, int C2, int bn, int heads_w, int heads_s, int ws,
    int df, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * H * W;
  const long long need = ff_grl_qkv_bf16_scratch_bytes(M, Cin, C2);
  if (need < 0 || scratch_bytes < need || bn != grl_qkv_cols(C2) ||
      reinterpret_cast<size_t>(scratch_) % 16)
    return int(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const bf* x = static_cast<const bf*>(x_);
  GrlQkvBf16 a{x_rolled_ ? static_cast<const bf*>(x_rolled_) : x, x, wl,
               static_cast<const bf*>(bqkv_), {}, M, Cin, bw_up(Cin, kBwK),
               C2};
  const long long piece = need / 6;
  for (int i = 0; i < 6; ++i)
    a.out[i] = reinterpret_cast<bf*>(static_cast<char*>(scratch_) +
                                     i * piece);
  cudaError_t err = bn == 48   ? grl_qkv_project<48>(a, s)
                    : bn == 64 ? grl_qkv_project<64>(a, s)
                    : bn == 96 ? grl_qkv_project<96>(a, s)
                               : grl_qkv_project<128>(a, s);
  if (err != cudaSuccess) return int(err);
  return ff_grl_mixed_attention_nhwc_bf16(
      a.out[0], a.out[1], a.out[2], a.out[3], a.out[4], a.out[5], anchor,
      scale_w, scale_s1, scale_s2, bias_w, bias_s1, bias_s2, mask, out_w,
      out_s, B, H, W, C2, heads_w, heads_s, ws, df, stream);
}
