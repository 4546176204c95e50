// GRL mixed attention over NHWC tensors: the window half and the anchored
// stripe half of every 8x8 tile, 3xTF32 on the tensor cores.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_attention.py:
// fused_grl_mixed_attention_nhwc (:548), which every GRL-B block calls
// (freqfusion_tpu/models/grl.py:426-441). The body, its bound and its
// design are in grl_attention.cuh, which grl_attention_qkv.cu shares; here
// the six halves are separate [B, H, W, C2] tensors, each tile row of
// each one bulk copy.

#include "grl_attention.cuh"

// q/k/v halves, out_w, out_s: [B, H, W, C2]; anchor [B, H/df, W/df, C2];
// scale_w [heads_w], scale_s1/scale_s2 [heads_s]; bias_w [heads_w, N, N],
// bias_s1 [heads_s, Na, N], bias_s2 [heads_s, N, Na]; mask [nW, N, N] or
// null. All fp32 contiguous, the halves and the anchor 16-byte aligned;
// ws 8 and df 2 (N 64, Na 16), H % 8 == 0 == W % 8, head dims <= 96 and
// (208 C2 + the head box) floats of shared memory a block.
extern "C" int ff_grl_mixed_attention_nhwc(
    const float* qw, const float* kw, const float* vw, const float* qs,
    const float* ks, const float* vs, const float* anchor,
    const float* scale_w, const float* scale_s1, const float* scale_s2,
    const float* bias_w, const float* bias_s1, const float* bias_s2,
    const float* mask, float* out_w, float* out_s, int B, int H, int W,
    int C2, int heads_w, int heads_s, int ws, int df, void* stream) {
  if (ws != kGrlWs || df != kGrlWs / kGrlAws) return int(cudaErrorInvalidValue);
  const GrlArgs a{{GrlHalf{qw, kw, vw, C2, 0, heads_w, scale_w, nullptr,
                           bias_w, nullptr, mask, out_w},
                   GrlHalf{qs, ks, vs, C2, 0, heads_s, scale_s1, scale_s2,
                           bias_s1, bias_s2, nullptr, out_s}},
                  anchor, H, W, C2};
  return int(grl_attention_launch(a, B, static_cast<cudaStream_t>(stream)));
}

// ---------------------------------------------------------------------------
// bf16 form: ff_grl_mixed_attention_nhwc_bf16, the same function over bf16
// halves, anchor and outputs, with the rounding points of the JAX kernel's
// bf16 run (freqfusion_tpu/ops/pallas_attention.py:_grl_mixed_core,
// :391-424): q, k and the anchors normalised in fp32 and rounded to bf16;
// the logits in fp32, times the head's scale, plus the bias (fp32: GRL's
// continuous position bias runs in fp32 on the fp32 table) and the mask
// (fp32, each term rounded to bf16 as it is loaded: the JAX wrapper casts
// it to the operands' dtype, :612); each softmax in fp32, normalised, rounded
// to bf16 before its product; the anchor stage's output x1 rounded to bf16
// before the second stage; both outputs rounded to bf16.
//
// What bounds it on the H100: bytes. At GRL-B's 336x512 shape a call
// reads the six halves and the anchor once and writes two outputs, ~0.27
// GB in bf16 or ~0.08 ms at 3.35 TB/s, plus the bias tables and the mask;
// its 5.95 GFLOP on the bf16 tensor cores are ~0.006 ms.
//
// Design (mma.sync m16n8k16 bf16, ldmatrix; bf16_mma.cuh's helpers), a
// simple body first: one block of 6 warps a (tile, half). The half's q, k
// and v rows (and the tile's 16 anchors) go to shared memory head by
// head, as bf16 rows of HDP + 8 with zeros past hd (8 channels a load
// item, its loads all in flight); one pass normalises
// q, k and the anchors in place. A warp unit is 16 query rows of one head
// with all its keys in registers (64 or 16: no online softmax), its bias
// and mask terms loaded before its products: S, the
// fp32 softmax, P rounded to bf16 in the A fragment straight from S's
// accumulators, P V with V read by ldmatrix.trans. The stripe half runs
// its anchor stage first (one unit a head), keeps x1 in shared memory as
// bf16 and then runs the query stage over x1. ws 8, df 2, head dims <= 96.

#include "bf16_mma.cuh"

namespace {

// One unit of 16 query rows: o = bf16(softmax(A B^T * scale + bias +
// mask)) V over NT 8-key n-tiles, fp32 accumulators. A rows from `A`, keys
// from `Bk`, values from `V` (rows of kLd bf16, the head's box from column
// 0); bias rows of `ldb` floats at the unit's first row (mask rows of 64,
// or null).
template <int NT, int HDP>
__device__ __forceinline__ void grl_bf16_unit(
    float (&o)[HDP / 8][4], const __nv_bfloat16* A,
    const __nv_bfloat16* Bk, const __nv_bfloat16* V, float scale,
    const float* __restrict__ bias, int ldb, const float* __restrict__ mask) {
  constexpr int kLd = HDP + 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // the additive terms first, so that their loads overlap the products
  float2 add[NT][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = g + 8 * h, key = 8 * j + 2 * t;
      add[j][h] = __ldg(reinterpret_cast<const float2*>(bias + row * ldb +
                                                        key));
      if (mask) {  // rounded to bf16, as the JAX wrapper casts it
        const float2 mv = __ldg(
            reinterpret_cast<const float2*>(mask + row * kGrlN + key));
        add[j][h].x += round_bf16(mv.x);
        add[j][h].y += round_bf16(mv.y);
      }
    }
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int d16 = 0; d16 < HDP / 16; ++d16) {
    uint32_t a[4];
    ldsm_a(a, A + 16 * d16, kLd);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bf[2][2];
      ldsm_b_nk(bf, Bk + 8 * j * kLd + 16 * d16, kLd);
      mma_bf16(s[j], a, bf[0][0], bf[0][1]);
      mma_bf16(s[j + 1], a, bf[1][0], bf[1][1]);
    }
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][2 * h] = (s[j][2 * h] * scale + add[j][h].x) * kLog2e;
      s[j][2 * h + 1] = (s[j][2 * h + 1] * scale + add[j][h].y) * kLog2e;
      mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    }
    mx = quad_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][2 * h] = ex2(s[j][2 * h] - mx);
      s[j][2 * h + 1] = ex2(s[j][2 * h + 1] - mx);
      sum += s[j][2 * h] + s[j][2 * h + 1];
    }
    inv[h] = 1.f / quad_sum(sum);
  }
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t a[4];
    p_frag_bf16(a, s[2 * kk], s[2 * kk + 1], inv);
#pragma unroll
    for (int d = 0; d < HDP / 8; d += 2) {
      uint32_t bf[2][2];
      ldsm_b_kn(bf, V + 16 * kk * kLd + 8 * d, kLd);
      mma_bf16(o[d], a, bf[0][0], bf[0][1]);
      mma_bf16(o[d + 1], a, bf[1][0], bf[1][1]);
    }
  }
}

struct GrlBf16Args {
  const __nv_bfloat16* x[2][3];  // (window, stripe) x (q, k, v)
  const __nv_bfloat16* anchor;   // [B, H / 2, W / 2, C2]
  const float* scale[3];         // s_w [heads_w], s1, s2 [heads_s]
  const float* bias[3];          // [heads_w, N, N], [heads_s, Na, N],
                                 // [heads_s, N, Na]
  const float* mask;             // [tiles, N, N] or null
  __nv_bfloat16* out[2];         // [B, H, W, C2]
  int heads[2];
  int H, W, C2;
};

constexpr int kGrlBf16Warps = 6;

template <int HDP>
__global__ void __launch_bounds__(32 * kGrlBf16Warps)
grl_attention_bf16_kernel(const GrlBf16Args p, int tiles_x, int tiles) {
  constexpr int kLd = HDP + 8;
  static_assert(HDP % 16 == 0, "head box: whole 16-dim k-steps");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int stripe = blockIdx.x % 2;
  const int bt = blockIdx.x / 2;
  const int tile = bt % tiles, b = bt / tiles;
  const int ty = tile / tiles_x, tx = tile % tiles_x;
  const int tid = threadIdx.x, warp = tid / 32;
  const int C2 = p.C2, H = p.H, W = p.W, heads = p.heads[stripe];
  const int hd = C2 / heads;
  // head h's rows: q at sm + (3 h) * 64 kLd, k at (3 h + 1), v at (3 h + 2);
  // the stripe's anchors at an + h * 16 kLd, its x1 at x1s + h * 16 kLd
  const int per = 3 * kGrlN * kLd;
  __nv_bfloat16* an = sm + heads * per;
  __nv_bfloat16* x1s = an + heads * kGrlNa * kLd;

  // the tile's pixel rows into the heads' boxes, zeros past hd: 8 channels
  // an item (head, row, chunk), the chunk's loads independent
  constexpr int kCh = HDP / 8;
  const int rows = 3 * kGrlN + (stripe ? kGrlNa : 0);
  for (int idx = tid; idx < heads * rows * kCh; idx += blockDim.x) {
    const int c = idx % kCh, r = idx / kCh % rows, h = idx / kCh / rows;
    const __nv_bfloat16* src;
    __nv_bfloat16* dst;
    if (r < 3 * kGrlN) {
      const int which = r / kGrlN, i = r % kGrlN;
      dst = sm + h * per + (which * kGrlN + i) * kLd;
      src = p.x[stripe][which] +
            (((long long)b * H + ty * kGrlWs + i / kGrlWs) * W + tx * kGrlWs +
             i % kGrlWs) * C2;
    } else {
      const int i = r - 3 * kGrlN;
      dst = an + (h * kGrlNa + i) * kLd;
      src = p.anchor + (((long long)b * (H / 2) + ty * kGrlAws +
                         i / kGrlAws) * (W / 2) + tx * kGrlAws +
                        i % kGrlAws) * C2;
    }
    *reinterpret_cast<uint4*>(dst + 8 * c) =
        load8_bf16(src + h * hd + 8 * c, hd - 8 * c);
  }
  __syncthreads();
  // q, k (and the anchors): x / max(||x||, 1e-12) in fp32, rounded to bf16
  const int nrm = 2 * kGrlN + (stripe ? kGrlNa : 0);
  for (int i = tid; i < heads * nrm; i += blockDim.x) {
    const int h = i / nrm, r = i % nrm;
    __nv_bfloat16* row = r < 2 * kGrlN ? sm + h * per + r * kLd
                                       : an + (h * kGrlNa + r - 2 * kGrlN) * kLd;
    float ss = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float x = __bfloat162float(row[d]);
      ss = fmaf(x, x, ss);
    }
    const float f = 1.f / fmaxf(sqrtf(ss), 1e-12f);
    for (int d = 0; d < hd; ++d)
      row[d] = __float2bfloat16_rn(__bfloat162float(row[d]) * f);
  }
  __syncthreads();

  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  __nv_bfloat16* out = p.out[stripe] +
                       (((long long)b * H + ty * kGrlWs) * W + tx * kGrlWs) *
                           C2;
  // rows r0 + g (+ 8) of o, rounded to bf16, into the head's channels
  auto store = [&](const float (&o)[HDP / 8][4], int r0, int h) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + g + 8 * hh;
      __nv_bfloat16* orow =
          out + ((long long)(r / kGrlWs) * W + r % kGrlWs) * C2 + h * hd;
#pragma unroll
      for (int d = 0; d < HDP / 8; ++d) {
        const int col = 8 * d + 2 * t;
        if (col < hd) orow[col] = __float2bfloat16_rn(o[d][2 * hh]);
        if (col + 1 < hd)
          orow[col + 1] = __float2bfloat16_rn(o[d][2 * hh + 1]);
      }
    }
  };
  if (!stripe) {
    for (int u = warp; u < heads * 4; u += kGrlBf16Warps) {
      const int h = u / 4, r0 = 16 * (u % 4);
      const __nv_bfloat16* base = sm + h * per;
      float o[HDP / 8][4];
      grl_bf16_unit<8, HDP>(
          o, base + r0 * kLd, base + kGrlN * kLd, base + 2 * kGrlN * kLd,
          __ldg(p.scale[0] + h),
          p.bias[0] + ((long long)h * kGrlN + r0) * kGrlN, kGrlN,
          p.mask ? p.mask + ((long long)tile * kGrlN + r0) * kGrlN : nullptr);
      store(o, r0, h);
    }
    return;
  }
  // stage 1: the anchors attend to the tile's keys; x1 rounded to bf16
  for (int h = warp; h < heads; h += kGrlBf16Warps) {
    const __nv_bfloat16* base = sm + h * per;
    float o[HDP / 8][4];
    grl_bf16_unit<8, HDP>(o, an + h * kGrlNa * kLd, base + kGrlN * kLd,
                          base + 2 * kGrlN * kLd, __ldg(p.scale[1] + h),
                          p.bias[1] + (long long)h * kGrlNa * kGrlN, kGrlN,
                          nullptr);
    __nv_bfloat16* x1 = x1s + h * kGrlNa * kLd;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int d = 0; d < HDP / 8; ++d)
        *reinterpret_cast<uint32_t*>(x1 + (g + 8 * hh) * kLd + 8 * d +
                                     2 * t) =
            pack_bf16(o[d][2 * hh], o[d][2 * hh + 1]);
  }
  __syncthreads();
  // stage 2: the tile's queries attend to the anchor summary
  for (int u = warp; u < heads * 4; u += kGrlBf16Warps) {
    const int h = u / 4, r0 = 16 * (u % 4);
    float o[HDP / 8][4];
    grl_bf16_unit<2, HDP>(o, sm + h * per + r0 * kLd, an + h * kGrlNa * kLd,
                          x1s + h * kGrlNa * kLd, __ldg(p.scale[2] + h),
                          p.bias[2] + ((long long)h * kGrlN + r0) * kGrlNa,
                          kGrlNa, nullptr);
    store(o, r0, h);
  }
}

}  // namespace

// As ff_grl_mixed_attention_nhwc, with the halves, the anchor and both
// outputs bf16 (2-byte aligned); the scales [heads], biases and mask fp32,
// 8-byte aligned. ws 8, df 2, H % 8 == 0 == W % 8, head dims <= 96.
extern "C" int ff_grl_mixed_attention_nhwc_bf16(
    const void* qw, const void* kw, const void* vw, const void* qs,
    const void* ks, const void* vs, const void* anchor, const float* scale_w,
    const float* scale_s1, const float* scale_s2, const float* bias_w,
    const float* bias_s1, const float* bias_s2, const float* mask,
    void* out_w, void* out_s, int B, int H, int W, int C2, int heads_w,
    int heads_s, int ws, int df, void* stream) {
  using bf = __nv_bfloat16;
  if (ws != kGrlWs || df != kGrlWs / kGrlAws || H % kGrlWs || W % kGrlWs ||
      heads_w < 1 || heads_s < 1 || C2 % heads_w || C2 % heads_s)
    return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<size_t>(bias_w) | reinterpret_cast<size_t>(bias_s1) |
       reinterpret_cast<size_t>(bias_s2) | reinterpret_cast<size_t>(mask)) %
      8)
    return int(cudaErrorInvalidValue);
  const int hdp = grl_head_box(C2 / min(heads_w, heads_s));
  if (!hdp) return int(cudaErrorInvalidValue);
  GrlBf16Args a{{{static_cast<const bf*>(qw), static_cast<const bf*>(kw),
                  static_cast<const bf*>(vw)},
                 {static_cast<const bf*>(qs), static_cast<const bf*>(ks),
                  static_cast<const bf*>(vs)}},
                static_cast<const bf*>(anchor),
                {scale_w, scale_s1, scale_s2},
                {bias_w, bias_s1, bias_s2},
                mask,
                {static_cast<bf*>(out_w), static_cast<bf*>(out_s)},
                {heads_w, heads_s},
                H, W, C2};
  const int heads = max(heads_w, heads_s);
  const size_t smem =
      size_t(heads) * (3 * kGrlN + 2 * kGrlNa) * (hdp + 8) * sizeof(bf);
  const int tiles_x = W / kGrlWs, tiles = (H / kGrlWs) * tiles_x;
  const long long blocks = 2LL * B * tiles;
  if (blocks > 0x7fffffffLL || blocks == 0 || smem > 232448)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FF_GRL_BF16(P)                                                       \
  if (hdp == P) {                                                            \
    cudaError_t err = cudaFuncSetAttribute(                                  \
        grl_attention_bf16_kernel<P>,                                        \
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));             \
    if (err != cudaSuccess) return int(err);                                 \
    grl_attention_bf16_kernel<P><<<unsigned(blocks), 32 * kGrlBf16Warps,     \
                                   smem, s>>>(a, tiles_x, tiles);            \
    return int(cudaGetLastError());                                          \
  }
  FF_GRL_BF16(16)
  FF_GRL_BF16(32)
  FF_GRL_BF16(48)
  FF_GRL_BF16(64)
  FF_GRL_BF16(96)
#undef FF_GRL_BF16
  return int(cudaErrorInvalidValue);
}
