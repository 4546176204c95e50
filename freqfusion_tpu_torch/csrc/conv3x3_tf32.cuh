// A 3x3 convolution over [B, H, W, C] tensors of any layout, fp32, zero
// padded, on the tensor cores in 3xTF32 (tf32_mma.cuh): the building block
// of the fusion net's hierarchical stage 3 (csrc/hier.cu) and Laplacian
// edge refinement (csrc/edge.cu). Each tensor is read through its element
// strides (b, y, x, c), so an NCHW tensor and an NHWC scratch mix in one
// call. The input is the channel concatenation of up to three sources,
// each padded to a stage's 8 channels on its own, so that a stage never
// mixes two tensors; each keeps its own strides and copy width.
//
// out = act(conv + bias [+ bias2]), then one epilogue:
//  - kStore: optionally out = r1 + alpha out and out += beta r2
//    (residuals read at the same pixel);
//  - kSpatialGate: out = v * sigmoid(gelu(v G0 + g0) g2 + g2b) over the
//    pixel's Cout channels v;
//  - kSqueeze: out = v, and out2 = gelu(v G0 + g0) (8 channels);
//  - kBroadcast (Cout 1): out[..., c] = ba[..., c] + v k bm[..., c] for c
//    < bC, optionally clipped to [0, 1] (a per-pixel gate applied to a
//    bC-channel tensor).
// A residual or gate tensor may be the output itself: each thread reads it
// at its own pixels before writing them.
//
// The same kernel runs in bf16 (template flag kBf, the bf16 versions of
// #19-#21): one mma.sync m16n8k16 a k16 step (bf16_mma.cuh) where fp32
// runs three TF32 products, 16 input channels a stage, fp32 sums, and the
// epilogue in fp32. Its sources are bf16 NHWC tensors whose pixel stride is
// a multiple of 8 channels, zeros past their channels (the JAX kernels
// round each conv's input to bf16, so what a conv reads is bf16 already):
// a stage lands by cp.async and a ring of kStagesBf16 stages. pack() makes
// such a tensor of any other input (NCHW, several sources concatenated,
// each times a scale before the rounding), and a conv can write a bf16
// copy of its output beside it (out2) for the next conv. A stage's halo is
// two 16-byte chunks a pixel (channels 0-7, 8-15), the chunks of pixel q
// swapped where bit 2 of q is set, so that a lane's 4-byte fragment reads
// (pixel g, channels 2t, 2t + 1) hit 32 banks. A bf16 conv reads each
// tensor of its epilogue in its own element type (T4::bf: bf16 or fp32, so
// a value that also feeds fp32 element-wise work can stay fp32 between
// launches), stores its output in the type `o` names, rounds the
// squeezes' operands to bf16 as the JAX kernels' 1x1 dots do (on the
// tensor cores), and takes every parameter (biases, the squeezes' weights,
// alpha, beta, bk, the conv weights) as bf16.
//
// Design, #15's convolution (csrc/cab.cu) without its LayerNorm and
// channel sums: an implicit GEMM, M a tile of output pixels, N the output
// channels, K = 9 Cin taken tap by tap. A block of 8 warps takes a (8 MT)
// x 16 tile of output pixels and 8 NT output channels (wider convs take
// several blocks); warp w owns output rows MT w .. MT w + MT - 1, one
// m-tile each (the tile's 16 columns are an m-tile's 16 rows), and all the
// block's n-tiles. Input
// channels go 8 a stage (one k8 step a tap) through a two-stage ring, one
// barrier a stage: the stage's (8 MT + 2) x 18 halo lands by cp.async
// (zeros outside the image and past the source's channels; a pixel's 4
// channels a thread, one 16-byte copy from an NHWC source, else four
// 4-byte copies), and a
// lane splits its A fragment in registers as it reads it, as
// tf32_gemm.cuh's Product does (#15 splits its halo in place once a
// stage: twice the shared-memory reads a tap, and a split pass in step
// across the block); the stage's weights for all 9 taps, split once a call
// into fragment order (a lane's B fragment, hi and lo, is one 16-byte
// load; a block's stage one contiguous piece), land by one bulk copy on
// the stage's mbarrier. A tap's A fragment is the halo shifted by (dy,
// dx). The k8 block's channels are permuted (fragment column t is channel
// 2t, t + 4 is 2t + 1, in the weights' split as in the halo's read), so a
// lane reads a pixel's two channels as one 8-byte load, free of bank
// conflicts at a pixel stride of 8 floats. Zero padding needs no masks:
// every conv of a chain reads a tensor of the image's size from device
// memory and stages zeros outside it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace conv3x3_tf32 {

constexpr int kTW = 16;        // output tile columns: an m-tile's rows
constexpr int kHW = kTW + 2;   // halo columns
constexpr int kCK = 8;         // input channels a stage: one k8 block
constexpr int kCK16 = 16;      // the bf16 convs': one k16 block
constexpr int kStages = 2;     // the ring (fp32)
constexpr int kStagesBf16 = 4;  // the bf16 convs' ring: a stage's products
                                // take a third of fp32's, too short to hide
                                // one stage's copies behind
constexpr int kBroadcastPer = 8;  // kBroadcast: bm's channels a lane, at most

// A tensor through its element strides; its elements are bf16 where bf
// is set (read and written only by the bf16 convs), else fp32.
struct T4 {
  const float* p;
  long long sb, sy, sx, sc;
  int bf;
};

__host__ __device__ inline long long at(const T4& t, int b, int y, int x,
                                        int c) {
  return b * t.sb + y * t.sy + x * t.sx + c * t.sc;
}

// A [B, H, W, C] tensor, NHWC-contiguous or (nchw) NCHW-contiguous.
inline T4 tensor(const float* p, int H, int W, int C, int nchw) {
  if (nchw) return T4{p, (long long)C * H * W, W, 1, (long long)H * W, 0};
  return T4{p, (long long)H * W * C, (long long)W * C, C, 1, 0};
}

// The same over bf16 elements.
inline T4 tensor_bf16(const void* p, int H, int W, int C, int nchw) {
  T4 t = tensor(static_cast<const float*>(p), H, W, C, nchw);
  t.bf = 1;
  return t;
}

// A parameter of a conv: fp32, or (the bf16 convs) bf16.
template <bool kBf>
__device__ __forceinline__ float par(const float* p, long long i) {
  if constexpr (kBf)
    return __bfloat162float(
        __ldg(reinterpret_cast<const __nv_bfloat16*>(p) + i));
  else
    return __ldg(p + i);
}

// Element o of t as fp32 (the fp32 convs read fp32 only).
template <bool kBf>
__device__ __forceinline__ float load(const T4& t, long long o) {
  if constexpr (kBf)
    if (t.bf)
      return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(t.p)[o]);
  return t.p[o];
}

// v as element o of the output `out` of layout `t`.
template <bool kBf>
__device__ __forceinline__ void store(float* out, const T4& t, long long o,
                                      float v) {
  if constexpr (kBf)
    if (t.bf) {
      reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
      return;
    }
  out[o] = v;
}

// v rounded to bf16 where the bf16 convs round it (the squeezes' operands).
template <bool kBf>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (kBf) return round_bf16(v);
  else return v;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

enum Act { kNone = 0, kGelu = 1, kSigmoid = 2 };
enum Epilogue { kStore = 0, kSpatialGate = 1, kSqueeze = 2, kBroadcast = 3 };

struct Src {
  T4 t;        // [B, H, W, C]
  int C, vec;  // channels; 16-byte copies (fp32: NHWC, C % 4 == 0,
               // aligned; bf16: see vec_ok_bf16, which every bf16 source
               // must meet)
  int stages;  // C padded to a stage's channels, in stages
};

// In the bf16 convs every parameter pointer (bias ... bk) points at bf16
// values, and out (out2) at elements of o's (o2's) type; out2 is, besides
// kSqueeze's squeeze, the bf16 copy of a kStore or kSpatialGate conv's
// output, all coutp channels (zeros past Cout where the activation keeps
// zero), for a later conv to read.
struct Conv {
  Src src[3];           // the sources, concatenated along C
  int nsrc, cinp;       // their count; their padded channels, summed
  const float* w;       // split weights, fragment order (split_unit)
  const float* bias;    // [Cout] or null
  const float* bias2;   // [Cout] or null, added to bias
  int Cout, coutp, act;
  float* out;           // output, strides of `o`
  T4 o;
  T4 r1;                // residual or null: out = r1 + alpha * out
  const float* alpha;
  T4 r2;                // residual or null: out += beta * r2
  const float* beta;
  const float* g0;      // kSpatialGate, kSqueeze: G0 [Cout, 8], g0 [8];
  const float* g0b;     // kSpatialGate: g2 [8], g2b [1]; the block holds
  const float* g2;      // all of Cout
  const float* g2b;
  long long g0i, g0o;   // kSqueeze: G0's strides (kSpatialGate's: 8, 1)
  float* out2;          // kSqueeze: [B, H, W, 8], strides of `o2`; bf16
  T4 o2;                // kStore, kSpatialGate: the output's bf16 copy
  T4 bm, ba;            // kBroadcast: out[c] = ba[c] + v k bm[c], c < bC;
  const float* bk;      // ba may be null; k one float on the card, or null
  int bC, clamp;        // for 1
  int H, W;
};

// (8 MT) x 16 output pixels and 8 NT output channels a block of 8 warps;
// sizes in 4-byte words (a halo pixel's stage is 8 of them: 8 fp32 or 16
// bf16 channels).
template <int NT, int MT, bool kBf = false>
struct Shape {
  static constexpr int kThreads = 256;
  static constexpr int kN = 8 * NT;                   // output channels
  static constexpr int kTH = 8 * MT;                  // output tile rows
  static constexpr int kCh = kBf ? kCK16 : kCK;       // channels a stage
  static constexpr int kHalo = (kTH + 2) * kHW;       // halo pixels
  static constexpr int kPlane = kHalo * 8;            // the halo's words
  static constexpr int kW = 9 * NT * (kBf ? 64 : 128);  // 9 taps' B frags
  static constexpr int kStage = kPlane + kW;          // words
  static constexpr int kRing = kBf ? kStagesBf16 : kStages;
  static constexpr size_t kSmem =
      kRing * size_t(kStage) * sizeof(float) + kRing * sizeof(uint64_t);
};

// A conv kernel as HWIO [kh, kw, cin, cout] through its element strides:
// a contiguous HWIO tensor, or a view of PyTorch's OIHW weight.
struct W4 {
  const float* p;
  long long sh, sw, si, so;
};

// A contiguous HWIO [kh, kw, cin, cout] kernel.
inline W4 hwio(const float* p, int kw, int cin, int cout) {
  return W4{p, (long long)kw * cin * cout, (long long)cin * cout, cout, 1};
}

// One source's rows of a conv's weights: [k, k, cin, cout] with k 3, or 1
// (a 1x1 kernel: the centre tap, zeros around it), scaled by one float on
// the card or not (fp32 only).
struct SplitSrc {
  W4 w;
  const float* scale;
  int cin, cinp, k;
};

// One conv's weights to split: 9 cinp coutp / 2 units (fp32), 9 cinp
// coutp / 4 (bf16: the weights bf16, cinp a multiple of 16).
struct SplitJob {
  SplitSrc src[3];
  int nsrc;
  float* fr;
  int cout, coutp, cinp, nt, ck;
};

// A conv's split with no source yet: add_split_source adds them in the
// order of the conv's sources; ck is a stage's channels (kCK, or kCK16
// for a bf16 conv).
inline SplitJob split_job(float* fr, int cout, int coutp, int nt,
                          int ck = kCK) {
  SplitJob j{};
  j.fr = fr;
  j.cout = cout;
  j.coutp = coutp;
  j.nt = nt;
  j.ck = ck;
  return j;
}

// Appends a source's rows (SplitSrc) to j; a fourth is dropped, and the
// conv that reads j's weights then refuses its fourth source too.
inline void add_split_source(SplitJob& j, W4 w, int cin, int k = 3,
                             const float* scale = nullptr) {
  const int cinp = (cin + j.ck - 1) / j.ck * j.ck;
  if (j.nsrc < 3) j.src[j.nsrc++] = SplitSrc{w, scale, cin, cinp, k};
  j.cinp += cinp;
}

// A conv of one [3, 3, cin, cout] kernel.
inline SplitJob split_job(W4 w, float* fr, int cin, int cout, int coutp,
                          int nt, int ck = kCK) {
  SplitJob j = split_job(fr, cout, coutp, nt, ck);
  add_split_source(j, w, cin);
  return j;
}

// Units of j's split: a lane's fragment of one (block, k block, tap,
// n-tile) each.
template <bool kBf>
__host__ __device__ inline long long split_units(const SplitJob& j) {
  return 9LL * j.cinp * j.coutp / (kBf ? 4 : 2);
}

// The split weights, zero-padded, in fragment order over [coutp / (8 nt)
// blocks][cinp / 8][9 taps][nt][32 lanes][4]: unit u is lane (g, t) of a
// (block, k8 block, tap, n-tile), its hi W[2t][g], hi W[2t + 1][g], then
// the two lo. The k8 block's channels go in the order 0, 2, 4, 6, 1, 3,
// 5, 7, the order in which a lane reads the halo; k8 block kb lies in the
// source whose padded rows hold it.
__device__ __forceinline__ void split_unit(const SplitJob& s, long long u) {
  const int lane = int(u % 32), g = lane / 4, t = lane % 4;
  long long blk = u / 32;
  const int ntl = int(blk % s.nt);
  blk /= s.nt;
  const int tap = int(blk % 9);
  blk /= 9;
  int kb = int(blk % (s.cinp / 8));
  const int nb = int(blk / (s.cinp / 8));
  int i = 0;
  while (i + 1 < s.nsrc && kb >= s.src[i].cinp / 8)
    kb -= s.src[i++].cinp / 8;
  const SplitSrc& q = s.src[i];
  const int ci = 8 * kb + 2 * t, co = 8 * (nb * s.nt + ntl) + g;
  float v0 = 0.f, v1 = 0.f;
  if (co < s.cout && (q.k == 3 || tap == 4)) {
    const W4& w = q.w;
    const float* wt = w.p + co * w.so +
                      (q.k == 3 ? (tap / 3) * w.sh + (tap % 3) * w.sw : 0);
    const float sc = q.scale ? *q.scale : 1.f;
    if (ci < q.cin) v0 = wt[ci * w.si] * sc;
    if (ci + 1 < q.cin) v1 = wt[(ci + 1) * w.si] * sc;
  }
  uint4 o;
  split_tf32(v0, o.x, o.z);
  split_tf32(v1, o.y, o.w);
  *reinterpret_cast<uint4*>(s.fr + 4 * u) = o;
}

// The bf16 split (bf16 weights, no scale), in fragment order over
// [coutp / (8 nt) blocks][cinp / 16][9 taps][nt][32 lanes][2 words]: unit
// u is lane (g, t) of a (block, k16 block, tap, n-tile), its b0 = W[2t,
// 2t + 1][g] and b1 = W[2t + 8, 2t + 9][g] as bf16 pairs, the channels in
// their natural order.
__device__ __forceinline__ void split_unit_bf16(const SplitJob& s,
                                                long long u) {
  const int lane = int(u % 32), g = lane / 4, t = lane % 4;
  long long blk = u / 32;
  const int ntl = int(blk % s.nt);
  blk /= s.nt;
  const int tap = int(blk % 9);
  blk /= 9;
  int kb = int(blk % (s.cinp / 16));
  const int nb = int(blk / (s.cinp / 16));
  int i = 0;
  while (i + 1 < s.nsrc && kb >= s.src[i].cinp / 16)
    kb -= s.src[i++].cinp / 16;
  const SplitSrc& q = s.src[i];
  const int co = 8 * (nb * s.nt + ntl) + g;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (co < s.cout && (q.k == 3 || tap == 4)) {
    const W4& w = q.w;
    const __nv_bfloat16* wt =
        reinterpret_cast<const __nv_bfloat16*>(w.p) + co * w.so +
        (q.k == 3 ? (tap / 3) * w.sh + (tap % 3) * w.sw : 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = 16 * kb + 2 * t + (e / 2) * 8 + e % 2;
      if (ci < q.cin) v[e] = __bfloat162float(wt[ci * w.si]);
    }
  }
  *reinterpret_cast<uint2*>(s.fr + 2 * u) =
      make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

template <int J>
struct SplitJobs {
  SplitJob job[J];
};

template <int J, bool kBf>
__global__ void __launch_bounds__(256) split_kernel(SplitJobs<J> jobs) {
  long long base[J + 1];
  base[0] = 0;
#pragma unroll
  for (int j = 0; j < J; ++j)
    base[j + 1] = base[j] + split_units<kBf>(jobs.job[j]);
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < base[J];
       i += gridDim.x * 256LL) {
    int j = 0;
#pragma unroll
    for (int q = 1; q < J; ++q) j += i >= base[q];
    if constexpr (kBf)
      split_unit_bf16(jobs.job[j], i - base[j]);
    else
      split_unit(jobs.job[j], i - base[j]);
  }
}

template <int J, bool kBf = false>
cudaError_t split(const SplitJobs<J>& jobs, cudaStream_t stream) {
  split_kernel<J, kBf><<<264, 256, 0, stream>>>(jobs);
  return cudaGetLastError();
}

// Each epilogue is an instantiation of its own: the SpatialGate's and the
// squeeze's sums would crowd the registers of the other convs. kMulti:
// several sources, each stage picking its own (a conv of one source reads
// it as a loop invariant: the pick costs #19's convs ~4%). kBf: the bf16
// conv (see the top of this file), with a ring of kStagesBf16 stages.
template <int NT, int MT, int kEpi, bool kMulti, bool kBf = false>
__global__ void __launch_bounds__(256, 2) conv_kernel(Conv p) {
  using S = Shape<NT, MT, kBf>;
  constexpr int kThreads = S::kThreads, kRing = S::kRing;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing * S::kStage);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tiles_x = (p.W + kTW - 1) / kTW;
  const int y0 = (blockIdx.x / tiles_x) * S::kTH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const int n0 = blockIdx.y * S::kN;
  const int b = blockIdx.z;
  auto in_image = [&](int q, int& gy, int& gx) {
    gy = y0 - 1 + q / kHW;
    gx = x0 - 1 + q % kHW;
    return gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
  };
  auto plane = [&](int s) { return smem + (s % kRing) * S::kStage; };

  // Stage s: the halo's channels [ch s', ch s' + ch) of the source whose
  // padded channels hold it, s' its stage there, and (thread 0, one bulk
  // copy on the stage's mbarrier) the block's B fragments of all 9 taps.
  // fp32: thread tid owns the pieces tid + i kThreads: pixel q / 2,
  // channels 4 (q % 2) + 0..3; one 16-byte copy from an NHWC source, else
  // four 4-byte copies, neighbouring threads on neighbouring pixels of a
  // channel plane. bf16: pixel q / 2, channels 8 (q % 2) + 0..7, one
  // 16-byte copy into the pixel's chunk (q % 2) ^ bit 2 of the pixel.
  auto copy_stage = [&](int s) {
    Src x = p.src[0];
    int c0 = s * S::kCh;
    if constexpr (kMulti) {
      const int s1 = p.src[0].stages, s2 = s1 + p.src[1].stages;
      if (s >= s2) {
        x = p.src[2];
        c0 = (s - s2) * S::kCh;
      } else if (s >= s1) {
        x = p.src[1];
        c0 = (s - s1) * S::kCh;
      }
    }
    float* r = plane(s);
    if constexpr (kBf) {
      const __nv_bfloat16* xh =
          reinterpret_cast<const __nv_bfloat16*>(x.t.p) + b * x.t.sb;
      for (int q = tid; q < S::kHalo * 2; q += kThreads) {
        const int c = c0 + 8 * (q % 2);
        int gy, gx;
        const bool ok = in_image(q / 2, gy, gx) && c < x.C;
        cp_async16(r + 8 * (q / 2) + 4 * ((q % 2) ^ ((q / 2 >> 2) & 1)),
                   ok ? reinterpret_cast<const float*>(
                            xh + gy * x.t.sy + gx * x.t.sx + c)
                      : p.w,
                   ok);
      }
    } else {
      const float* xb = x.t.p + b * x.t.sb;
      for (int q = tid; q < S::kHalo * 2; q += kThreads) {
        const int px = q / 2, c = c0 + 4 * (q % 2);
        int gy, gx;
        const bool in = in_image(px, gy, gx);
        const float* src = xb + gy * x.t.sy + gx * x.t.sx;
        if (x.vec) {
          const bool ok = in && c < x.C;
          cp_async16(r + 4 * q, ok ? src + c : p.w, ok);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = in && c + j < x.C;
            cp_async4(r + 4 * q + j, ok ? src + (c + j) * x.t.sc : p.w, ok);
          }
        }
      }
    }
    if (tid == 0) {
      constexpr uint32_t kBytes = 4 * S::kW;
      uint64_t* bar = &full[s % kRing];
      fence_proxy_async();
      mbar_arrive_expect_tx(bar, kBytes);
      bulk_copy(r + S::kPlane,
                p.w + ((long long)blockIdx.y * (p.cinp / S::kCh) + s) * S::kW,
                kBytes, bar);
    }
  };

  const int stages = p.cinp / S::kCh;
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  // stages 0 .. kRing - 2 in flight; one commit group a stage, empty past
  // the last
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < stages) copy_stage(i);
    cp_async_commit();
  }

  float acc[NT][MT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.f;

  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kRing - 2>();  // this thread's copies of stage s
    mbar_wait(&full[s % kRing], (s / kRing) & 1);  // its weights
    __syncthreads();  // stage s is in; stage s - 1's products are done
    if (s + kRing - 1 < stages) copy_stage(s + kRing - 1);
    cp_async_commit();
    if constexpr (kBf) {
      const uint32_t* ah = reinterpret_cast<const uint32_t*>(plane(s));
      const uint32_t* w = ah + S::kPlane;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        // lane (g, t): pixels g and g + 8 of the m-tile's row (one chunk
        // swap: they differ by 8), channels 2t, 2t + 1 and 2t + 8, 2t + 9
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int q = (MT * warp + mt + dy) * kHW + g + dx;
          const int lo = 8 * q + 4 * ((q >> 2) & 1) + t;
          const int hi = 8 * q + 4 * (((q >> 2) & 1) ^ 1) + t;
          a[mt][0] = ah[lo];
          a[mt][1] = ah[lo + 64];
          a[mt][2] = ah[hi];
          a[mt][3] = ah[hi + 64];
        }
        const uint32_t* wt = w + tap * NT * 64 + 2 * lane;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 f = *reinterpret_cast<const uint2*>(wt + 64 * j);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[j][mt], a[mt], f.x, f.y);
        }
      }
      continue;
    }
    const float* ah = plane(s);
    const float* w = ah + S::kPlane;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // lane (g, t): pixels g and g + 8 of the m-tile's row, channels 2t
      // and 2t + 1 (fragment columns t and t + 4), split here
      uint32_t fh[MT][4], fl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int o = ((MT * warp + mt + dy) * kHW + g + dx) * kCK + 2 * t;
        const float2 r0 = *reinterpret_cast<const float2*>(ah + o);
        const float2 r1 = *reinterpret_cast<const float2*>(ah + o + 8 * kCK);
        split_tf32(r0.x, fh[mt][0], fl[mt][0]);
        split_tf32(r1.x, fh[mt][1], fl[mt][1]);
        split_tf32(r0.y, fh[mt][2], fl[mt][2]);
        split_tf32(r1.y, fh[mt][3], fl[mt][3]);
      }
      const float* wt = w + tap * NT * 128 + 4 * lane;
      constexpr int kWhole = NT / 2 * 2;
#pragma unroll
      for (int j = 0; j < kWhole; j += 2) {
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint4 f = *reinterpret_cast<const uint4*>(wt + 128 * (j + q));
          bh[q][0] = f.x, bh[q][1] = f.y, bl[q][0] = f.z, bl[q][1] = f.w;
        }
        mma_3xtf32_split(*reinterpret_cast<float(*)[2][MT][4]>(&acc[j]), fh,
                         fl, bh, bl);
      }
      if constexpr (kWhole < NT) {  // an odd last n-tile
        const uint4 f = *reinterpret_cast<const uint4*>(wt + 128 * kWhole);
        const uint32_t bh[1][2] = {{f.x, f.y}}, bl[1][2] = {{f.z, f.w}};
        mma_3xtf32_split(*reinterpret_cast<float(*)[1][MT][4]>(&acc[kWhole]),
                         fh, fl, bh, bl);
      }
    }
  }

  // epilogue: lane (g, t) holds, for m-tile mt (output row y0 + MT warp +
  // mt) and n-tile j, pixels g + 8 h and channels n0 + 8 j + 2 t + e at
  // acc[j][mt][2 h + e]
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = n0 + 8 * j + 2 * t + e;
      float bias = 0.f;
      if (co < p.Cout) {
        if (p.bias) bias = par<kBf>(p.bias, co);
        if (p.bias2) bias += par<kBf>(p.bias2, co);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& v = acc[j][mt][2 * h + e];
          v += bias;
          if (p.act == kGelu) v = gelu_erf(v);
          else if (p.act == kSigmoid) v = sigmoidf(v);
        }
    }
  if constexpr (kEpi == kBroadcast) {
    // Cout 1: lane t = 0 of the quad holds the pixel's one channel; the
    // quad takes it by a shuffle, and lane t applies it to bm's channels
    // [per t, per t + per), per = bC / 4 rounded up (<= kBroadcastPer): a
    // row's loads all issued before its stores, so they overlap
    const float k = p.bk ? par<kBf>(p.bk, 0) : 1.f;
    const int per = (p.bC + 3) / 4, c0 = per * t;
    // without ba, an fp32 bm's kBroadcastPer channels a lane as two
    // 16-byte loads
    const bool quads = per == kBroadcastPer && p.bC == 4 * per && !p.ba.p &&
                       !p.bm.bf && p.bm.sc == 1 && p.bm.sx % 4 == 0 &&
                       reinterpret_cast<size_t>(p.bm.p) % 16 == 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int gy = y0 + MT * warp + mt;
      if (gy >= p.H) continue;  // the warp's row: every lane alike
      float v[2], m[2][kBroadcastPer], a[2][kBroadcastPer];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[h] = k * __shfl_sync(0xffffffffu, acc[0][mt][2 * h], lane & ~3);
        const int gx = x0 + g + 8 * h;
        if (quads) {
          float4 u[2] = {};
          if (gx < p.W) {
            const float4* q = reinterpret_cast<const float4*>(
                p.bm.p + at(p.bm, b, gy, gx, c0));
            u[0] = q[0];
            u[1] = q[1];
          }
          const float* uf = reinterpret_cast<const float*>(u);
#pragma unroll
          for (int i = 0; i < kBroadcastPer; ++i) {
            m[h][i] = uf[i];
            a[h][i] = 0.f;
          }
          continue;
        }
#pragma unroll
        for (int i = 0; i < kBroadcastPer; ++i) {
          const int c = c0 + i;
          m[h][i] = a[h][i] = 0.f;
          if (i < per && gx < p.W && c < p.bC) {
            m[h][i] = load<kBf>(p.bm, at(p.bm, b, gy, gx, c));
            if (p.ba.p) a[h][i] = load<kBf>(p.ba, at(p.ba, b, gy, gx, c));
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gx = x0 + g + 8 * h;
#pragma unroll
        for (int i = 0; i < kBroadcastPer; ++i) {
          const int c = c0 + i;
          if (gx >= p.W || i >= per || c >= p.bC) continue;
          float o = a[h][i] + v[h] * m[h][i];
          if (p.clamp) o = fminf(fmaxf(o, 0.f), 1.f);
          store<kBf>(p.out, p.o, at(p.o, b, gy, gx, c), o);
        }
      }
    }
    return;
  }
  if constexpr (kEpi == kSpatialGate || kEpi == kSqueeze) {
    // the squeeze v G0 over the pixel's 8 NT = Cout channels into 8
    // units; lane t keeps units 2t and 2t + 1 and takes them through GELU.
    // fp32: 8 a lane, unit k's sum a pixel over the quad (t) by shuffles,
    // one unit at a time. bf16: on the tensor cores, v rounded to bf16 as
    // the JAX dot's operand: the accumulators of n-tiles 2kb and 2kb + 1
    // are the A fragment of k16 block kb (as P for P V), G0's rows 16 kb ..
    // its B fragment, and the product's D fragment is (pixel g + 8h, units
    // 2t, 2t + 1): a lane's mine.
    float mine[MT][2][2] = {};
    if constexpr (kBf) {
      static_assert(NT % 2 == 0, "the bf16 squeeze takes k16 blocks");
      auto g0 = [&](int ci, int k) {
        return kEpi == kSqueeze ? par<kBf>(p.g0, ci * p.g0i + k * p.g0o)
                                : par<kBf>(p.g0, ci * 8 + k);
      };
      uint32_t gb[NT / 2][2];
#pragma unroll
      for (int kb = 0; kb < NT / 2; ++kb) {
        const int ci = 16 * kb + 2 * t;
        gb[kb][0] = pack_bf16(g0(ci, g), g0(ci + 1, g));
        gb[kb][1] = pack_bf16(g0(ci + 8, g), g0(ci + 9, g));
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kb = 0; kb < NT / 2; ++kb) {
          const float(&lo)[4] = acc[2 * kb][mt];
          const float(&hi)[4] = acc[2 * kb + 1][mt];
          const uint32_t a[4] = {pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
                                 pack_bf16(hi[0], hi[1]),
                                 pack_bf16(hi[2], hi[3])};
          mma_bf16(d, a, gb[kb][0], gb[kb][1]);
        }
        mine[mt][0][0] = d[0];
        mine[mt][0][1] = d[1];
        mine[mt][1][0] = d[2];
        mine[mt][1][1] = d[3];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float gw[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            gw[j][e] = kEpi == kSqueeze
                           ? par<kBf>(p.g0, (8 * j + 2 * t + e) * p.g0i +
                                                k * p.g0o)
                           : par<kBf>(p.g0, (8 * j + 2 * t + e) * 8 + k);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = 0.f;
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                v = fmaf(acc[j][mt][2 * h + e], gw[j][e], v);
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (k == 2 * t) mine[mt][h][0] = v;
            if (k == 2 * t + 1) mine[mt][h][1] = v;
          }
      }
    }
    const float b0 = par<kBf>(p.g0b, 2 * t), b1 = par<kBf>(p.g0b, 2 * t + 1);
    if constexpr (kEpi == kSpatialGate) {
      // g2 on the two units, summed over the quad: the pixel's gate (bf16:
      // the units rounded to bf16 for g2's product)
      const float w0 = par<kBf>(p.g2, 2 * t), w1 = par<kBf>(p.g2, 2 * t + 1);
      const float gb = par<kBf>(p.g2b, 0);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float gs = rnd<kBf>(gelu_erf(mine[mt][h][0] + b0)) * w0 +
                     rnd<kBf>(gelu_erf(mine[mt][h][1] + b1)) * w1;
          gs += __shfl_xor_sync(0xffffffffu, gs, 1);
          gs += __shfl_xor_sync(0xffffffffu, gs, 2);
          const float gate = sigmoidf(gs + gb);
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) acc[j][mt][2 * h + e] *= gate;
        }
    } else {
      // the two units to out2's channels 2t, 2t + 1
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int gy = y0 + MT * warp + mt;
        if (gy >= p.H) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gx = x0 + g + 8 * h;
          if (gx >= p.W) continue;
          const float u0 = gelu_erf(mine[mt][h][0] + b0);
          const float u1 = gelu_erf(mine[mt][h][1] + b1);
          const long long o = at(p.o2, b, gy, gx, 2 * t);
          if (kBf && p.o2.bf) {
            store<kBf>(p.out2, p.o2, o, u0);
            store<kBf>(p.out2, p.o2, o + p.o2.sc, u1);
          } else if (p.o2.sc == 1) {
            *reinterpret_cast<float2*>(p.out2 + o) = make_float2(u0, u1);
          } else {
            p.out2[o] = u0;
            p.out2[o + p.o2.sc] = u1;
          }
        }
      }
    }
  }
  const float alpha = p.alpha ? par<kBf>(p.alpha, 0) : 1.f;
  const float beta = p.beta ? par<kBf>(p.beta, 0) : 1.f;
  const bool pairs = p.o.sc == 1 && (p.o.sx % 2 == 0) &&
                     (reinterpret_cast<size_t>(p.out) % 8 == 0);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int gy = y0 + MT * warp + mt;
    if (gy >= p.H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gx = x0 + g + 8 * h;
      if (gx >= p.W) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = n0 + 8 * j + 2 * t;
        const bool one = co < p.Cout, two = co + 1 < p.Cout;
        float v[2] = {acc[j][mt][2 * h], acc[j][mt][2 * h + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (e ? !two : !one) continue;
          if (p.r1.p)
            v[e] = load<kBf>(p.r1, at(p.r1, b, gy, gx, co + e)) + alpha * v[e];
          if (p.r2.p) v[e] += beta * load<kBf>(p.r2, at(p.r2, b, gy, gx, co + e));
        }
        if constexpr (kBf && kEpi != kSqueeze)
          if (p.out2)  // the bf16 copy: both channels, zeros past Cout
            *reinterpret_cast<uint32_t*>(
                reinterpret_cast<__nv_bfloat16*>(p.out2) +
                at(p.o2, b, gy, gx, co)) =
                pack_bf16(one ? v[0] : 0.f, two ? v[1] : 0.f);
        if (!one) continue;
        const long long o = at(p.o, b, gy, gx, co);
        if (kBf && p.o.bf) {
          if (two && pairs) {
            *reinterpret_cast<__nv_bfloat162*>(
                reinterpret_cast<__nv_bfloat16*>(p.out) + o) =
                __floats2bfloat162_rn(v[0], v[1]);
          } else {
            store<kBf>(p.out, p.o, o, v[0]);
            if (two) store<kBf>(p.out, p.o, o + p.o.sc, v[1]);
          }
        } else if (two && pairs) {
          *reinterpret_cast<float2*>(p.out + o) = make_float2(v[0], v[1]);
        } else {
          p.out[o] = v[0];
          if (two) p.out[o + p.o.sc] = v[1];
        }
      }
    }
  }
}

template <int NT, int MT, int kEpi = kStore, bool kMulti = false,
          bool kBf = false>
int launch(const Conv& p, int B, cudaStream_t stream) {
  using S = Shape<NT, MT, kBf>;
  constexpr bool kSums = kEpi == kSpatialGate || kEpi == kSqueeze;
  if (p.nsrc < 1 || p.nsrc > (kMulti ? 3 : 1))
    return int(cudaErrorInvalidValue);
  int stages = 0;
  for (int i = 0; i < p.nsrc; ++i) {
    stages += p.src[i].stages;
    if (kBf && !p.src[i].vec) return int(cudaErrorInvalidValue);
  }
  if (kBf && p.out2 && kEpi != kSqueeze &&
      (p.o2.sc != 1 || p.o2.sx < p.coutp || p.o2.sx % 2))
    return int(cudaErrorInvalidValue);
  if (p.coutp % S::kN || stages * S::kCh != p.cinp ||
      kSums != (p.g0 != nullptr) ||
      (kSums && (p.Cout != S::kN || p.coutp != S::kN)) ||
      (kEpi == kSqueeze && !p.out2) ||
      (kEpi == kBroadcast) != (p.bm.p != nullptr) ||
      (kEpi == kBroadcast && (NT != 1 || p.Cout != 1 || p.bC < 1 ||
                              p.bC > 4 * kBroadcastPer)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<NT, MT, kEpi, kMulti, kBf>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(S::kSmem));
  if (err != cudaSuccess) return int(err);
  const long long tiles = (long long)((p.H + S::kTH - 1) / S::kTH) *
                          ((p.W + kTW - 1) / kTW);
  if (tiles > 0x7fffffffLL || B > 65535) return int(cudaErrorInvalidValue);
  conv_kernel<NT, MT, kEpi, kMulti, kBf>
      <<<dim3(unsigned(tiles), unsigned(p.coutp / S::kN), unsigned(B)),
         S::kThreads, S::kSmem, stream>>>(p);
  return int(cudaGetLastError());
}

// Appends a source of C channels (vec: 16-byte copies) to p's input, in
// stages of ck channels (kCK, or kCK16 for a bf16 conv); a fourth makes
// the launch refuse p.
inline void add_source(Conv& p, T4 src, int C, int vec, int ck = kCK) {
  const int stages = (C + ck - 1) / ck;
  if (p.nsrc < 3) p.src[p.nsrc] = Src{src, C, vec, stages};
  ++p.nsrc;
  p.cinp += stages * ck;
}

// Whether 16-byte copies can read a [B, H, W, C] tensor: NHWC, C % 4 == 0,
// 16-byte aligned.
inline int vec_ok(const float* p, int C, int nchw) {
  return !nchw && C % 4 == 0 && reinterpret_cast<size_t>(p) % 16 == 0;
}

// Whether a bf16 conv can read t (of any C channels): bf16, NHWC, a pixel
// stride of a multiple of 8 channels, 16-byte aligned. A chunk of 8
// channels is copied whole where it starts below C, so the channels past C
// up to the chunk's end must hold zeros (pack() writes them).
inline int vec_ok_bf16(const T4& t) {
  return t.bf && t.sc == 1 && t.sx % 8 == 0 &&
         reinterpret_cast<size_t>(t.p) % 16 == 0;
}

// pack(): sources concatenated along C into a bf16 NHWC tensor of cp
// channels (a multiple of 8; zeros past the sources'), each source's
// values times its scale (bf16, on the card; or 1) and then rounded to
// bf16, as the JAX kernels round a conv's input.
struct PackSrc {
  T4 t;
  int C;
  const float* scale;
};

struct Pack {
  PackSrc src[3];
  int nsrc, cp, B, H, W;
  __nv_bfloat16* out;    // [B, H, W, cp]
};

constexpr int kPackPx = 64;  // pixels a block of pack_kernel

// A block takes kPackPx pixels of one image (consecutive in its rows) in
// two passes through shared memory: each channel's run of pixels read
// (coalesced on an NCHW plane), scaled, rounded into the tile; then the
// tile written as whole 16-byte pieces, the block's output one contiguous
// run. Index arithmetic in 32 bits (an image's pixels < 2^31).
static __global__ void __launch_bounds__(256) pack_kernel(Pack p) {
  extern __shared__ __align__(16) unsigned char pack_smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(pack_smem);
  const int ld = p.cp + 8;  // the tile's row: a pixel's channels
  const unsigned hw = unsigned(p.H) * unsigned(p.W);
  const unsigned p0 = blockIdx.x * kPackPx;  // first pixel in the image
  const int b = blockIdx.y, n = min(kPackPx, int(hw - p0));
  for (int i = threadIdx.x; i < p.cp * kPackPx; i += 256) {
    const int c0 = i / kPackPx, px = i % kPackPx;
    float v = 0.f;
    int c = c0, k = 0;
    while (k < p.nsrc && c >= p.src[k].C) c -= p.src[k++].C;
    if (k < p.nsrc && px < n) {
      const PackSrc& q = p.src[k];
      const unsigned pix = p0 + px, y = pix / unsigned(p.W),
                     x = pix - y * unsigned(p.W);
      v = load<true>(q.t, at(q.t, b, int(y), int(x), c)) *
          (q.scale ? par<true>(q.scale, 0) : 1.f);
    }
    tile[px * ld + c0] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  __nv_bfloat16* out = p.out + ((long long)b * hw + p0) * p.cp;
  const int pieces = p.cp / 8;
  for (int i = threadIdx.x; i < n * pieces; i += 256) {
    const int px = i / pieces, c = 8 * (i % pieces);
    *reinterpret_cast<uint4*>(out + px * p.cp + c) =
        *reinterpret_cast<const uint4*>(tile + px * ld + c);
  }
}

// A pack of no source yet into out [B, H, W, cp].
inline Pack pack_into(void* out, int B, int H, int W, int cp) {
  Pack p{};
  p.out = static_cast<__nv_bfloat16*>(out);
  p.cp = cp;
  p.B = B;
  p.H = H;
  p.W = W;
  return p;
}

// Appends a source of C channels, times *scale (bf16) or 1; a fourth makes
// pack() refuse p.
inline void add_pack_source(Pack& p, T4 t, int C,
                            const float* scale = nullptr) {
  if (p.nsrc < 3) p.src[p.nsrc] = PackSrc{t, C, scale};
  ++p.nsrc;
}

inline int pack(const Pack& p, cudaStream_t stream) {
  int C = 0;
  for (int i = 0; i < p.nsrc && i < 3; ++i) C += p.src[i].C;
  const long long hw = (long long)p.H * p.W;
  const size_t smem = sizeof(__nv_bfloat16) * kPackPx * (p.cp + 8);
  if (p.nsrc > 3 || p.cp % 8 || C > p.cp || hw >= (1LL << 31) ||
      p.B > 65535 || smem > 48 * 1024 ||
      reinterpret_cast<size_t>(p.out) % 16)
    return int(cudaErrorInvalidValue);
  pack_kernel<<<dim3(unsigned((hw + kPackPx - 1) / kPackPx), unsigned(p.B)),
                256, smem, stream>>>(p);
  return int(cudaGetLastError());
}

// A conv with its first source, weights and output set and every epilogue
// off (ck: see add_source).
inline Conv plain(T4 src, int Cin, int vec, const float* w, const float* bias,
                  int Cout, int coutp, int act, float* out, T4 o, int H,
                  int W, int ck = kCK) {
  Conv p{};
  add_source(p, src, Cin, vec, ck);
  p.w = w;
  p.bias = bias;
  p.Cout = Cout;
  p.coutp = coutp;
  p.act = act;
  p.out = out;
  p.o = o;
  p.H = H;
  p.W = W;
  return p;
}

}  // namespace conv3x3_tf32
