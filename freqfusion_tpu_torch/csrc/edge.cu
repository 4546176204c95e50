// The fusion net's Laplacian edge refinement, fp32, in two entries:
//
// refine (one EdgeRefineBlock, per pyramid level):
//   h   = gelu(conv3x3(gelu(conv3x3(x) + b1)) + b2)        3 -> 32 -> 32
//   hid = conv3x3(h) + b3 + x P + bp                 32 -> 32; 1x1 3 -> 32
//   out = hid * sigmoid(conv3x3(gelu(hid A0 + a0)) + a2)    32 -> 8 -> 1
// fuse (the three levels, already at HR, with the softmaxed level weights
// lw and the edge strength k):
//   edge = conv3x3(gelu(conv3x3(cat(lw0 f0, lw1 f1, lw2 f2)) + b) + b)
//                                                     96 -> 32 -> 3
//   gate = sigmoid(conv3x3(gelu(conv3x3(cat(sr, edge)) + b)) + b)
//                                                     6 -> 16 -> 1
//   out  = clip(sr + gate * k * edge, 0, 1)
// with exact (erf) GELU and zero padding at the image edges.
//
// Replaces the Pallas kernels freqfusion_tpu/ops/pallas_edge.py:
// edge_refine_fused (:143) and edge_fuse_fused (:255), which
// FREQFUSION_EDGE=1 routes the 3-level edge refinement through
// (freqfusion_tpu/models/fusion/edge.py:109): refine at 1344x2048, 672x1024
// and 336x512, fuse at 1344x2048, for the 336x512 bucket.
//
// What bounds them on the H100: the 3x3 convs. Refine: 9 x 2 x (3 x 32 +
// 2 x 32 x 32 + 8) + 2 x (3 + 8) x 32 FLOPs a pixel, 3.61 M pixels over the
// levels (142.5 GFLOP: 0.86 ms as three TF32 products at 495 TFLOP/s, 2.1
// on the fp32 cores) against 35 channels of 4 bytes a pixel (0.5 GB, 0.15
// ms at 3.35 TB/s). Fuse: 9 x 2 x (96 x 32 + 32 x 3 + 6 x 16 + 16) FLOPs a
// pixel (162.5 GFLOP at 1344x2048: 0.99 ms in 3xTF32, 2.4 on the fp32
// cores) against 102 channels (1.1 GB, 0.34 ms). Operations, both. The old
// bodies ran the convs as register-tiled fp32 FMA loops (13.7 and 8.4 ms
// on an H100 at 700 W), held by FMA issue; so every conv runs on the
// tensor cores in 3xTF32, as #19's do (csrc/conv3x3_tf32.cuh).
//
// The TPU kernels run each in one halo-4 pass. Here each is a chain of
// conv launches through NHWC scratch tensors, as in csrc/hier.cu, for the
// same reasons: every stage fits its own tile, and zero padding comes from
// reading whole images. One split launch first puts every conv's weights
// in fragment order into one scratch, and does what would otherwise be
// PyTorch work around the call: refine's 1x1 projection becomes the
// centre tap of conv3's second source, fuse's level weights scale their
// sources' rows (read on the card). So a call launches no PyTorch kernel.
// What the chain saves:
//  - refine's projection joins conv3 as a second source (lap, 3 channels
//    padded to 8): no launch and no 32-channel sum; its bias is conv3's
//    second;
//  - refine's conv3 block holds all 32 channels, so its epilogue writes
//    hid and the squeeze gelu(hid A0 + a0) (8 channels, a lane's two units
//    as one float2) side by side into one NHWC scratch, with no launch of
//    its own; the attention conv (Cout 1) reads the squeeze as its source
//    and hid in its epilogue (a lane's 8 channels as two 16-byte loads:
//    0.34 ms at 1344x2048 against 0.60 for hid read back from the NCHW
//    output by 4-byte loads) and writes hid times its gate;
//  - fuse's 96-channel concat never exists: fusion_0 reads its three
//    sources through their strides; edge_gate_0 reads (sr, edge) as two
//    sources; edge_gate_2 applies the gate, the strength, the residual and
//    the clip in its epilogue.
// Tiles: the 32-channel convs (conv1-3, fusion_0) 24 x 16 pixels and all
// 32 channels a block (#19's conv1), the 16-channel one 32 x 16, Cout 3 and
// 1 padded to one n-tile on 32 x 16.
//
// bf16 (ff_edge_refine_bf16, ff_edge_fuse_bf16: the JAX kernels on bf16
// images and weights): the same chains on the bf16 convs of
// conv3x3_tf32.cuh, each conv's input in bf16, the 1x1 squeeze's operands
// rounded in conv3's epilogue, fp32 sums. A pack launch first makes the
// NCHW inputs NHWC bf16 tensors of whole 16-byte pixels (the convs read by
// 16-byte copies): lap and sr in 8 channels (zeros past 3); fuse's three
// levels in one 3F-channel tensor, each times its level weight before the
// rounding (JAX's lw f, rounded by fusion_0), so the weights are not
// folded into fusion_0's. What crosses device memory follows what each
// value feeds: refine's two GELU outputs and its squeeze feed only a conv
// (bf16); hid feeds the squeeze and the output product (fp32). Fuse's
// fusion_0 output feeds only a conv (bf16); the edge map feeds edge_gate_0
// and the output, so fusion_2 writes it in fp32 and as a bf16 copy;
// the gate's hidden feeds only a conv (bf16). Bounds at the bf16 rate (989
// TFLOP/s): refine 142.5 GFLOP over the levels, 0.14 ms; fuse 162.5, 0.16
// ms.

#include "conv3x3_tf32.cuh"

using namespace conv3x3_tf32;

namespace {

// n-tiles a block of each conv: refine's conv1, conv2, conv3 (+ the
// projection), attention conv; fuse's fusion_0, fusion_2, edge_gate_0,
// edge_gate_2
constexpr int kNT[2][4] = {{4, 4, 4, 1}, {4, 1, 2, 1}};
constexpr int kGate = 16;  // edge_gate_0's outputs

// bf: the bf16 convs' stages of 16 channels, else 8.
int pad(int c, bool bf = false) {
  const int ck = bf ? kCK16 : kCK;
  return (c + ck - 1) / ck * ck;
}

struct EdgePlan {
  int cinp[4], coutp[4];
  long long off[5];  // floats (4-byte words): conv i's split weights
};

// bf: the bf16 convs (4.5 cinp coutp words of split weights a conv, 18
// cinp coutp floats in fp32).
EdgePlan edge_plan(int Cin, int F, int fuse, bool bf = false) {
  const int cinp[2][4] = {
      {pad(Cin, bf), pad(F, bf), pad(F, bf) + pad(Cin, bf), pad(F / 4, bf)},
      {3 * pad(F, bf), pad(F, bf), 2 * pad(3, bf), pad(kGate, bf)}};
  const int cout[2][4] = {{F, F, F, 1}, {F, 3, kGate, 1}};
  EdgePlan q;
  q.off[0] = 0;
  for (int i = 0; i < 4; ++i) {
    const int n = 8 * kNT[fuse][i];
    q.cinp[i] = cinp[fuse][i];
    q.coutp[i] = (cout[fuse][i] + n - 1) / n * n;
    q.off[i + 1] = q.off[i] + (bf ? 9LL * q.cinp[i] * q.coutp[i] / 2
                                  : 18LL * q.cinp[i] * q.coutp[i]);
  }
  return q;
}

bool bad_scratch(const float* scratch, long long floats, long long need) {
  return floats < need || reinterpret_cast<size_t>(scratch) % 16;
}

}  // namespace

// Floats of scratch ff_edge_refine (fuse 0, lap of Cin channels) or
// ff_edge_fuse (fuse 1) needs: the four convs' weights split, 18 cinp
// coutp floats each.
extern "C" long long ff_edge_scratch_floats(int Cin, int F, int fuse) {
  return edge_plan(Cin, F, fuse != 0).off[4];
}

// The same for ff_edge_refine_bf16 (fuse 0) and ff_edge_fuse_bf16 (1).
extern "C" long long ff_edge_bf16_scratch_floats(int Cin, int F, int fuse) {
  return edge_plan(Cin, F, fuse != 0, true).off[4];
}

// lap [B, H, W, Cin] and out [B, H, W, F], NHWC-contiguous or (nchw)
// NCHW-contiguous; conv kernels [kh, kw, Cin', Cout'] (HWIO) through their
// element strides (kh, kw, Cin', Cout'; the module's views of its OIHW
// weights need no copy) with F = 32: w1 (Cin -> F) + b1, w2 (F -> F) + b2,
// w3 (F -> F) + b3, the projection wp [1, 1, Cin, F] + bp, a0 [1, 1, F,
// F/4] + a0b, a2 (F/4 -> 1) + a2b [1]; scratch t1 [B, H, W, F + F/4], t2
// [B, H, W, F] NHWC and the split weights' (ff_edge_scratch_floats), each
// 16-byte aligned. All fp32.
// A kernel argument, its pointer and four strides, and its W4.
#define FF_KERNEL(w) \
  const float *w, int w##h, int w##w, int w##i, int w##o
#define FF_W4(w) W4{w, w##h, w##w, w##i, w##o}
extern "C" int ff_edge_refine(const float* lap, int nchw, FF_KERNEL(w1),
                              const float* b1, FF_KERNEL(w2),
                              const float* b2, FF_KERNEL(w3),
                              const float* b3, FF_KERNEL(wp),
                              const float* bp, FF_KERNEL(a0),
                              const float* a0b, FF_KERNEL(a2),
                              const float* a2b, float* t1, float* t2,
                              float* scratch, long long scratch_floats,
                              float* out, int B, int H, int W, int Cin, int F,
                              void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (F != 32 || Cin < 1 ||
      bad_scratch(scratch, scratch_floats, ff_edge_scratch_floats(Cin, F, 0)))
    return int(cudaErrorInvalidValue);
  const EdgePlan q = edge_plan(Cin, F, 0);
  auto wt = [&](int i) { return scratch + q.off[i]; };
  SplitJobs<4> jobs;
  jobs.job[0] = split_job(FF_W4(w1), wt(0), Cin, F, q.coutp[0], kNT[0][0]);
  jobs.job[1] = split_job(FF_W4(w2), wt(1), F, F, q.coutp[1], kNT[0][1]);
  jobs.job[2] = split_job(FF_W4(w3), wt(2), F, F, q.coutp[2], kNT[0][2]);
  add_split_source(jobs.job[2], FF_W4(wp), Cin, 1);
  jobs.job[3] = split_job(FF_W4(a2), wt(3), F / 4, 1, q.coutp[3], kNT[0][3]);
  cudaError_t e = split(jobs, stream);
  if (e != cudaSuccess) return int(e);

  const T4 in = tensor(lap, H, W, Cin, nchw), o = tensor(out, H, W, F, nchw);
  const T4 u1 = tensor(t1, H, W, F, 0), u2 = tensor(t2, H, W, F, 0);
  // conv3's outputs, a pixel's hid and squeeze side by side in t1 (conv2
  // has read it): F + F/4 channels
  const T4 hid = tensor(t1, H, W, F + F / 4, 0);
  const T4 sq = T4{t1 + F, hid.sb, hid.sy, hid.sx, 1};
  const int vin = vec_ok(lap, Cin, nchw);
  int err;

  Conv p = plain(in, Cin, vin, wt(0), b1, F, q.coutp[0], kGelu, t1, u1, H, W);
  if ((err = launch<4, 3>(p, B, stream))) return err;
  p = plain(u1, F, 1, wt(1), b2, F, q.coutp[1], kGelu, t2, u2, H, W);
  if ((err = launch<4, 3>(p, B, stream))) return err;
  p = plain(u2, F, 1, wt(2), b3, F, q.coutp[2], kNone, t1, hid, H, W);
  add_source(p, in, Cin, vin);
  p.bias2 = bp;
  p.g0 = a0;
  p.g0i = a0i;
  p.g0o = a0o;
  p.g0b = a0b;
  p.out2 = t1 + F;
  p.o2 = sq;
  if ((err = launch<4, 3, kSqueeze, true>(p, B, stream))) return err;
  p = plain(sq, F / 4, 1, wt(3), a2b, 1, q.coutp[3], kSigmoid, out, o, H, W);
  p.bm = hid;
  p.bC = F;
  return launch<1, 4, kBroadcast>(p, B, stream);
}

// sr, out [B, H, W, 3] and f0, f1, f2 [B, H, W, F], NHWC-contiguous or
// (nchw) NCHW-contiguous; lw [3] and strength one float on the card; conv
// kernels (HWIO, through their strides as refine's) wf0 (3F -> F) + bf0,
// wf2 (F -> 3) + bf2, wg0 (6 -> 16) + bg0, wg2 (16 -> 1) + bg2 [1];
// scratch e1 [B, H, W, F], e [B, H, W, 3], g [B, H, W, 16] NHWC and the
// split weights' (ff_edge_scratch_floats, 16-byte aligned). All fp32.
extern "C" int ff_edge_fuse(const float* sr, const float* f0, const float* f1,
                            const float* f2, int nchw, const float* lw,
                            const float* strength, FF_KERNEL(wf0),
                            const float* bf0, FF_KERNEL(wf2),
                            const float* bf2, FF_KERNEL(wg0),
                            const float* bg0, FF_KERNEL(wg2),
                            const float* bg2, float* e1, float* e, float* g,
                            float* scratch, long long scratch_floats,
                            float* out, int B, int H, int W, int F,
                            void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (F < 1 ||
      bad_scratch(scratch, scratch_floats, ff_edge_scratch_floats(3, F, 1)))
    return int(cudaErrorInvalidValue);
  const EdgePlan q = edge_plan(3, F, 1);
  auto wt = [&](int i) { return scratch + q.off[i]; };
  // a source's rows of a kernel: its W4 from row r on
  auto rows = [](W4 w, int r) {
    w.p += r * w.si;
    return w;
  };
  SplitJobs<4> jobs;
  jobs.job[0] = split_job(wt(0), F, q.coutp[0], kNT[1][0]);
  for (int l = 0; l < 3; ++l)  // level l's rows, scaled by lw[l]
    add_split_source(jobs.job[0], rows(FF_W4(wf0), l * F), F, 3, lw + l);
  jobs.job[1] = split_job(FF_W4(wf2), wt(1), F, 3, q.coutp[1], kNT[1][1]);
  jobs.job[2] = split_job(wt(2), kGate, q.coutp[2], kNT[1][2]);
  add_split_source(jobs.job[2], FF_W4(wg0), 3);           // sr's rows
  add_split_source(jobs.job[2], rows(FF_W4(wg0), 3), 3);  // edge's
  jobs.job[3] = split_job(FF_W4(wg2), wt(3), kGate, 1, q.coutp[3], kNT[1][3]);
  cudaError_t ce = split(jobs, stream);
  if (ce != cudaSuccess) return int(ce);

  const T4 s = tensor(sr, H, W, 3, nchw);
  const T4 u1 = tensor(e1, H, W, F, 0), ue = tensor(e, H, W, 3, 0);
  const T4 ug = tensor(g, H, W, kGate, 0);
  int err;

  Conv p = plain(tensor(f0, H, W, F, nchw), F, vec_ok(f0, F, nchw), wt(0),
                 bf0, F, q.coutp[0], kGelu, e1, u1, H, W);
  add_source(p, tensor(f1, H, W, F, nchw), F, vec_ok(f1, F, nchw));
  add_source(p, tensor(f2, H, W, F, nchw), F, vec_ok(f2, F, nchw));
  if ((err = launch<4, 3, kStore, true>(p, B, stream))) return err;
  p = plain(u1, F, vec_ok(e1, F, 0), wt(1), bf2, 3, q.coutp[1], kNone, e, ue,
            H, W);
  if ((err = launch<1, 4>(p, B, stream))) return err;
  p = plain(s, 3, 0, wt(2), bg0, kGate, q.coutp[2], kGelu, g, ug, H, W);
  add_source(p, ue, 3, 0);
  if ((err = launch<2, 4, kStore, true>(p, B, stream))) return err;
  p = plain(ug, kGate, 1, wt(3), bg2, 1, q.coutp[3], kSigmoid, out,
            tensor(out, H, W, 3, nchw), H, W);
  p.ba = s;
  p.bm = ue;
  p.bk = strength;
  p.bC = 3;
  p.clamp = 1;
  return launch<1, 4, kBroadcast>(p, B, stream);
}

// The bf16 versions: every tensor, weight and bias bf16 (shapes and
// layouts as ff_edge_refine's and ff_edge_fuse's, the weights through
// their strides), lw and strength bf16 on the card.
//
// refine's scratch: lp [B, H, W, 8] bf16 (lap made NHWC, zeros past Cin),
// u1 [B, H, W, F] bf16 (conv1's output, then the squeeze's F/4 channels),
// u2 [B, H, W, F] bf16, hid [B, H, W, F] fp32 and the split weights'
// (ff_edge_bf16_scratch_floats), each 16-byte aligned.
extern "C" int ff_edge_refine_bf16(const void* lap, int nchw, FF_KERNEL(w1),
                                   const float* b1, FF_KERNEL(w2),
                                   const float* b2, FF_KERNEL(w3),
                                   const float* b3, FF_KERNEL(wp),
                                   const float* bp, FF_KERNEL(a0),
                                   const float* a0b, FF_KERNEL(a2),
                                   const float* a2b, void* lp, void* u1,
                                   void* u2, float* hid, float* scratch,
                                   long long scratch_floats, void* out, int B,
                                   int H, int W, int Cin, int F,
                                   void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (F != 32 || Cin < 1 || Cin > 8 ||
      bad_scratch(scratch, scratch_floats,
                  ff_edge_bf16_scratch_floats(Cin, F, 0)))
    return int(cudaErrorInvalidValue);
  const EdgePlan q = edge_plan(Cin, F, 0, true);
  auto wt = [&](int i) { return scratch + q.off[i]; };
  SplitJobs<4> jobs;
  jobs.job[0] = split_job(FF_W4(w1), wt(0), Cin, F, q.coutp[0], kNT[0][0],
                          kCK16);
  jobs.job[1] = split_job(FF_W4(w2), wt(1), F, F, q.coutp[1], kNT[0][1],
                          kCK16);
  jobs.job[2] = split_job(FF_W4(w3), wt(2), F, F, q.coutp[2], kNT[0][2],
                          kCK16);
  add_split_source(jobs.job[2], FF_W4(wp), Cin, 1);
  jobs.job[3] = split_job(FF_W4(a2), wt(3), F / 4, 1, q.coutp[3], kNT[0][3],
                          kCK16);
  cudaError_t e = split<4, true>(jobs, stream);
  if (e != cudaSuccess) return int(e);
  Pack pk = pack_into(lp, B, H, W, 8);
  add_pack_source(pk, tensor_bf16(lap, H, W, Cin, nchw), Cin);
  int err;
  if ((err = pack(pk, stream))) return err;

  auto o = [](void* v) { return static_cast<float*>(v); };
  const T4 in = tensor_bf16(lp, H, W, 8, 0);
  const T4 ou = tensor_bf16(out, H, W, F, nchw);
  const T4 t1 = tensor_bf16(u1, H, W, F, 0), t2 = tensor_bf16(u2, H, W, F, 0);
  const T4 th = tensor(hid, H, W, F, 0);
  const T4 sq = tensor_bf16(u1, H, W, F / 4, 0);  // conv2 has read u1

  Conv p = plain(in, Cin, 1, wt(0), b1, F, q.coutp[0], kGelu, o(u1), t1, H,
                 W, kCK16);
  if ((err = launch<4, 3, kStore, false, true>(p, B, stream))) return err;
  p = plain(t1, F, 1, wt(1), b2, F, q.coutp[1], kGelu, o(u2), t2, H, W,
            kCK16);
  if ((err = launch<4, 3, kStore, false, true>(p, B, stream))) return err;
  p = plain(t2, F, 1, wt(2), b3, F, q.coutp[2], kNone, hid, th, H, W, kCK16);
  add_source(p, in, Cin, 1, kCK16);
  p.bias2 = bp;
  p.g0 = a0;
  p.g0i = a0i;
  p.g0o = a0o;
  p.g0b = a0b;
  p.out2 = o(u1);
  p.o2 = sq;
  if ((err = launch<4, 3, kSqueeze, true, true>(p, B, stream))) return err;
  p = plain(sq, F / 4, 1, wt(3), a2b, 1, q.coutp[3], kSigmoid, o(out), ou, H,
            W, kCK16);
  p.bm = th;
  p.bC = F;
  return launch<1, 4, kBroadcast, false, true>(p, B, stream);
}

// fuse's scratch: lv [B, H, W, 3F] bf16 (the levels times their weights,
// rounded, NHWC), sp [B, H, W, 8] bf16 (sr made NHWC), e1 [B, H, W, F]
// bf16, e [B, H, W, 3] fp32 (the edge map) and eb [B, H, W, 8] bf16 (its
// copy), g [B, H, W, 16] bf16 and the split weights'
// (ff_edge_bf16_scratch_floats), each 16-byte aligned.
extern "C" int ff_edge_fuse_bf16(const void* sr, const void* f0,
                                 const void* f1, const void* f2, int nchw,
                                 const float* lw, const float* strength,
                                 FF_KERNEL(wf0), const float* bf0,
                                 FF_KERNEL(wf2), const float* bf2,
                                 FF_KERNEL(wg0), const float* bg0,
                                 FF_KERNEL(wg2), const float* bg2, void* lv,
                                 void* sp, void* e1, float* e, void* eb,
                                 void* g, float* scratch,
                                 long long scratch_floats, void* out, int B,
                                 int H, int W, int F, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (F < 1 || F % 8 ||
      bad_scratch(scratch, scratch_floats,
                  ff_edge_bf16_scratch_floats(3, F, 1)))
    return int(cudaErrorInvalidValue);
  const EdgePlan q = edge_plan(3, F, 1, true);
  auto wt = [&](int i) { return scratch + q.off[i]; };
  auto rows = [](W4 w, int r) {  // a source's rows: W4 from row r on
    w.p = reinterpret_cast<const float*>(
        reinterpret_cast<const __nv_bfloat16*>(w.p) + r * w.si);
    return w;
  };
  SplitJobs<4> jobs;
  jobs.job[0] = split_job(wt(0), F, q.coutp[0], kNT[1][0], kCK16);
  for (int l = 0; l < 3; ++l)
    add_split_source(jobs.job[0], rows(FF_W4(wf0), l * F), F);
  jobs.job[1] = split_job(FF_W4(wf2), wt(1), F, 3, q.coutp[1], kNT[1][1],
                          kCK16);
  jobs.job[2] = split_job(wt(2), kGate, q.coutp[2], kNT[1][2], kCK16);
  add_split_source(jobs.job[2], FF_W4(wg0), 3);           // sr's rows
  add_split_source(jobs.job[2], rows(FF_W4(wg0), 3), 3);  // edge's
  jobs.job[3] = split_job(FF_W4(wg2), wt(3), kGate, 1, q.coutp[3], kNT[1][3],
                          kCK16);
  cudaError_t ce = split<4, true>(jobs, stream);
  if (ce != cudaSuccess) return int(ce);
  // the levels times lw, rounded (JAX's lw f, rounded by fusion_0), and sr
  const void* lvl[3] = {f0, f1, f2};
  Pack pk = pack_into(lv, B, H, W, 3 * F);
  for (int l = 0; l < 3; ++l)
    add_pack_source(pk, tensor_bf16(lvl[l], H, W, F, nchw), F,
                    reinterpret_cast<const float*>(
                        reinterpret_cast<const __nv_bfloat16*>(lw) + l));
  int err;
  if ((err = pack(pk, stream))) return err;
  pk = pack_into(sp, B, H, W, 8);
  add_pack_source(pk, tensor_bf16(sr, H, W, 3, nchw), 3);
  if ((err = pack(pk, stream))) return err;

  auto o = [](void* v) { return static_cast<float*>(v); };
  const T4 s = tensor_bf16(sp, H, W, 8, 0), ul = tensor_bf16(lv, H, W, 3 * F, 0);
  const T4 u1 = tensor_bf16(e1, H, W, F, 0), ue = tensor(e, H, W, 3, 0);
  const T4 ueb = tensor_bf16(eb, H, W, 8, 0);
  const T4 ug = tensor_bf16(g, H, W, kGate, 0);

  Conv p = plain(ul, 3 * F, 1, wt(0), bf0, F, q.coutp[0], kGelu, o(e1), u1,
                 H, W, kCK16);
  if ((err = launch<4, 3, kStore, false, true>(p, B, stream))) return err;
  p = plain(u1, F, 1, wt(1), bf2, 3, q.coutp[1], kNone, e, ue, H, W, kCK16);
  p.out2 = o(eb);  // the edge map's bf16 copy, zeros past its 3 channels
  p.o2 = ueb;
  if ((err = launch<1, 4, kStore, false, true>(p, B, stream))) return err;
  p = plain(s, 3, 1, wt(2), bg0, kGate, q.coutp[2], kGelu, o(g), ug, H, W,
            kCK16);
  add_source(p, ueb, 3, 1, kCK16);
  if ((err = launch<2, 4, kStore, true, true>(p, B, stream))) return err;
  p = plain(ug, kGate, 1, wt(3), bg2, 1, q.coutp[3], kSigmoid, o(out),
            tensor_bf16(out, H, W, 3, nchw), H, W, kCK16);
  p.ba = s;
  p.bm = ue;
  p.bk = strength;
  p.bC = 3;
  p.clamp = 1;
  return launch<1, 4, kBroadcast, false, true>(p, B, stream);
}

#undef FF_W4
#undef FF_KERNEL
