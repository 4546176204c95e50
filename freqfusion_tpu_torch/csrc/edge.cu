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
// 2 x 32 x 32 + 8) + 2 x (3 + 8) x 32 FLOPs a pixel, 3.63 M pixels over the
// levels (143 GFLOP, 2.1 ms at 67 TFLOP/s fp32) against 35 channels of 4
// bytes a pixel (0.5 GB, 0.15 ms at 3.35 TB/s). Fuse: 9 x 2 x (96 x 32 +
// 32 x 3 + 6 x 16 + 16) FLOPs a pixel (163 GFLOP at 1344x2048, 2.4 ms)
// against 102 channels (1.1 GB, 0.34 ms). fp32 FMA issue, both.
//
// The TPU kernels run each in one halo-4 pass. Here each is a chain of
// launches of csrc/conv3x3.cuh's kernels through NHWC scratch tensors, as
// in csrc/hier.cu, for the same reasons: every stage fits its own register
// tile, and zero padding comes from reading whole images. What the chain
// saves:
//  - refine's 1x1 projection of the input joins conv3 as three more input
//    channels whose 3x3 weights are zero but the centre tap (the wrapper
//    builds the [3, 3, 35, 32] bank): no launch and no 32-channel sum;
//  - the squeeze 32 -> 8 is one per-pixel kernel, and the attention conv
//    multiplies hid by its gate in its epilogue, in place in the output;
//  - fuse's 96-channel concat never exists: the first conv reads its three
//    sources through their strides, with each level's weight folded into
//    its input channels' weights (the wrapper scales the bank); the last
//    conv applies the gate, the strength, the residual and the clip in its
//    epilogue.
// Round trips through device memory: refine ~1.1 KB a pixel (3.9 GB over
// the levels, 1.2 ms at 3.35 TB/s), fuse ~0.4 KB (1.2 GB, 0.35 ms).

#include "conv3x3.cuh"

using namespace conv3x3;

// lap [B, H, W, Cin] and out [B, H, W, F], NHWC-contiguous or (nchw)
// NCHW-contiguous; conv kernels [3, 3, Cin', Cout']: w1 (Cin -> F) + b1,
// w2 (F -> F) + b2, w3p (F + Cin -> F: conv3 and the projection) + b3p,
// a2 (F/4 -> 1) + a2b [1]; a0 [F, F/4] + a0b; scratch t1, t2
// [B, H, W, F] NHWC. All fp32.
extern "C" int ff_edge_refine(const float* lap, int nchw, const float* w1,
                              const float* b1, const float* w2,
                              const float* b2, const float* w3p,
                              const float* b3p, const float* a0,
                              const float* a0b, const float* a2,
                              const float* a2b, float* t1, float* t2,
                              float* out, int B, int H, int W, int Cin, int F,
                              void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const T4 in = tensor(lap, H, W, Cin, nchw), o = tensor(out, H, W, F, nchw);
  const T4 u1 = tensor(t1, H, W, F, 0), u2 = tensor(t2, H, W, F, 0);
  const T4 sq = tensor(t1, H, W, F / 4, 0);
  int err;

  Conv p = plain(w1, b1, F, kGelu, t1, u1, H, W);
  add_source(p, in, Cin);
  if ((err = run(p, B, stream))) return err;
  p = plain(w2, b2, F, kGelu, t2, u2, H, W);
  add_source(p, u1, F);
  if ((err = run(p, B, stream))) return err;
  p = plain(w3p, b3p, F, kNone, out, o, H, W);
  add_source(p, u2, F);
  add_source(p, in, Cin);
  if ((err = run(p, B, stream))) return err;
  if ((err = pixel_gate(o, F, a0, a0b, F / 4, nullptr, nullptr, t1, sq, B, H,
                        W, stream)))
    return err;
  p = plain(a2, a2b, 1, kSigmoid, out, o, H, W);
  add_source(p, sq, F / 4);
  p.bm = o;
  p.bC = F;
  return run(p, B, stream);
}

// sr, out [B, H, W, 3] and f0, f1, f2 [B, H, W, F], NHWC-contiguous or
// (nchw) NCHW-contiguous; strength one float on the card; conv kernels
// wf0 (3F -> F, level l's input channels scaled by its weight lw[l]) +
// bf0, wf2 (F -> 3) + bf2, wg0 (6 -> 16) + bg0,
// wg2 (16 -> 1) + bg2 [1]; scratch e1 [B, H, W, F], e [B, H, W, 3],
// g [B, H, W, 16] NHWC. All fp32.
extern "C" int ff_edge_fuse(const float* sr, const float* f0, const float* f1,
                            const float* f2, int nchw,
                            const float* strength, const float* wf0,
                            const float* bf0, const float* wf2,
                            const float* bf2, const float* wg0,
                            const float* bg0, const float* wg2,
                            const float* bg2, float* e1, float* e, float* g,
                            float* out, int B, int H, int W, int F,
                            void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const T4 s = tensor(sr, H, W, 3, nchw);
  const T4 u1 = tensor(e1, H, W, F, 0), ue = tensor(e, H, W, 3, 0);
  const T4 ug = tensor(g, H, W, 16, 0);
  int err;

  Conv p = plain(wf0, bf0, F, kGelu, e1, u1, H, W);
  add_source(p, tensor(f0, H, W, F, nchw), F);
  add_source(p, tensor(f1, H, W, F, nchw), F);
  add_source(p, tensor(f2, H, W, F, nchw), F);
  if ((err = run(p, B, stream))) return err;
  p = plain(wf2, bf2, 3, kNone, e, ue, H, W);
  add_source(p, u1, F);
  if ((err = run(p, B, stream))) return err;
  p = plain(wg0, bg0, 16, kGelu, g, ug, H, W);
  add_source(p, s, 3);
  add_source(p, ue, 3);
  if ((err = run(p, B, stream))) return err;
  p = plain(wg2, bg2, 1, kSigmoid, out, tensor(out, H, W, 3, nchw), H, W);
  add_source(p, ug, 16);
  p.ba = s;
  p.bm = ue;
  p.bk = strength;
  p.bC = 3;
  p.clamp = 1;
  return run(p, B, stream);
}
