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
// pixel (473 GFLOP at 1344x2048, 7.1 ms at 67 TFLOP/s fp32), against 79
// channels of 4 bytes in and out per pixel (0.87 GB, 0.26 ms at 3.35
// TB/s). fp32 FMA issue.
//
// The TPU kernel runs the chain in one halo-6 pass. On this card a 16 x 16
// output tile's 28 x 28 x 76 input block is 238 KB, over a block's 227 KB,
// and the chain's six stages want different thread layouts, so the call is
// seven launches of csrc/conv3x3.cuh's kernels through two scratch tensors
// at HR (64 and 32 channels, NHWC): conv0, conv1, the per-pixel gate (in
// place), the residual block's two convs (the second with both residuals
// in its epilogue, in place), to_rgb's two convs (the last writes the
// output in the input's layout). Each intermediate makes one round trip
// through device memory, about 1.8 KB a pixel in all (4.9 GB, 1.5 ms at
// 3.35 TB/s): a fifth of the compute bound, paid for convs that each fit
// the register tile. Zero padding comes from each conv reading a whole
// image from device memory, so no stage needs a mask.

#include "conv3x3.cuh"

using namespace conv3x3;

// s3 [B, H, W, Cin] and out [B, H, W, 3], NHWC-contiguous or (nchw)
// NCHW-contiguous; conv kernels [3, 3, Cin', Cout'] with C1 = 64 (bc):
// w0 (Cin -> C1) + b0, w2 (C1 -> C1/2) + b2, r0 / r2 (C1/2 -> C1/2, no
// bias), t0 (C1/2 -> C1/4) + t0b, t2 (C1/4 -> 3) + t2b; the gate's g0
// [C1/2, C1/8] + g0b, g2 [C1/8] + g2b [1]; scale, rw23 one float each on
// the card; scratch buf64 [B, H, W, C1], buf32 [B, H, W, C1/2]. All fp32.
extern "C" int ff_hier_stage3(const float* s3, int nchw, const float* w0,
                              const float* b0, const float* w2,
                              const float* b2, const float* g0,
                              const float* g0b, const float* g2,
                              const float* g2b, const float* r0,
                              const float* r2, const float* t0,
                              const float* t0b, const float* t2,
                              const float* t2b, const float* scale,
                              const float* rw23, float* buf64, float* buf32,
                              float* out, int B, int H, int W, int Cin, int C1,
                              void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int c2 = C1 / 2, cg = c2 / 4, ct = C1 / 4;
  const T4 in = tensor(s3, H, W, Cin, nchw);
  const T4 a64 = tensor(buf64, H, W, C1, 0), a32 = tensor(buf32, H, W, c2, 0);
  const T4 g32 = tensor(buf64, H, W, c2, 0), r16 = tensor(buf64, H, W, ct, 0);
  int err;

  Conv p = plain(w0, b0, C1, kGelu, buf64, a64, H, W);
  add_source(p, in, Cin);
  if ((err = run(p, B, stream))) return err;
  p = plain(w2, b2, c2, kGelu, buf32, a32, H, W);
  add_source(p, a64, C1);
  if ((err = run(p, B, stream))) return err;
  if ((err = pixel_gate(a32, c2, g0, g0b, cg, g2, g2b, buf32, a32, B, H, W,
                        stream)))
    return err;
  p = plain(r0, nullptr, c2, kGelu, buf64, g32, H, W);
  add_source(p, a32, c2);
  if ((err = run(p, B, stream))) return err;
  p = plain(r2, nullptr, c2, kNone, buf32, a32, H, W);
  add_source(p, g32, c2);
  p.r1 = a32;
  p.alpha = scale;
  p.r2 = in;  // its first c2 channels
  p.beta = rw23;
  if ((err = run(p, B, stream))) return err;
  p = plain(t0, t0b, ct, kGelu, buf64, r16, H, W);
  add_source(p, a32, c2);
  if ((err = run(p, B, stream))) return err;
  p = plain(t2, t2b, 3, kSigmoid, out, tensor(out, H, W, 3, nchw), H, W);
  add_source(p, r16, ct);
  return run(p, B, stream);
}
