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
// pixel (471.7 GFLOP at 1344x2048: 7.04 ms on the fp32 cores at 67
// TFLOP/s, 2.86 ms as three TF32 products at 495 TFLOP/s) against 79
// channels of 4 bytes in and out per pixel (0.87 GB, 0.26 ms at 3.35
// TB/s). The old body ran the convs as register-tiled fp32 FMA loops
// (27.4 ms on an H100 at 700 W), held by FMA issue. So
// every conv runs on the tensor cores in 3xTF32, as an implicit GEMM
// (csrc/conv3x3_tf32.cuh, #15's convolution without its LayerNorm): 9.5-9.6
// ms there, the convs at ~125-150 TFLOP/s of tensor work.
//
// The TPU kernel runs the chain in one halo-6 pass. On this card a 16 x 16
// output tile's 28 x 28 x 76 input block is 238 KB, over a block's 227 KB,
// and the chain's stages want different tiles, so the call is seven
// launches through two scratch tensors at HR (64 and 32 channels, NHWC):
// the six convs' weights split once into fragment order, conv0 (two
// blocks of 4 n-tiles a tile: 8 n-tiles a warp spill at 128 registers),
// conv1 with the SpatialGate in its epilogue (its 32 channels
// are one block's: the squeeze's sums go over a lane quad by shuffles),
// the residual block's two convs (the second with both residuals in its
// epilogue, in place), all four on 24 x 16 tiles (3 m-tiles a warp),
// to_rgb's two convs on 32 x 16 tiles (2 and 1
// n-tiles; the last, Cout 3 padded to 8, writes the output in the input's
// layout). Each intermediate makes one round trip through device memory,
// about 1.6 KB a pixel in all (4.4 GB, 1.3 ms at 3.35 TB/s). Zero padding
// comes from each conv reading a whole image from device memory.
//
// bf16 (ff_hier_stage3_bf16, the JAX kernel on bf16 s3_in and weights):
// the same chain on the bf16 convs of conv3x3_tf32.cuh, which round each
// conv's input and the gate's operands to bf16 and sum in fp32, as the
// JAX kernel does, after one pack launch that makes s3_in an NHWC tensor of
// 80 channels (the convs read their inputs by 16-byte copies; s3_in comes
// NCHW from the module's concat). What crosses device memory follows what
// each value feeds: conv0's and block_0's GELU outputs and f3 feed only a
// conv, so they go as bf16; f = a sigmoid(g) feeds block_0 and f3's
// residual, so conv1 writes it in fp32 for the residual and as a bf16 copy
// for block_0 (the gate's a never leaves conv1's registers); the output is
// bf16 (sigmoid, then rounded). 471.7 GFLOP at 1344x2048 is 0.48 ms of
// bf16 tensor work at 989 TFLOP/s.

#include "conv3x3_tf32.cuh"

using namespace conv3x3_tf32;

namespace {

// n-tiles a block of each conv (conv0, conv1, r0, r2, t0, t2)
constexpr int kNT[6] = {4, 4, 4, 4, 2, 1};

struct HierPlan {
  int cin[6], cout[6], cinp[6], coutp[6];
  long long off[7];  // floats: conv i's split weights at off[i]
};

// bf: the bf16 convs (stages of 16 channels, 4.5 cinp coutp words of
// split weights a conv) or the fp32 ones (8; 18 cinp coutp).
HierPlan hier_plan(int Cin, int C1, bool bf = false) {
  const int c2 = C1 / 2, ct = C1 / 4, ck = bf ? kCK16 : kCK;
  const int cin[6] = {Cin, C1, c2, c2, c2, ct};
  const int cout[6] = {C1, c2, c2, c2, ct, 3};
  HierPlan q;
  q.off[0] = 0;
  for (int i = 0; i < 6; ++i) {
    q.cin[i] = cin[i];
    q.cout[i] = cout[i];
    q.cinp[i] = (cin[i] + ck - 1) / ck * ck;
    q.coutp[i] = (cout[i] + 8 * kNT[i] - 1) / (8 * kNT[i]) * 8 * kNT[i];
    q.off[i + 1] =
        q.off[i] + (bf ? 9LL * q.cinp[i] * q.coutp[i] / 2
                       : 18LL * q.cinp[i] * q.coutp[i]);
  }
  return q;
}

}  // namespace

// Floats of scratch ff_hier_stage3 needs: the six convs' weights split,
// 18 cinp coutp floats each.
extern "C" long long ff_hier_scratch_floats(int Cin, int C1) {
  return hier_plan(Cin, C1).off[6];
}

// The same for ff_hier_stage3_bf16: 4.5 cinp coutp 4-byte words a conv.
extern "C" long long ff_hier_bf16_scratch_floats(int Cin, int C1) {
  return hier_plan(Cin, C1, true).off[6];
}

// s3 [B, H, W, Cin] and out [B, H, W, 3], NHWC-contiguous or (nchw)
// NCHW-contiguous; conv kernels [3, 3, Cin', Cout'] with C1 = 64 (bc):
// w0 (Cin -> C1) + b0, w2 (C1 -> C1/2) + b2, r0 / r2 (C1/2 -> C1/2, no
// bias), t0 (C1/2 -> C1/4) + t0b, t2 (C1/4 -> 3) + t2b; the gate's g0
// [C1/2, C1/8] + g0b, g2 [C1/8] + g2b [1]; scale, rw23 one float each on
// the card; scratch buf64 [B, H, W, C1], buf32 [B, H, W, C1/2] and the
// split weights' (ff_hier_scratch_floats, 16-byte aligned). All fp32.
extern "C" int ff_hier_stage3(const float* s3, int nchw, const float* w0,
                              const float* b0, const float* w2,
                              const float* b2, const float* g0,
                              const float* g0b, const float* g2,
                              const float* g2b, const float* r0,
                              const float* r2, const float* t0,
                              const float* t0b, const float* t2,
                              const float* t2b, const float* scale,
                              const float* rw23, float* buf64, float* buf32,
                              float* scratch, long long scratch_floats,
                              float* out, int B, int H, int W, int Cin, int C1,
                              void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (C1 != 64 || Cin < C1 / 2 || scratch_floats < ff_hier_scratch_floats(
                                                       Cin, C1) ||
      reinterpret_cast<size_t>(scratch) % 16)
    return int(cudaErrorInvalidValue);
  const HierPlan q = hier_plan(Cin, C1);
  const float* w[6] = {w0, w2, r0, r2, t0, t2};
  SplitJobs<6> jobs;
  for (int i = 0; i < 6; ++i)
    jobs.job[i] = split_job(hwio(w[i], 3, q.cin[i], q.cout[i]),
                            scratch + q.off[i], q.cin[i], q.cout[i],
                            q.coutp[i], kNT[i]);
  cudaError_t e = split(jobs, stream);
  if (e != cudaSuccess) return int(e);

  const int c2 = C1 / 2, ct = C1 / 4;
  const T4 in = tensor(s3, H, W, Cin, nchw);
  const T4 a64 = tensor(buf64, H, W, C1, 0), a32 = tensor(buf32, H, W, c2, 0);
  const T4 g32 = tensor(buf64, H, W, c2, 0), r16 = tensor(buf64, H, W, ct, 0);
  const int vec_in = vec_ok(s3, Cin, nchw);
  auto wt = [&](int i) { return scratch + q.off[i]; };
  int err;

  Conv p = plain(in, Cin, vec_in, wt(0), b0, C1, q.coutp[0], kGelu, buf64,
                 a64, H, W);
  if ((err = launch<4, 3>(p, B, stream))) return err;
  p = plain(a64, C1, 1, wt(1), b2, c2, q.coutp[1], kGelu, buf32, a32, H, W);
  p.g0 = g0;
  p.g0b = g0b;
  p.g2 = g2;
  p.g2b = g2b;
  if ((err = launch<4, 3, kSpatialGate>(p, B, stream))) return err;
  p = plain(a32, c2, 1, wt(2), nullptr, c2, q.coutp[2], kGelu, buf64, g32, H,
            W);
  if ((err = launch<4, 3>(p, B, stream))) return err;
  p = plain(g32, c2, 1, wt(3), nullptr, c2, q.coutp[3], kNone, buf32, a32, H,
            W);
  p.r1 = a32;
  p.alpha = scale;
  p.r2 = in;  // its first c2 channels
  p.beta = rw23;
  if ((err = launch<4, 3>(p, B, stream))) return err;
  p = plain(a32, c2, 1, wt(4), t0b, ct, q.coutp[4], kGelu, buf64, r16, H, W);
  if ((err = launch<2, 4>(p, B, stream))) return err;
  p = plain(r16, ct, 1, wt(5), t2b, 3, q.coutp[5], kSigmoid, out,
            tensor(out, H, W, 3, nchw), H, W);
  return launch<1, 4>(p, B, stream);
}

// The bf16 version: s3 and out bf16, NHWC-contiguous or (nchw)
// NCHW-contiguous; every weight, bias, scale and rw23 bf16 (shapes as
// ff_hier_stage3's); scratch s3p [B, H, W, Cin padded to 16] bf16 (s3 made
// NHWC, the convs' layout), bufa [B, H, W, C1] bf16, bff [B, H, W, C1/2]
// fp32, bfh [B, H, W, C1/2] bf16 and the split weights'
// (ff_hier_bf16_scratch_floats), each 16-byte aligned: conv0's output in
// bufa, f in bff and its bf16 copy in bfh (conv1 writes both: block_0
// reads the copy, the residual f itself), block_0's output then
// to_rgb_0's in bufa's first half, f3 in its second.
extern "C" int ff_hier_stage3_bf16(
    const void* s3, int nchw, const void* w0, const void* b0, const void* w2,
    const void* b2, const void* g0, const void* g0b, const void* g2,
    const void* g2b, const void* r0, const void* r2, const void* t0,
    const void* t0b, const void* t2, const void* t2b, const void* scale,
    const void* rw23, void* s3p, void* bufa, float* bff, void* bfh,
    float* scratch, long long scratch_floats, void* out, int B, int H, int W,
    int Cin, int C1, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (C1 != 64 || Cin < C1 / 2 ||
      scratch_floats < ff_hier_bf16_scratch_floats(Cin, C1) ||
      reinterpret_cast<size_t>(scratch) % 16)
    return int(cudaErrorInvalidValue);
  const HierPlan q = hier_plan(Cin, C1, true);
  const void* w[6] = {w0, w2, r0, r2, t0, t2};
  SplitJobs<6> jobs;
  for (int i = 0; i < 6; ++i)
    jobs.job[i] = split_job(hwio(static_cast<const float*>(w[i]), 3,
                                 q.cin[i], q.cout[i]),
                            scratch + q.off[i], q.cin[i], q.cout[i],
                            q.coutp[i], kNT[i], kCK16);
  cudaError_t e = split<6, true>(jobs, stream);
  if (e != cudaSuccess) return int(e);
  Pack pk = pack_into(s3p, B, H, W, q.cinp[0]);
  add_pack_source(pk, tensor_bf16(s3, H, W, Cin, nchw), Cin);
  int err;
  if ((err = pack(pk, stream))) return err;

  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto o = [](void* v) { return static_cast<float*>(v); };
  const int c2 = C1 / 2, ct = C1 / 4;
  const long long px = (long long)B * H * W;
  __nv_bfloat16* a = static_cast<__nv_bfloat16*>(bufa);
  __nv_bfloat16 *lo = a, *hi = a + px * c2;  // bufa's halves
  const T4 in = tensor_bf16(s3p, H, W, q.cinp[0], 0);
  const T4 a64 = tensor_bf16(a, H, W, C1, 0), uf = tensor(bff, H, W, c2, 0);
  const T4 uh = tensor_bf16(bfh, H, W, c2, 0);
  const T4 g32 = tensor_bf16(lo, H, W, c2, 0), f3 = tensor_bf16(hi, H, W, c2, 0);
  const T4 r16 = tensor_bf16(lo, H, W, ct, 0);
  auto wt = [&](int i) { return scratch + q.off[i]; };

  Conv p = plain(in, Cin, vec_ok_bf16(in), wt(0), f(b0), C1, q.coutp[0],
                 kGelu, o(a), a64, H, W, kCK16);
  if ((err = launch<4, 3, kStore, false, true>(p, B, stream))) return err;
  p = plain(a64, C1, 1, wt(1), f(b2), c2, q.coutp[1], kGelu, bff, uf, H, W,
            kCK16);
  p.g0 = f(g0);
  p.g0b = f(g0b);
  p.g2 = f(g2);
  p.g2b = f(g2b);
  p.out2 = o(bfh);
  p.o2 = uh;
  if ((err = launch<4, 3, kSpatialGate, false, true>(p, B, stream)))
    return err;
  p = plain(uh, c2, 1, wt(2), nullptr, c2, q.coutp[2], kGelu, o(lo), g32, H,
            W, kCK16);
  if ((err = launch<4, 3, kStore, false, true>(p, B, stream))) return err;
  p = plain(g32, c2, 1, wt(3), nullptr, c2, q.coutp[3], kNone, o(hi), f3, H,
            W, kCK16);
  p.r1 = uf;
  p.alpha = f(scale);
  p.r2 = in;  // its first c2 channels
  p.beta = f(rw23);
  if ((err = launch<4, 3, kStore, false, true>(p, B, stream))) return err;
  p = plain(f3, c2, 1, wt(4), f(t0b), ct, q.coutp[4], kGelu, o(lo), r16, H,
            W, kCK16);
  if ((err = launch<2, 4, kStore, false, true>(p, B, stream))) return err;
  p = plain(r16, ct, 1, wt(5), f(t2b), 3, q.coutp[5], kSigmoid, o(out),
            tensor_bf16(out, H, W, 3, nchw), H, W, kCK16);
  return launch<1, 4, kStore, false, true>(p, B, stream);
}
