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
