// Window multi-head self-attention straight from NHWC q/k/v, fp32.
//
// Replaces the Pallas kernel freqfusion_tpu/ops/pallas_attention.py:
// fused_window_attention_nhwc (:238), which DRCT-L calls once per Swin
// block (freqfusion_tpu/models/drct.py:126-130). The kernel, what bounds
// it and its design are in window_attention.cuh, which
// window_attention_qkv.cu shares.

#include "window_attention.cuh"

// q, k, v, out: [B, H, W, C] fp32 contiguous; bias [heads, N, N];
// mask [nW, N, N] or null (N = ws * ws, H % ws == 0 == W % ws).
extern "C" int ff_window_attention_nhwc(const float* q, const float* k,
                                        const float* v, const float* bias,
                                        const float* mask, float* out, int B,
                                        int H, int W, int C, int num_heads,
                                        int ws, float scale, void* stream) {
  return int(window_attention_launch(q, k, v, C, bias, mask, out, B, H, W, C,
                                     num_heads, ws, scale,
                                     static_cast<cudaStream_t>(stream)));
}
