// Window multi-head self-attention, fp32, in two layouts.
//
// ff_window_attention_nhwc replaces the Pallas kernel
// freqfusion_tpu/ops/pallas_attention.py:fused_window_attention_nhwc
// (:238), which DRCT-L calls once per Swin block
// (freqfusion_tpu/models/drct.py:126-130), straight from NHWC q/k/v.
// ff_window_attention replaces fused_window_attention (:95), the
// window-major form over already partitioned [B_, N, C] windows; no model
// calls it. Both run the one kernel of window_attention.cuh (which
// window_attention_qkv.cu shares), where what bounds it and its design are
// set out; the window-major form is its WM template flag.

#include "window_attention.cuh"

// q, k, v, out: [B, H, W, C] fp32 contiguous; bias [heads, N, N];
// mask [nW, N, N] or null (N = ws * ws, H % ws == 0 == W % ws); hdp and
// vec from ops/attention.py:plan_window_attention.
extern "C" int ff_window_attention_nhwc(const float* q, const float* k,
                                        const float* v, const float* bias,
                                        const float* mask, float* out, int B,
                                        int H, int W, int C, int num_heads,
                                        int ws, float scale, int hdp, int vec,
                                        void* stream) {
  return int(window_attention_launch(q, k, v, C, bias, mask, out, B, H, W, C,
                                     num_heads, ws, scale, hdp, vec,
                                     static_cast<cudaStream_t>(stream)));
}

// q, k, v, out: [B_, N, C] fp32 contiguous, window b's token i at row
// b * N + i; bias [heads, N, N]; mask [nW, N, N] taken by b % nW, or null
// (B_ % nW == 0, C / heads <= 256, N any size); hdp and vec as above.
extern "C" int ff_window_attention(const float* q, const float* k,
                                   const float* v, const float* bias,
                                   const float* mask, float* out, int B_,
                                   int N, int nW, int C, int num_heads,
                                   float scale, int hdp, int vec,
                                   void* stream) {
  return int(window_attention_dispatch<true>(
      q, k, v, C, bias, mask, out, B_, N, 0, 0, C, num_heads, 0, nW, scale,
      hdp, vec, static_cast<cudaStream_t>(stream)));
}
