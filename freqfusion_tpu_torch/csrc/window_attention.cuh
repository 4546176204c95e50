// Window multi-head self-attention straight from NHWC q/k/v, fp32: the
// body shared by window_attention.cu (q, k, v as three tensors) and
// window_attention_qkv.cu (q, k, v as the column thirds of one projected
// [B, H, W, 3C] tensor). Per (batch, ws x ws window, head):
//     out = softmax(q k^T * scale + bias[h] + mask[w]) v
// with window partition and reverse folded into the addressing. It
// replaces freqfusion_tpu/ops/pallas_attention.py:
// fused_window_attention_nhwc (:238); the template flag WM selects the
// window-major form instead (fused_window_attention, :95: q/k/v
// [B_, N, C] with the windows already partitioned, token i of window b at
// row b * N + i, its mask mask[b % nW], N any size).
//
// What bounds it on the H100: operations. DRCT-L's dense blocks have head
// dims 30, 53, 122, 46 and 77 (C = 180..308 over 6/4/2/6/4 heads), window
// 16 (N = 256): 4 N^2 hd FLOPs per (window, head), 429.8 GFLOP over the
// ten shapes of chip_smoke.py's phase 2, 6.42 ms on the fp32 CUDA cores.
// TF32 on the tensor cores (495 TFLOP/s) keeps 10 mantissa bits, too few
// for the fp32 tolerance (1e-4 at logits of +-30), so both products run
// in 3xTF32: x = hi + lo with hi = x rounded to TF32 (to nearest, ties
// away, as cvt.rna.tf32 does) and lo = x - hi; a product is lo*hi +
// hi*lo + hi*hi (lo*lo, ~2^-22 relative, dropped), accumulated in fp32.
// That is 2.61 ms of operations over the ten shapes; the bytes (q/k/v/out
// once) are 2.01 ms. PyTorch's TF32 switches do not touch this split.
//
// Design (CUDA C++, mma.sync m16n8k8 TF32, cp.async; the split, product
// and copy helpers are tf32_mma.cuh's). What holds it now is
// instruction issue around the tensor cores (the splits, the softmax, the
// copies' addressing), not the products; the choices below cut that:
//   - A warp owns 32 query rows (two m16 tiles), so each K or V fragment
//     is read from shared memory and split once for two products. A block
//     is 4 warps (128 queries; 8 warps, the whole window, at head box 128)
//     of one (window, head); the block index runs over q-tiles fastest, so
//     a window-head's q-tiles launch side by side and its K/V come from
//     device memory once, then from L2.
//   - Keys go 16 a tile through a two-stage cp.async ring (tile i + 1 in
//     flight while tile i is multiplied, one barrier a tile), with an
//     online (flash-style) softmax in registers, in exp2 of log2e-scaled
//     logits; the ragged last tile alone checks keys against N.
//   - Each warp's bias (and mask) rows of tile i + 1 are fetched by
//     cp.async into its own shared buffer while tile i's P V runs: read
//     straight from L2 in the softmax, their latency stalled every tile.
//   - hi is rounded by two integer operations (cvt costs more); lo goes to
//     the tensor core unrounded, which reads its top 10 mantissa bits (an
//     error <= 2^-21 |x|, the order of rounding it). The three products of
//     a step run over all its tiles pass by pass, so none waits on the one
//     just before it.
//   - O += P V takes P straight from S's accumulator registers: the f32
//     C fragment holds columns 2t, 2t + 1 of an 8-key step where the TF32
//     A fragment wants t, t + 4, so the product reads the step's keys in
//     that order (k t <-> key 2t, t + 4 <-> 2t + 1) and V's fragment from
//     the same rows: no shuffles, no trip through shared memory.
//   - Head offsets head * hd are not 16-byte aligned at hd 30, 46, 53, 77
//     and 122. Where rows are (ldi % 4 == 0, aligned bases: every DRCT
//     width and the 3C projection), a head's box is the HDP channels from
//     cb = ch0 - a (a = ch0 % 4), read as 16-byte cp.async; the box's
//     channels outside [a, a + hd) belong to the neighbouring head and are
//     zeroed in Q once (0 x finite = 0 in Q K^T) and never stored from O.
//     Other rows (e.g. C 42) take 4-byte cp.async of hd channels (a = 0).
//     Chunks past the box and rows past N are zero-filled by cp.async
//     (src-size 0). ops/attention.py:plan_window_attention picks HDP and
//     the route.
//   - Shared memory row stride HDP + 4 (= 4 mod 8) keeps every fragment
//     read free of bank conflicts; the bias rows' kKt + 8 does for theirs.
// Every shape the entries take runs this one body (HDP 16..256). No
// atomics: reruns are bit-equal, and the WM form is bit-equal to the NHWC
// form on the same windows.
//
// Tried on the H100 and not kept, each slower than this body over the ten
// shapes in the same run: both products as wgmma (m64nNk8 TF32, Q's hi/lo
// fragments in registers, K and V^T split once a tile into shared hi/lo
// planes in the K-major core-matrix layout, V^T's keys in P's order), with
// one, two or four warpgroups a block; there, too, the splits, the
// softmax and the barriers around each tile's two waits set the pace.
// Also no faster: 16-row warps, K and V split once into shared hi/lo
// planes (twice the shared-memory reads), a three-stage ring.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

// Launch shape by padded head width: warps a block, 16-row m-tiles a
// warp, keys a tile, blocks an SM the registers are held to. Shared
// memory: the Q tile (16 * kMt * kWarps rows) and the two-stage ring of K
// and V tiles, rows of HDP + 4 floats; then each warp's bias rows (and
// mask rows, with a mask) of one key tile, rows of kKt + 8 floats. At the
// DRCT widths ptxas reports no spill.
template <int HDP>
struct WaShape {
  static constexpr int kMt = HDP > 128 ? 1 : 2;
  static constexpr int kWarps = HDP == 128 ? 8 : 4;
  static constexpr int kKt = 16;
  static constexpr int kMinBlocks =
      HDP <= 32 ? 4 : HDP <= 64 ? 3 : HDP <= 96 ? 2 : 1;
  // O += P V takes the dim n-tiles two at a time up to HDP 80 (registers)
  static constexpr int kPvTiles = HDP <= 80 ? 2 : 1;
  static constexpr int kLd = HDP + 4;
  static constexpr int kQt = 16 * kMt * kWarps;
  static constexpr int kLdb = kKt + 8;
  static constexpr size_t smem_bytes(bool masked) {
    return (size_t(kQt + 2 * 2 * kKt) * kLd +
            size_t(masked ? 2 : 1) * kQt * kLdb) * sizeof(float);
  }
};

// q, k, v: pixel rows of `ldi` floats (C for separate tensors, 3 C for one
// packed projection); out: pixel rows of C floats. The window-major form
// reads only wm_n (N) and wm_nw (nW) of the geometry; the NHWC form reads
// H, W and ws and not those two. vec: the 16-byte route (see above).
template <int HDP, bool WM>
__global__ void __launch_bounds__(32 * WaShape<HDP>::kWarps,
                                  WaShape<HDP>::kMinBlocks)
window_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, int ldi,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask,
                        float* __restrict__ out, int H, int W, int C, int hd,
                        int ws, float scale, int wm_n, int wm_nw, int heads,
                        int qtiles, int vec) {
  using Shape = WaShape<HDP>;
  constexpr int kMt = Shape::kMt, kKt = Shape::kKt, kLd = Shape::kLd;
  constexpr int kThreads = 32 * Shape::kWarps, kQt = Shape::kQt;
  constexpr int kNt = kKt / 8, kDt = HDP / 8, kPlane = kKt * kLd;
  constexpr int kLdb = Shape::kLdb, kWr = 16 * kMt;  // rows a warp
  static_assert(HDP % 8 == 0, "head box: whole 8-dim mma steps");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kQt][kLd]
  float* ring = qs + kQt * kLd;  // stage st: K, V planes of [kKt][kLd]
  // this warp's [kWr][kLdb] bias rows, then its mask rows
  float* bsm =
      ring + 4 * kPlane + (mask ? 2 : 1) * (threadIdx.x / 32) * kWr * kLdb;

  const int n = WM ? wm_n : ws * ws;
  const int nww = WM ? 1 : W / ws;
  const int nw_img = WM ? wm_nw : (H / ws) * nww;
  int bid = blockIdx.x;
  const int qtile = bid % qtiles;
  bid /= qtiles;
  const int head = bid % heads;
  const int bw = bid / heads;  // batch * window
  const int b = WM ? bw : bw / nw_img;
  const int win = bw % nw_img;  // the mask's window
  const int wy = win / nww, wx = win % nww;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma group and thread in group

  // Row of window token i: its NHWC pixel, or b * N + i window-major.
  auto pixel = [&](int i) -> long long {
    if constexpr (WM) {
      return (long long)b * n + i;
    } else {
      const int y = wy * ws + i / ws, x = wx * ws + i % ws;
      return ((long long)b * H + y) * W + x;
    }
  };
  const int ch0 = head * hd;
  const int a = vec ? ch0 & 3 : 0;  // box column of the head's channel 0
  const int cb = ch0 - a;           // box's first channel
  const int nch = (a + hd + 3) / 4;  // 16-byte chunks that hold the head

  // Rows [t0, t0 + R) of `src` (and of `src2` into dst + kPlane, where
  // given) into dst ([R][kLd]), every box column written: data, or zeros
  // past the head (generic route), past the chunks (vec route) and past N.
  auto load_rows = [&](float* dst, const float* src, const float* src2,
                       int t0, int R) {
    if (vec) {
      for (int idx = tid; idx < R * (HDP / 4); idx += kThreads) {
        const int r = idx / (HDP / 4), c = idx % (HDP / 4);
        const bool ok = t0 + r < n && c < nch;
        const long long off = ok ? pixel(t0 + r) * ldi + cb + 4 * c : 0;
        cp_async16(dst + r * kLd + 4 * c, src + off, ok);
        if (src2) cp_async16(dst + kPlane + r * kLd + 4 * c, src2 + off, ok);
      }
    } else {
      for (int idx = tid; idx < R * HDP; idx += kThreads) {
        const int r = idx / HDP, d = idx % HDP;
        const bool ok = t0 + r < n && d < hd;
        const long long off = ok ? pixel(t0 + r) * ldi + cb + d : 0;
        cp_async4(dst + r * kLd + d, src + off, ok);
        if (src2) cp_async4(dst + kPlane + r * kLd + d, src2 + off, ok);
      }
    }
  };

  const int q0 = qtile * kQt;
  const int ntiles = (n + kKt - 1) / kKt;
  // cp.async groups, in commit order: Q; K/V of tile 0; the bias rows of
  // tile 0; then, per tile i, K/V of tile i + 1 and the bias rows of tile
  // i + 1 (empty past the last tile, and bias groups empty for a warp past
  // N), so every thread counts alike.
  load_rows(qs, q, nullptr, q0, kQt);
  cp_async_commit();
  load_rows(ring, k, v, 0, kKt);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's Q chunks have landed
  if (vec) {  // zero the neighbouring heads' channels in its Q chunks
    for (int idx = tid; idx < kQt * (HDP / 4); idx += kThreads) {
      const int r = idx / (HDP / 4), c = idx % (HDP / 4);
      if (c >= nch) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * c + e;
        if (col < a || col >= a + hd) qs[r * kLd + col] = 0.f;
      }
    }
  }

  // this warp's m-tile mt holds queries i0 + 16 mt ..; its thread the rows
  // g and g + 8 of each
  const int i0 = q0 + kWr * warp;
  const bool active = i0 < n;
  // The bias (and mask) rows of the warp's queries at keys [k0, k0 + kKt)
  // into its buffer, zeros past N: 16-byte copies where rows allow.
  const bool bvec = n % 4 == 0 && reinterpret_cast<size_t>(bias) % 16 == 0 &&
                    reinterpret_cast<size_t>(mask) % 16 == 0;
  const float* bbase = bias + (long long)head * n * n;
  const float* mbase = mask ? mask + (long long)win * n * n : nullptr;
  // A lane's 16-byte pieces sit at the same rows and columns in every
  // tile: piece p at row r0 + p * 32 * 4 / kKt, column c0.
  constexpr int kBp = kWr * kKt / 4 / 32;  // 16-byte pieces a lane
  static_assert(kBp * 4 * 32 == kWr * kKt, "whole pieces per lane");
  const int r0 = 4 * lane / kKt, c0 = 4 * lane % kKt;
  auto load_bias = [&](int k0) {
    if (bvec) {
#pragma unroll
      for (int p = 0; p < kBp; ++p) {
        const int r = r0 + p * 32 * 4 / kKt;
        const bool ok = k0 + c0 < n;  // n * n < 2^31 (checked at launch)
        const int off = ok ? min(i0 + r, n - 1) * n + k0 + c0 : 0;
        float* dst = bsm + r * kLdb + c0;
        cp_async16(dst, bbase + off, ok);
        if (mbase) cp_async16(dst + kWr * kLdb, mbase + off, ok);
      }
    } else {
      for (int idx = lane; idx < kWr * kKt; idx += 32) {
        const int r = idx / kKt, key = k0 + idx % kKt;
        const bool ok = key < n;
        const int off = ok ? min(i0 + r, n - 1) * n + key : 0;
        float* dst = bsm + r * kLdb + idx % kKt;
        cp_async4(dst, bbase + off, ok);
        if (mbase) cp_async4(dst + kWr * kLdb, mbase + off, ok);
      }
    }
  };
  if (active) load_bias(0);
  cp_async_commit();
  const float sl = scale * kLog2e;

  float o[kDt][kMt][4];
#pragma unroll
  for (int d = 0; d < kDt; ++d)
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][mt][e] = 0.f;
  float m[kMt][2], l[kMt][2];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = -INFINITY;
      l[mt][h] = 0.f;
    }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kKt;
    cp_async_wait<1>();  // this thread's K/V of tile it (bias rows follow)
    __syncthreads();     // ... and every thread's; tile it - 1 is consumed
    if (it + 1 < ntiles)
      load_rows(ring + (it + 1) % 2 * 2 * kPlane, k, v, k0 + kKt, kKt);
    cp_async_commit();
    if (!active) {
      cp_async_commit();  // its (empty) bias group
      continue;
    }
    const float* kt = ring + it % 2 * 2 * kPlane;
    const float* vt = kt + kPlane;

    // S = Q K^T over the box: A = Q (split here), B = K^T.
    float s[kNt][kMt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][mt][e] = 0.f;
    const float* qw = qs + (16 * kMt * warp + g) * kLd + t;
#pragma unroll
    for (int d8 = 0; d8 < kDt; ++d8) {
      uint32_t ah[kMt][4], al[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        const float* qr = qw + 16 * mt * kLd + 8 * d8;
        split_tf32(qr[0], ah[mt][0], al[mt][0]);
        split_tf32(qr[8 * kLd], ah[mt][1], al[mt][1]);
        split_tf32(qr[4], ah[mt][2], al[mt][2]);
        split_tf32(qr[8 * kLd + 4], ah[mt][3], al[mt][3]);
      }
      float kb[kNt][2];
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const float* kr = kt + (8 * j + g) * kLd + 8 * d8 + t;
        kb[j][0] = kr[0];
        kb[j][1] = kr[4];
      }
      mma_3xtf32(s, ah, al, kb);
    }

    // logits in log2 units: (s * scale + bias + mask) * log2(e); keys
    // past N (only in a ragged last tile) get -inf
    cp_async_wait<1>();  // the bias rows of tile it (one group follows)
    __syncwarp();
    auto logits = [&](auto full_tile) {
      constexpr bool full = decltype(full_tile)::value;
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          const int key = k0 + 8 * j + 2 * t;
          const bool in0 = full || key < n, in1 = full || key + 1 < n;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* br =
                bsm + (16 * mt + g + 8 * h) * kLdb + 8 * j + 2 * t;
            float2 add = *reinterpret_cast<const float2*>(br);
            if (mbase) {
              const float2 mm =
                  *reinterpret_cast<const float2*>(br + kWr * kLdb);
              add.x += mm.x;
              add.y += mm.y;
            }
            float& s0 = s[j][mt][2 * h];
            float& s1 = s[j][mt][2 * h + 1];
            s0 = in0 ? fmaf(s0, sl, add.x * kLog2e) : -INFINITY;
            s1 = in1 ? fmaf(s1, sl, add.y * kLog2e) : -INFINITY;
            mx[h] = fmaxf(mx[h], fmaxf(s0, s1));
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float mn = fmaxf(m[mt][h], mx[h]);  // finite: a key per tile
          const float corr = ex2(m[mt][h] - mn);    // 0 on the first tile
          m[mt][h] = mn;
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < kNt; ++j) {
            float* sj = s[j][mt];
            sj[2 * h] = ex2(sj[2 * h] - mn);
            sj[2 * h + 1] = ex2(sj[2 * h + 1] - mn);
            ps += sj[2 * h] + sj[2 * h + 1];
          }
          l[mt][h] = l[mt][h] * corr + ps;
#pragma unroll
          for (int d = 0; d < kDt; ++d) {
            o[d][mt][2 * h] *= corr;
            o[d][mt][2 * h + 1] *= corr;
          }
        }
      }
    };
    if (k0 + kKt <= n)
      logits(std::true_type{});
    else  // a ragged last tile
      logits(std::false_type{});

    __syncwarp();  // the warp's bias rows are read: fetch tile it + 1's
    if (it + 1 < ntiles) load_bias(k0 + kKt);
    cp_async_commit();

    // O += P V, keys in the permuted order: A from S's registers, B = V
    // rows 2t and 2t + 1 of each 8-key step.
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      uint32_t ah[kMt][4], al[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        split_tf32(s[j][mt][0], ah[mt][0], al[mt][0]);
        split_tf32(s[j][mt][2], ah[mt][1], al[mt][1]);
        split_tf32(s[j][mt][1], ah[mt][2], al[mt][2]);
        split_tf32(s[j][mt][3], ah[mt][3], al[mt][3]);
      }
      const float* vr = vt + (8 * j + 2 * t) * kLd + g;
      constexpr int kPv = Shape::kPvTiles, kWhole = kDt / kPv * kPv;
#pragma unroll
      for (int d = 0; d < kWhole; d += kPv) {
        float vb[kPv][2];
#pragma unroll
        for (int p = 0; p < kPv; ++p) {
          vb[p][0] = vr[8 * (d + p)];
          vb[p][1] = vr[kLd + 8 * (d + p)];
        }
        mma_3xtf32(*reinterpret_cast<float(*)[kPv][kMt][4]>(&o[d]), ah, al,
                   vb);
      }
      if constexpr (kWhole < kDt) {  // an odd last dim n-tile
        const float vb[1][2] = {{vr[8 * kWhole], vr[kLd + 8 * kWhole]}};
        mma_3xtf32(*reinterpret_cast<float(*)[1][kMt][4]>(&o[kWhole]), ah,
                   al, vb);
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[mt][h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int i = i0 + 16 * mt + g + 8 * h;
      if (i >= n) continue;
      const float inv = 1.f / lt;
      float* orow = out + pixel(i) * C + cb;
#pragma unroll
      for (int d = 0; d < kDt; ++d) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * d + 2 * t + e;
          if (col >= a && col < a + hd) orow[col] = o[d][mt][2 * h + e] * inv;
        }
      }
    }
}

// One launch over `windows` windows of n tokens: the NHWC form's geometry
// is (B, H, W, ws), the window-major form's (n, nw).
template <int HDP, bool WM>
cudaError_t window_attention_launch_hdp(
    const float* q, const float* k, const float* v, int ldi,
    const float* bias, const float* mask, float* out, int windows, int n,
    int H, int W, int C, int num_heads, int ws, int nw, float scale,
    int vec, cudaStream_t stream) {
  using S = WaShape<HDP>;
  const size_t smem = S::smem_bytes(mask != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<HDP, WM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  if ((long long)n * n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int qtiles = (n + S::kQt - 1) / S::kQt;
  const long long blocks = (long long)windows * num_heads * qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  window_attention_kernel<HDP, WM>
      <<<unsigned(blocks), 32 * S::kWarps, smem, stream>>>(
          q, k, v, ldi, bias, mask, out, H, W, C, C / num_heads, ws, scale,
          n, nw, num_heads, qtiles, vec);
  return cudaGetLastError();
}

// hdp and vec as ops/attention.py:plan_window_attention picks them; a plan
// the kernel cannot take (a head outside its box, an unaligned 16-byte
// route, a width it has no instantiation of) is refused.
template <bool WM>
cudaError_t window_attention_dispatch(
    const float* q, const float* k, const float* v, int ldi,
    const float* bias, const float* mask, float* out, int windows, int n,
    int H, int W, int C, int num_heads, int ws, int nw, float scale,
    int hdp, int vec, cudaStream_t s) {
  const int hd = C / num_heads;
  if (vec) {
    const size_t bases = reinterpret_cast<size_t>(q) |
                         reinterpret_cast<size_t>(k) |
                         reinterpret_cast<size_t>(v);
    if (ldi % 4 || bases % 16) return cudaErrorInvalidValue;
    for (int h = 0; h < num_heads; ++h)
      if ((h * hd) % 4 + hd > hdp) return cudaErrorInvalidValue;
  } else if (hd > hdp) {
    return cudaErrorInvalidValue;
  }
#define FF_WINDOW_LAUNCH(P)                                                  \
  if (hdp == P)                                                              \
    return window_attention_launch_hdp<P, WM>(q, k, v, ldi, bias, mask, out, \
                                              windows, n, H, W, C, num_heads, \
                                              ws, nw, scale, vec, s);
  FF_WINDOW_LAUNCH(16)
  FF_WINDOW_LAUNCH(32)
  FF_WINDOW_LAUNCH(48)
  FF_WINDOW_LAUNCH(56)
  FF_WINDOW_LAUNCH(64)
  FF_WINDOW_LAUNCH(80)
  FF_WINDOW_LAUNCH(96)
  FF_WINDOW_LAUNCH(128)
  FF_WINDOW_LAUNCH(256)
#undef FF_WINDOW_LAUNCH
  return cudaErrorInvalidValue;
}

// q, k, v: [B, H, W] pixels of `ldi` floats, each head's hd channels at
// head * hd; out [B, H, W, C]; bias [heads, N, N]; mask [nW, N, N] or
// null (N = ws * ws, H % ws == 0 == W % ws, hd <= 256).
cudaError_t window_attention_launch(const float* q, const float* k,
                                    const float* v, int ldi,
                                    const float* bias, const float* mask,
                                    float* out, int B, int H, int W, int C,
                                    int num_heads, int ws, float scale,
                                    int hdp, int vec, cudaStream_t s) {
  return window_attention_dispatch<false>(
      q, k, v, ldi, bias, mask, out, B * (H / ws) * (W / ws), ws * ws, H, W,
      C, num_heads, ws, 0, scale, hdp, vec, s);
}

}  // namespace
