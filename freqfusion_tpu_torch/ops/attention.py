"""Window attention kernels for DRCT and GRL, with their plain versions.

Counterpart of ``freqfusion_tpu/ops/pallas_attention.py``. Each public
function takes the Pallas wrapper's layout (NHWC, or window-major
[B_, N, C] for ``window_attention``) and argument order. A CPU
tensor goes to the plain PyTorch version (``*_reference``); a CUDA tensor
goes to the hand-written kernel in ``csrc/`` or the call raises.

The ``*_qkv_nhwc`` entries take x and the packed projection weights in
the JAX layout ([in, out]) and project inside their kernels
(FREQFUSION_ATTN_QKV and FREQFUSION_GRL_QKV); their plain versions are
``F.linear`` projections around the plain attention. DRCT's and GRL's run
their projections on ``csrc/tf32_gemm.cuh``'s 3xTF32 GEMM through a
scratch that :func:`plan_qkv_projections` and
:func:`plan_grl_qkv_projections` size. GRL's mixed attention
(``csrc/grl_attention.cuh``, both entries) takes 8x8 tiles with 4x4
anchors in blocks that :func:`plan_grl_attention` describes.

``window_attention_nhwc``, ``grl_mixed_attention_nhwc`` and the two
``*_qkv_nhwc`` entries also take bf16 operands (the bf16 expert mode):
their bf16 kernels (``csrc/window_attention.cu``, one pass over the keys
on wgmma, :func:`plan_window_attention_bf16`; ``csrc/grl_attention.cu``,
``csrc/window_attention_qkv.cu``, ``csrc/grl_attention_qkv.cu``, counted
as ``<name>.bf16``; DRCT's two bf16 projections and GRL's one on
``csrc/bf16_wgmma.cuh``'s wgmma, their weights laid out once by
``ops/wgmma.py``) and their plain versions round where the JAX kernels'
bf16 runs round: products of bf16 values accumulated in fp32, the
projections' bias added in fp32 and rounded once, the mask rounded to
bf16 (the JAX wrappers cast it to the operands' dtype), the softmax in
fp32 and rounded to bf16 before its product, bf16 outputs.
``window_attention`` takes fp32 only and refuses bf16
(:func:`cuda.fp32_only`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda, wgmma
from .tf32_gemm import (MAX_CHANNELS, ROWS, SMEM_LIMIT, GemmPlan, _round_up,
                        plan_gemm)
from .window_attention import (multi_head_window_attention, table_as,
                               window_partition, window_reverse)

__all__ = ["plan_window_attention", "plan_qkv_projections", "QkvPlan",
           "plan_window_attention_bf16", "WindowBf16Plan",
           "plan_grl_attention", "GrlPlan", "plan_grl_attention_bf16",
           "GrlBf16Plan", "grl_mask_layout", "plan_grl_qkv_projections",
           "GrlQkvPlan",
           "window_attention",
           "window_attention_reference",
           "window_attention_nhwc", "window_attention_nhwc_reference",
           "grl_mixed_attention_nhwc", "grl_mixed_attention_nhwc_reference",
           "window_attention_qkv_nhwc",
           "window_attention_qkv_nhwc_reference",
           "grl_mixed_attention_qkv_nhwc",
           "grl_mixed_attention_qkv_nhwc_reference"]


# padded head widths csrc/window_attention.cuh is instantiated for
HEAD_BOXES = (16, 32, 48, 56, 64, 80, 96, 128, 256)


def plan_window_attention(hd: int, heads: int, ldi: int,
                          aligned: bool) -> Tuple[int, bool]:
    """(hdp, vec): how csrc/window_attention.cuh reads a head of `hd`
    channels at head * hd from rows of `ldi` floats. vec (rows a multiple
    of 16 bytes, `aligned` bases): 16-byte copies of a box of hdp channels
    from the head's first channel rounded down to a multiple of 4, so
    hdp covers hd + (head * hd) % 4 for every head; otherwise 4-byte
    copies of the hd channels. hdp is the smallest instantiated width that
    fits."""
    if hd > HEAD_BOXES[-1]:
        raise ValueError(f"window attention: head dim {hd} > "
                         f"{HEAD_BOXES[-1]}")
    vec = aligned and ldi % 4 == 0
    need = hd + max((h * hd) % 4 for h in range(heads)) if vec else hd
    if need > HEAD_BOXES[-1]:
        vec, need = False, hd
    return next(p for p in HEAD_BOXES if p >= need), vec


def _plan(hd: int, heads: int, ldi: int, *tensors) -> Tuple[int, int]:
    hdp, vec = plan_window_attention(
        hd, heads, ldi, all(t.data_ptr() % 16 == 0 for t in tensors))
    return hdp, int(vec)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even) and back to fp32."""
    return x.to(torch.bfloat16).float()


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B_, N, C] -> fp32 [B_, nH, N, hd]."""
    b_, n, c = x.shape
    return x.float().reshape(b_, n, num_heads, c // num_heads).transpose(1, 2)


def _masked(attn: torch.Tensor, mask: Optional[torch.Tensor]
            ) -> torch.Tensor:
    """attn [B_, nH, N, M] plus mask [nW, N, M] (tiled over the batch) in
    bf16 and back, as the JAX wrappers cast it to the operands' dtype."""
    if mask is None:
        return attn
    b_, nh, n, m = attn.shape
    nw = mask.shape[0]
    return (attn.view(b_ // nw, nw, nh, n, m)
            + _bf16(mask)[None, :, None]).view(b_, nh, n, m)


def _window_attention_bf16(q, k, v, num_heads: int, bias, mask,
                           scale: float) -> torch.Tensor:
    """bf16 window attention over [B_, N, C] windows with the JAX kernel's
    rounding points (pallas_attention.py:_attn_heads): q times scale in
    bf16; logits, bias and mask in fp32; the softmax in fp32, rounded to
    bf16; P V accumulated in fp32, rounded to bf16."""
    b_, n, c = q.shape
    qh = _bf16(_heads(q, num_heads) * _bf16(torch.tensor(scale)))
    attn = qh @ _heads(k, num_heads).transpose(-2, -1) + bias.float()[None]
    p = _bf16(torch.softmax(_masked(attn, mask), -1))
    out = p @ _heads(v, num_heads)
    return out.transpose(1, 2).reshape(b_, n, c).to(torch.bfloat16)


def window_attention_nhwc_reference(q, k, v, bias, mask, num_heads: int,
                                    window_size: int,
                                    scale: Optional[float] = None):
    """Plain PyTorch window attention: partition, attention, reverse (in
    bf16 for bf16 operands, see :func:`_window_attention_bf16`)."""
    _, h, w, c = q.shape
    scale = float((c // num_heads) ** -0.5) if scale is None else scale
    qw, kw, vw = (window_partition(t, window_size) for t in (q, k, v))
    attend = (_window_attention_bf16 if q.dtype == torch.bfloat16
              else multi_head_window_attention)
    out = attend(qw, kw, vw, num_heads, bias, mask, scale)
    return window_reverse(out, window_size, h, w)


class WindowBf16Plan(NamedTuple):
    """How ``csrc/window_attention.cu``'s bf16 kernel runs a call (its
    ``wa_bf16_plan``): one block a (window, head), 64-query tiles a
    warpgroup, the logits of a tile over all keys in its accumulators."""
    hdp: int             # head box: hd rounded up to 16 (wgmma's k16, P V's N)
    nk: int              # keys padded to one or two 128-key halves
    nq: int              # queries padded to whole 64-row tiles
    warpgroups: int      # a block's (two where hdp > 64)
    smem: int            # bytes of shared memory a block
    blocks_per_sm: int   # by shared memory and registers
    regs: int            # the registers a thread may take at that many


# an SM's shared memory (1 KB of it reserved a block) and registers
SM_SMEM, SM_REGS = 233472, 65536


def plan_window_attention_bf16(n: int, hd: int) -> WindowBf16Plan:
    """The bf16 kernel's plan for N = `n` tokens a window and head dim
    `hd`: q, k and v staged whole ([nq + 2 nk][hdp] bf16), an output tile
    of 64 x (hdp + 8) a warpgroup and the rows' pixel offsets (4 n); at
    most three blocks an SM up to head box 32, two up to 64 and one above
    (``__launch_bounds__``), fewer where shared memory holds fewer."""
    if n % 16 or not 16 <= n <= 256 or not 1 <= hd <= 128:
        raise ValueError(f"window_attention_nhwc (bf16): N={n} must be a "
                         f"multiple of 16 up to 256 and the head dim {hd} "
                         "at most 128")
    hdp = _round_up(hd, 16)
    nk, nq = (128 if n <= 128 else 256), _round_up(n, 64)
    wg = 2 if hdp > 64 else 1
    smem = 2 * hdp * (nq + 2 * nk) + wg * 64 * (hdp + 8) * 2 + 4 * n
    per_sm = min(1 if wg == 2 else 3 if hdp <= 32 else 2,
                 SM_SMEM // (smem + 1024))
    regs = min(255, SM_REGS // (128 * wg * per_sm) // 8 * 8)
    return WindowBf16Plan(hdp, nk, nq, wg, smem, per_sm, regs)


def _window_attention_nhwc_bf16(q, k, v, bias, mask, num_heads: int,
                                ws: int, scale: float) -> torch.Tensor:
    """The bf16 kernel: q, k, v bf16; bias bf16 (the module's bf16
    table); the mask cast to bf16 as the JAX wrapper casts it (once for a
    device table, :func:`table_as`). N = ws * ws a multiple of 16 up to
    256, head dims up to 128."""
    b, h, w, c = q.shape
    n, hd, dev = ws * ws, c // num_heads, q.device
    plan_window_attention_bf16(n, hd)
    mask = table_as(mask, torch.bfloat16)
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda.require(t, name, (b, h, w, c), dev, torch.bfloat16)
    cuda.require(bias, "bias", (num_heads, n, n), dev, torch.bfloat16)
    if mask is not None:
        cuda.require(mask, "mask", ((h // ws) * (w // ws), n, n), dev,
                     torch.bfloat16)
    if bias.data_ptr() % 16 or (mask is not None and mask.data_ptr() % 16):
        raise ValueError("window_attention_nhwc (bf16): bias and mask must "
                         "be 16-byte aligned")
    out = torch.empty_like(q)
    err = cuda.library().ff_window_attention_nhwc_bf16(
        cuda.ptr(q), cuda.ptr(k), cuda.ptr(v), cuda.ptr(bias),
        cuda.ptr(mask), cuda.ptr(out), b, h, w, c, num_heads, ws, scale,
        cuda.stream(q))
    cuda.check(err, "window_attention_nhwc (bf16)")
    cuda.launch_counts["window_attention_nhwc.bf16"] += 1
    return out


def window_attention_nhwc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, mask: Optional[torch.Tensor],
                          num_heads: int, window_size: int,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v [B, H, W, C] (H % ws == 0 == W % ws); bias [nH, N, N]; mask
    [nW, N, N] (row-major windows) or None. Returns [B, H, W, C]:
    softmax(q k^T * scale + bias + mask) v per window and head, scale
    defaulting to head_dim ** -0.5. fp32 operands throughout, or q, k, v
    and bias in bf16 with the mask in fp32 or bf16 (the bf16 kernel, bf16
    out; the mask rounded to bf16 as the JAX wrapper casts it)."""
    b, h, w, c = q.shape
    ws = window_size
    hd = c // num_heads
    scale = float(hd ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return window_attention_nhwc_reference(q, k, v, bias, mask,
                                               num_heads, ws, scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_nhwc: unsupported device {q.device}")
    if h % ws or w % ws or c % num_heads:
        raise ValueError(f"window_attention_nhwc: H={h}, W={w} must be "
                         f"multiples of ws={ws} and C={c} of heads={num_heads}")
    if q.dtype == torch.bfloat16:
        return _window_attention_nhwc_bf16(q, k, v, bias, mask, num_heads,
                                           ws, scale)
    n = ws * ws
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda.require(t, name, (b, h, w, c), q.device)
    cuda.require(bias, "bias", (num_heads, n, n), q.device)
    if mask is not None:
        cuda.require(mask, "mask", ((h // ws) * (w // ws), n, n), q.device)
    out = torch.empty_like(q)
    err = cuda.library().ff_window_attention_nhwc(
        cuda.ptr(q), cuda.ptr(k), cuda.ptr(v), cuda.ptr(bias),
        cuda.ptr(mask), cuda.ptr(out), b, h, w, c, num_heads, ws, scale,
        *_plan(hd, num_heads, c, q, k, v), cuda.stream(q))
    cuda.check(err, "window_attention_nhwc")
    cuda.launch_counts["window_attention_nhwc"] += 1
    return out


def window_attention_reference(q, k, v, bias, mask, num_heads: int,
                               scale: Optional[float] = None):
    """Plain PyTorch window-major window attention."""
    scale = (float((q.shape[-1] // num_heads) ** -0.5) if scale is None
             else scale)
    return multi_head_window_attention(q, k, v, num_heads, bias, mask, scale)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, mask: Optional[torch.Tensor],
                     num_heads: int,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v [B_, N, C], the nW windows of each image in a row (B_ = B
    nW); bias [nH, N, N]; mask [nW, N, N], taken by window index mod nW,
    or None. Returns [B_, N, C]: softmax(q k^T * scale + bias + mask) v
    per window and head, scale defaulting to head_dim ** -0.5. N is any
    size; the head dim is at most 256."""
    b_, n, c = q.shape
    hd = c // num_heads
    nw = 1 if mask is None else mask.shape[0]
    if c % num_heads or hd > 256 or b_ % nw:
        raise ValueError(f"window_attention: C={c} must be a multiple of "
                         f"heads={num_heads} with a head dim <= 256, and "
                         f"B_={b_} a multiple of nW={nw}")
    scale = float(hd ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, bias, mask, num_heads,
                                          scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q.device}")
    cuda.fp32_only("window_attention", q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda.require(t, name, (b_, n, c), q.device)
    cuda.require(bias, "bias", (num_heads, n, n), q.device)
    if mask is not None:
        cuda.require(mask, "mask", (nw, n, n), q.device)
    out = torch.empty_like(q)
    err = cuda.library().ff_window_attention(
        cuda.ptr(q), cuda.ptr(k), cuda.ptr(v), cuda.ptr(bias),
        cuda.ptr(mask), cuda.ptr(out), b_, n, nw, c, num_heads, scale,
        *_plan(hd, num_heads, c, q, k, v), cuda.stream(q))
    cuda.check(err, "window_attention")
    cuda.launch_counts["window_attention"] += 1
    return out


def _cosine_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B_, N, C] -> per-head L2-normalised [B_, nH, N, hd]
    (F.normalize, eps 1e-12)."""
    b_, n, c = x.shape
    xh = x.reshape(b_, n, num_heads, c // num_heads).transpose(1, 2)
    return F.normalize(xh, dim=-1, eps=1e-12)


def _cosine_heads_bf16(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """bf16 [B_, N, C] -> fp32 [B_, nH, N, hd] of bf16 values: x times
    1 / max(||x||, 1e-12) in fp32, rounded to bf16 (the JAX kernel's
    _cosnorm)."""
    xh = _heads(x, num_heads)
    return _bf16(xh * (1.0 / xh.norm(dim=-1, keepdim=True).clamp_min(1e-12)))


def _merge(x: torch.Tensor) -> torch.Tensor:
    b_, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b_, n, h * d)


# head boxes csrc/grl_attention.cuh is instantiated for
GRL_HEAD_BOXES = (16, 32, 48, 64, 96)
GRL_WINDOW, GRL_DOWN = 8, 2  # the tile side and anchor down factor it takes
GRL_WARPS = 6


class GrlPlan(NamedTuple):
    """How ``csrc/grl_attention.cuh`` runs a call: one block of GRL_WARPS
    warps a (tile, half), each warp a unit of `rows` query rows of one
    head; the head box `hdp` of the wider half's head."""
    hdp: int         # head box: a multiple of 16 holding the head dim
    rows: int        # query rows a warp unit (two m-tiles, one past box 64)
    units_w: int     # warp units of the window half
    units_s: int     # of the stripe half
    smem: int        # bytes of dynamic shared memory a block
    blocks: int      # B * tiles * 2


def plan_grl_attention(b: int, h: int, w: int, c2: int, heads_w: int,
                       heads_s: int) -> GrlPlan:
    """The blocks of a GRL mixed attention call over [b, h, w, c2] halves
    (8x8 tiles, 4x4 anchors). A block's shared memory holds a half's q, k
    and v tiles (192 c2 floats), the anchor tile (16 c2) and hdp zeros the
    last rows' boxes read."""
    hd = max(c2 // heads_w, c2 // heads_s)
    if hd > GRL_HEAD_BOXES[-1]:
        raise ValueError(f"grl mixed attention: head dim {hd} > "
                         f"{GRL_HEAD_BOXES[-1]}")
    hdp = next(p for p in GRL_HEAD_BOXES if p >= hd)
    rows = 32 if hdp <= 64 else 16
    smem = 4 * (208 * c2 + hdp)
    if smem > SMEM_LIMIT - 16:
        raise ValueError(f"grl mixed attention: C/2={c2} needs {smem} bytes "
                         f"of shared memory a block (> {SMEM_LIMIT - 16})")
    n = GRL_WINDOW * GRL_WINDOW
    return GrlPlan(hdp, rows, heads_w * n // rows, heads_s * n // rows, smem,
                   2 * b * (h // GRL_WINDOW) * (w // GRL_WINDOW))


# csrc/grl_attention.cu's bf16 kernel: the ring's deepest, its barriers'
# bytes, x1's transposed rows, the pad past a stage's rows
GRL_BF16_STAGES, GRL_BF16_HEAD, GRL_BF16_X1_LD, GRL_BF16_PAD = 4, 128, 24, 256


class GrlBf16Plan(NamedTuple):
    """How ``csrc/grl_attention.cu`` runs a bf16 call (its ``gb_plan``):
    persistent blocks, one an SM, the first half of them walking the
    window half's tiles and the rest the stripe half's; warp 0 bulk-copies
    each tile's rows into a ring of `stages`; warp w keeps the terms of
    unit w in registers (and stage 1's of head w)."""
    hdp: int             # head box of the wider head: 16, 32, 48, 64 or 96
    warps: int           # warps a block (12; 8 past head box 32)
    stages: int          # the ring's depth (2 to 4)
    stage_bytes: int     # q, k, v, then the mask tile or the anchor rows
    smem: int            # bytes of dynamic shared memory a block
    blocks: Tuple[int, int]  # the window half's blocks, the stripe half's
    kept_w: Tuple[Tuple[int, int], ...]   # (head, row unit) of warp w
    kept_s1: Tuple[Optional[int], ...]    # stage 1: warp w's head, or None
    kept_s2: Tuple[Tuple[int, int], ...]  # stage 2: (head, row unit)


def plan_grl_attention_bf16(b: int, h: int, w: int, c2: int, heads_w: int,
                            heads_s: int, masked: bool,
                            sms: int = 132) -> GrlBf16Plan:
    """The bf16 kernel's plan for [b, h, w, c2] halves on a card of `sms`
    SMs: a stage holds q, k and v (64 c2 bf16 each) and the window half's
    bf16 mask tile (8 KB, where `masked`) or the stripe half's 4 anchor
    rows (4 c2 bf16 padded to 8), then a pad of GRL_BF16_PAD bytes; a
    block also holds two output tiles (64 c2 bf16) and x1 transposed
    (heads_s hdp rows of 24 bf16). The deepest ring of 2 to 4 stages that
    fits 227 KB; refused past head box 96 or where two stages do not
    fit."""
    hd = max(c2 // heads_w, c2 // heads_s)
    if hd > GRL_HEAD_BOXES[-1]:
        raise ValueError(f"grl mixed attention (bf16): head dim {hd} > "
                         f"{GRL_HEAD_BOXES[-1]}")
    hdp = next(p for p in GRL_HEAD_BOXES if p >= hd)
    warps = 12 if hdp <= 32 else 8
    n = GRL_WINDOW * GRL_WINDOW
    extra = max(2 * n * n if masked else 0, 8 * _round_up(4 * c2, 8))
    stage = _round_up(6 * n * c2 + extra + GRL_BF16_PAD, 128)
    rest = 2 * _round_up(2 * n * c2, 128) + 2 * heads_s * hdp * GRL_BF16_X1_LD
    fits = [s for s in range(GRL_BF16_STAGES, 1, -1)
            if GRL_BF16_HEAD + s * stage + rest <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"grl mixed attention (bf16): C/2={c2} needs "
                         f"{GRL_BF16_HEAD + 2 * stage + rest} bytes of shared "
                         f"memory a block (> {SMEM_LIMIT})")
    tiles = b * (h // GRL_WINDOW) * (w // GRL_WINDOW)
    blocks = (min(tiles, max(1, sms // 2)), min(tiles, max(1, sms - sms // 2)))

    def units(heads):
        return tuple((u // 4, u % 4) for u in range(min(warps, 4 * heads)))
    kept_s1 = tuple(w if w < heads_s else None for w in range(warps))
    return GrlBf16Plan(hdp, warps, fits[0], stage,
                       GRL_BF16_HEAD + fits[0] * stage + rest, blocks,
                       units(heads_w), kept_s1, units(heads_s))


def grl_mask_layout(mask: torch.Tensor) -> torch.Tensor:
    """A [nW, 64, 64] mask in the order ``csrc/grl_attention.cu``'s bf16
    kernel reads it: for each tile, 16-row unit r, pair q of 8-key n-tiles
    and half hh (row g or g + 8 of the unit), the 32 lanes (g, t) in turn,
    each with two words, n-tile 2q + i's keys 8 (2q + i) + 2t and + 1:
    element [w, r, q, hh, g, t, i, e] is mask[w, 16 r + 8 hh + g, 16 q + 8
    i + 2 t + e]. A warp's read of a word pair a lane is then one
    conflict-free 8-byte load."""
    nw = mask.shape[0]
    return mask.reshape(nw, 4, 2, 8, 4, 2, 4, 2).permute(
        0, 1, 4, 2, 3, 6, 5, 7).contiguous()


def _check_grl(name: str, h: int, w: int, c2: int, heads_w: int,
               heads_s: int, ws: int, df: int) -> None:
    if (ws != GRL_WINDOW or df != GRL_DOWN or h % ws or w % ws
            or c2 % heads_w or c2 % heads_s):
        raise ValueError(f"{name}: bad geometry H={h} W={w} ws={ws} df={df} "
                         f"C/2={c2} heads {heads_w}/{heads_s} (the kernel "
                         f"takes ws {GRL_WINDOW}, df {GRL_DOWN})")


def _check_aligned(name: str, *tensors, align: int = 16) -> None:
    """The bulk copies of csrc/grl_attention.cuh and grl_attention.cu read
    tile rows from 16-byte aligned bases (the bf16 kernel's biases, read
    in pairs of floats: 8)."""
    if any(t is not None and t.data_ptr() % align for t in tensors):
        raise ValueError(f"{name}: operands must be {align}-byte aligned")


def _check_terms(scale_w, scale_s1, scale_s2, bias_w, bias_s1, bias_s2, mask,
                 heads_w: int, heads_s: int, h: int, w: int, ws: int, n: int,
                 na: int, dev) -> None:
    """The bf16 kernels' scales and biases (fp32) and mask (any dtype: the
    wrappers cast it)."""
    cuda.require(scale_w, "scale_w", (heads_w, 1, 1), dev)
    cuda.require(scale_s1, "scale_s1", (heads_s, 1, 1), dev)
    cuda.require(scale_s2, "scale_s2", (heads_s, 1, 1), dev)
    cuda.require(bias_w, "bias_w", (heads_w, n, n), dev)
    cuda.require(bias_s1, "bias_s1", (heads_s, na, n), dev)
    cuda.require(bias_s2, "bias_s2", (heads_s, n, na), dev)
    if mask is not None:
        cuda.require(mask, "mask", ((h // ws) * (w // ws), n, n), dev,
                     mask.dtype)


def grl_mixed_attention_nhwc_reference(qw, kw, vw, qs, ks, vs, anchor,
                                       scale_w, scale_s1, scale_s2, bias_w,
                                       bias_s1, bias_s2, mask,
                                       num_heads_w: int, num_heads_s: int,
                                       window_size: int,
                                       down_factor: int = 2):
    """Plain PyTorch GRL mixed attention (window half and anchored stripe
    half of each ws x ws tile); in bf16 for bf16 operands (see
    :func:`_grl_mixed_attention_bf16`)."""
    _, h, w, _ = qw.shape
    ws = window_size
    aws = ws // down_factor
    if qw.dtype == torch.bfloat16:
        return _grl_mixed_attention_bf16(
            qw, kw, vw, qs, ks, vs, anchor, scale_w, scale_s1, scale_s2,
            bias_w, bias_s1, bias_s2, mask, num_heads_w, num_heads_s, ws, aws)
    qh, kh = (_cosine_heads(window_partition(t, ws), num_heads_w)
              for t in (qw, kw))
    vh = window_partition(vw, ws)
    b_, n, c = vh.shape
    vh = vh.reshape(b_, n, num_heads_w, c // num_heads_w).transpose(1, 2)
    attn = (qh @ kh.transpose(-2, -1)) * scale_w.reshape(1, -1, 1, 1)
    attn = attn + bias_w[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(b_ // nw, nw, num_heads_w, n, n)
                + mask[None, :, None]).view(b_, num_heads_w, n, n)
    x_window = window_reverse(_merge(torch.softmax(attn, -1) @ vh), ws, h, w)

    qh, kh = (_cosine_heads(window_partition(t, ws), num_heads_s)
              for t in (qs, ks))
    ah = _cosine_heads(window_partition(anchor, aws), num_heads_s)
    vh = window_partition(vs, ws)
    vh = vh.reshape(b_, n, num_heads_s, c // num_heads_s).transpose(1, 2)
    a1 = (ah @ kh.transpose(-2, -1)) * scale_s1.reshape(1, -1, 1, 1)
    x1 = torch.softmax(a1 + bias_s1[None], -1) @ vh
    a2 = (qh @ ah.transpose(-2, -1)) * scale_s2.reshape(1, -1, 1, 1)
    x_stripe = torch.softmax(a2 + bias_s2[None], -1) @ x1
    return x_window, window_reverse(_merge(x_stripe), ws, h, w)


def _grl_mixed_attention_bf16(qw, kw, vw, qs, ks, vs, anchor, scale_w,
                              scale_s1, scale_s2, bias_w, bias_s1, bias_s2,
                              mask, num_heads_w: int, num_heads_s: int,
                              ws: int, aws: int):
    """bf16 GRL mixed attention with the JAX kernel's rounding points
    (pallas_attention.py:_grl_mixed_core): q, k and the anchors normalised
    and rounded to bf16; logits times the scale plus the bias (and the
    mask) in fp32; each softmax rounded to bf16 before its product; the
    anchor stage's x1 and both outputs rounded to bf16."""
    _, h, w, _ = qw.shape

    def part(t, size=ws):
        return window_partition(t, size)

    def attend(q, k, scale, bias, msk=None):
        attn = (q @ k.transpose(-2, -1)) * scale.float().reshape(1, -1, 1, 1)
        return _bf16(torch.softmax(_masked(attn + bias.float()[None], msk),
                                   -1))

    def out(x):
        return window_reverse(_merge(x).to(torch.bfloat16), ws, h, w)

    qh, kh = (_cosine_heads_bf16(part(t), num_heads_w) for t in (qw, kw))
    x_window = attend(qh, kh, scale_w, bias_w, mask) @ _heads(
        part(vw), num_heads_w)
    qh, kh = (_cosine_heads_bf16(part(t), num_heads_s) for t in (qs, ks))
    ah = _cosine_heads_bf16(part(anchor, aws), num_heads_s)
    x1 = _bf16(attend(ah, kh, scale_s1, bias_s1)
               @ _heads(part(vs), num_heads_s))
    x_stripe = attend(qh, ah, scale_s2, bias_s2) @ x1
    return out(x_window), out(x_stripe)


def _grl_mixed_attention_nhwc_bf16(args, b: int, h: int, w: int, c2: int,
                                   num_heads_w: int, num_heads_s: int,
                                   ws: int, df: int):
    """The bf16 kernel: halves and anchor bf16; scales and biases fp32 (GRL
    computes its logit scales and position biases in fp32); the mask cast
    to bf16 as the JAX wrapper casts it and laid out in the kernel's
    fragment order (:func:`grl_mask_layout`), once for a device table
    (:func:`table_as`)."""
    (qw, kw, vw, qs, ks, vs, anchor, scale_w, scale_s1, scale_s2, bias_w,
     bias_s1, bias_s2, mask) = args
    n, na, dev = ws * ws, (ws // df) ** 2, qw.device
    for name, t in (("qw", qw), ("kw", kw), ("vw", vw), ("qs", qs),
                    ("ks", ks), ("vs", vs)):
        cuda.require(t, name, (b, h, w, c2), dev, torch.bfloat16)
    cuda.require(anchor, "anchor", (b, h // df, w // df, c2), dev,
                 torch.bfloat16)
    _check_terms(scale_w, scale_s1, scale_s2, bias_w, bias_s1, bias_s2, mask,
                 num_heads_w, num_heads_s, h, w, ws, n, na, dev)
    mask = table_as(mask, torch.bfloat16, grl_mask_layout)
    _check_aligned("grl_mixed_attention_nhwc (bf16)", qw, kw, vw, qs, ks, vs,
                   anchor, mask)
    _check_aligned("grl_mixed_attention_nhwc (bf16)", bias_w, bias_s1,
                   bias_s2, align=8)
    out_w = torch.empty_like(qw)
    out_s = torch.empty_like(qs)
    err = cuda.library().ff_grl_mixed_attention_nhwc_bf16(
        *(cuda.ptr(t) for t in (qw, kw, vw, qs, ks, vs, anchor, scale_w,
                                scale_s1, scale_s2, bias_w, bias_s1,
                                bias_s2, mask, out_w, out_s)),
        b, h, w, c2, num_heads_w, num_heads_s, ws, df, cuda.stream(qw))
    cuda.check(err, "grl_mixed_attention_nhwc (bf16)")
    cuda.launch_counts["grl_mixed_attention_nhwc.bf16"] += 1
    return out_w, out_s


def grl_mixed_attention_nhwc(
        qw: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor,
        qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
        anchor: torch.Tensor, scale_w: torch.Tensor, scale_s1: torch.Tensor,
        scale_s2: torch.Tensor, bias_w: torch.Tensor, bias_s1: torch.Tensor,
        bias_s2: torch.Tensor, mask: Optional[torch.Tensor],
        num_heads_w: int, num_heads_s: int, window_size: int,
        down_factor: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRL mixed attention over NHWC tensors.

    qw/kw/vw (already rolled for shifted blocks), qs/ks/vs: [B, H, W, C/2];
    anchor [B, H/df, W/df, C/2]; clamped logit scales scale_w [nHw, 1, 1],
    scale_s1/scale_s2 [nHs, 1, 1]; bias_w [nHw, N, N], bias_s1 [nHs, Na,
    N], bias_s2 [nHs, N, Na]; mask [nW, N, N] or None. Per-head L2
    normalisation happens inside. Returns (x_window, x_stripe), each
    [B, H, W, C/2]. The kernel takes GRL's 8x8 tiles with 4x4 anchors (ws
    8, df 2), head dims up to 96 and 16-byte aligned operands
    (:func:`plan_grl_attention`). fp32 throughout, or the halves and the
    anchor in bf16 with fp32 scales, biases and mask (the bf16 kernel,
    bf16 outputs)."""
    b, h, w, c2 = qw.shape
    ws, df = window_size, down_factor
    if qw.device.type == "cpu":
        return grl_mixed_attention_nhwc_reference(
            qw, kw, vw, qs, ks, vs, anchor, scale_w, scale_s1, scale_s2,
            bias_w, bias_s1, bias_s2, mask, num_heads_w, num_heads_s, ws, df)
    if qw.device.type != "cuda":
        raise ValueError(f"grl_mixed_attention_nhwc: unsupported device "
                         f"{qw.device}")
    _check_grl("grl_mixed_attention_nhwc", h, w, c2, num_heads_w,
               num_heads_s, ws, df)
    if qw.dtype == torch.bfloat16:
        plan_grl_attention_bf16(b, h, w, c2, num_heads_w, num_heads_s,
                                mask is not None)
        return _grl_mixed_attention_nhwc_bf16(
            (qw, kw, vw, qs, ks, vs, anchor, scale_w, scale_s1, scale_s2,
             bias_w, bias_s1, bias_s2, mask), b, h, w, c2, num_heads_w,
            num_heads_s, ws, df)
    plan_grl_attention(b, h, w, c2, num_heads_w, num_heads_s)
    n, na = ws * ws, (ws // df) ** 2
    dev = qw.device
    for name, t in (("qw", qw), ("kw", kw), ("vw", vw), ("qs", qs),
                    ("ks", ks), ("vs", vs)):
        cuda.require(t, name, (b, h, w, c2), dev)
    cuda.require(anchor, "anchor", (b, h // df, w // df, c2), dev)
    cuda.require(scale_w, "scale_w", (num_heads_w, 1, 1), dev)
    cuda.require(scale_s1, "scale_s1", (num_heads_s, 1, 1), dev)
    cuda.require(scale_s2, "scale_s2", (num_heads_s, 1, 1), dev)
    cuda.require(bias_w, "bias_w", (num_heads_w, n, n), dev)
    cuda.require(bias_s1, "bias_s1", (num_heads_s, na, n), dev)
    cuda.require(bias_s2, "bias_s2", (num_heads_s, n, na), dev)
    if mask is not None:
        cuda.require(mask, "mask", ((h // ws) * (w // ws), n, n), dev)
    _check_aligned("grl_mixed_attention_nhwc", qw, kw, vw, qs, ks, vs,
                   anchor, bias_w, bias_s1, bias_s2, mask)
    out_w = torch.empty_like(qw)
    out_s = torch.empty_like(qs)
    err = cuda.library().ff_grl_mixed_attention_nhwc(
        *(cuda.ptr(t) for t in (qw, kw, vw, qs, ks, vs, anchor, scale_w,
                                scale_s1, scale_s2, bias_w, bias_s1,
                                bias_s2, mask, out_w, out_s)),
        b, h, w, c2, num_heads_w, num_heads_s, ws, df, cuda.stream(qw))
    cuda.check(err, "grl_mixed_attention_nhwc")
    cuda.launch_counts["grl_mixed_attention_nhwc"] += 1
    return out_w, out_s


def _project(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, i: int,
             width: int) -> torch.Tensor:
    """Column segment i (`width` wide) of x @ w + b, w [in, out]."""
    cols = slice(i * width, (i + 1) * width)
    return F.linear(x, w[:, cols].t(), b[cols])


class QkvPlan(NamedTuple):
    """How ``csrc/window_attention_qkv.cu`` runs its two projections on
    ``csrc/tf32_gemm.cuh``'s GEMM (its ``qkv_plan``)."""
    qkv: GemmPlan        # x [M, Cin] -> [M, 3C]
    proj: GemmPlan       # attn [M, C] -> [M, C]
    mp: int              # M padded to ROWS: A's rows
    scratch_floats: int  # both splits, one tiled A (x, then attn)


def plan_qkv_projections(m: int, cin: int, c: int) -> QkvPlan:
    """The projections' padded extents and scratch for `m` pixels of `cin`
    channels projected to q | k | v of `c` each."""
    if max(cin, c) > MAX_CHANNELS:
        raise ValueError(f"window_attention_qkv_nhwc: Cin={cin}, C={c} > "
                         f"{MAX_CHANNELS}")
    mp = _round_up(m, ROWS)
    qkv, proj = plan_gemm(mp, cin, 3 * c), plan_gemm(mp, c, c)
    return QkvPlan(qkv, proj, mp, qkv.split_floats + proj.split_floats
                   + mp * max(qkv.kp, proj.kp))


class GrlQkvPlan(NamedTuple):
    """How ``csrc/grl_attention_qkv.cu`` projects GRL's six q/k/v halves
    on ``csrc/tf32_gemm.cuh``'s GEMM (its ``grl_qkv_plan``): two products
    of `proj`'s extents (the window half's columns from x_rolled, the
    stripe half's from x), each into a q|k|v scratch of [M, 3 C/2]."""
    proj: GemmPlan       # x [M, Cin] -> one half's q|k|v [M, 3 C/2]
    mp: int              # M padded to ROWS: A's rows
    qkv_floats: int      # one half's q|k|v, rounded up to 4 floats
    scratch_floats: int  # both splits, the tiled A, both q|k|v


def plan_grl_qkv_projections(m: int, cin: int, c2: int) -> GrlQkvPlan:
    """The projections' padded extents and scratch for `m` pixels of
    `cin` channels projected to GRL's six halves of `c2` each."""
    if cin > MAX_CHANNELS:
        raise ValueError(f"grl_mixed_attention_qkv_nhwc: Cin={cin} > "
                         f"{MAX_CHANNELS}")
    mp = _round_up(m, ROWS)
    proj = plan_gemm(mp, cin, 3 * c2)
    qkv = _round_up(m * 3 * c2, 4)
    return GrlQkvPlan(proj, mp, qkv, 2 * proj.split_floats + mp * proj.kp
                      + 2 * qkv)


def window_attention_qkv_nhwc_reference(x, wqkv, bqkv, wproj, bproj, bias,
                                        mask, num_heads: int,
                                        window_size: int,
                                        scale: Optional[float] = None):
    """Plain PyTorch: q | k | v projections, window attention, output
    projection."""
    c = wqkv.shape[1] // 3
    q, k, v = (_project(x, wqkv, bqkv, i, c) for i in range(3))
    out = window_attention_nhwc_reference(q, k, v, bias, mask, num_heads,
                                          window_size, scale)
    return F.linear(out, wproj.t(), bproj)


def _window_attention_qkv_nhwc_bf16(x, wqkv, bqkv, wproj, bproj, bias,
                                    mask, num_heads: int, ws: int,
                                    scale: float) -> torch.Tensor:
    """The bf16 kernel: x, the weights, their biases and the bias table
    bf16; the mask cast to bf16 (:func:`table_as`). Cin and C even, each at
    most 640 (the GEMM's staged rows); N = ws * ws a multiple of 16 up to
    256, head dims up to 128 (#1's bf16 kernel). The two weights go to the
    kernel laid out in wgmma's order, once per weight
    (:func:`wgmma.weight_layouts`)."""
    b, h, w, cin = x.shape
    c = wqkv.shape[1] // 3
    n, hd, dev = ws * ws, c // num_heads, x.device
    if c % 2:
        raise ValueError(f"window_attention_qkv_nhwc (bf16): C={c} must be "
                         "even")
    plan_window_attention_bf16(n, hd)
    bf = torch.bfloat16
    cuda.require(x, "x", (b, h, w, cin), dev, bf)
    # the two weights are read only through their layouts: any view
    cuda.require(wqkv, "wqkv", (cin, 3 * c), dev, bf, contiguous=False)
    cuda.require(bqkv, "bqkv", (3 * c,), dev, bf)
    cuda.require(wproj, "wproj", (c, c), dev, bf, contiguous=False)
    cuda.require(bproj, "bproj", (c,), dev, bf)
    cuda.require(bias, "bias", (num_heads, n, n), dev, bf)
    mask = table_as(mask, bf)
    if mask is not None:
        cuda.require(mask, "mask", ((h // ws) * (w // ws), n, n), dev, bf)
    if bias.data_ptr() % 16 or (mask is not None and mask.data_ptr() % 16):
        raise ValueError("window_attention_qkv_nhwc (bf16): bias and mask "
                         "must be 16-byte aligned")
    plan = wgmma.plan_qkv_bf16(b * h * w, cin, c)
    lib = cuda.library()
    nbytes = lib.ff_window_attention_qkv_bf16_scratch_bytes(b * h * w, cin,
                                                            c)
    if nbytes != plan.scratch_bytes:
        raise ValueError(f"window_attention_qkv_nhwc (bf16): Cin={cin}, "
                         f"C={c} refused")
    wq = wgmma.weight_layouts(wqkv, plan.bn_qkv)
    wp = wgmma.weight_layouts(wproj, plan.bn_proj)
    out = x.new_empty(b, h, w, c)
    scratch = torch.empty(nbytes, device=dev, dtype=torch.uint8)
    err = lib.ff_window_attention_qkv_nhwc_bf16(
        *(cuda.ptr(t) for t in (x, wq, bqkv, wp, bproj, bias, mask, out,
                                scratch)),
        nbytes, b, h, w, cin, c, num_heads, ws, scale, plan.bn_qkv,
        plan.bn_proj, cuda.stream(x))
    cuda.check(err, "window_attention_qkv_nhwc (bf16)")
    cuda.launch_counts["window_attention_qkv_nhwc.bf16"] += 1
    return out


def window_attention_qkv_nhwc(x: torch.Tensor, wqkv: torch.Tensor,
                              bqkv: torch.Tensor, wproj: torch.Tensor,
                              bproj: torch.Tensor, bias: torch.Tensor,
                              mask: Optional[torch.Tensor], num_heads: int,
                              window_size: int,
                              scale: Optional[float] = None) -> torch.Tensor:
    """x [B, H, W, Cin]; wqkv [Cin, 3C] (q | k | v columns), bqkv [3C];
    wproj [C, C] ([in, out]), bproj [C]; bias [nH, N, N]; mask [nW, N, N]
    or None. Returns proj(window_attention(qkv(x))), [B, H, W, C]. fp32
    throughout, or all but the mask in bf16 (the bf16 kernel, bf16 out).
    The weights may be views (``models/drct.py`` hands the transposed
    parameters, so that the bf16 kernel's cached layouts are reused)."""
    b, h, w, cin = x.shape
    c = wqkv.shape[1] // 3
    ws = window_size
    scale = float((c // num_heads) ** -0.5) if scale is None else float(scale)
    if x.device.type == "cpu":
        return window_attention_qkv_nhwc_reference(
            x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads, ws, scale)
    if x.device.type != "cuda":
        raise ValueError(f"window_attention_qkv_nhwc: unsupported device "
                         f"{x.device}")
    if h % ws or w % ws or c % num_heads or c // num_heads > 256:
        raise ValueError(f"window_attention_qkv_nhwc: H={h}, W={w} must be "
                         f"multiples of ws={ws} and C={c} of heads="
                         f"{num_heads} (head dim <= 256)")
    if x.dtype == torch.bfloat16:
        return _window_attention_qkv_nhwc_bf16(
            x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads, ws, scale)
    n, dev = ws * ws, x.device
    wqkv, wproj = wqkv.contiguous(), wproj.contiguous()
    cuda.require(x, "x", (b, h, w, cin), dev)
    cuda.require(wqkv, "wqkv", (cin, 3 * c), dev)
    cuda.require(bqkv, "bqkv", (3 * c,), dev)
    cuda.require(wproj, "wproj", (c, c), dev)
    cuda.require(bproj, "bproj", (c,), dev)
    cuda.require(bias, "bias", (num_heads, n, n), dev)
    if mask is not None:
        cuda.require(mask, "mask", ((h // ws) * (w // ws), n, n), dev)
    plan = plan_qkv_projections(b * h * w, cin, c)
    qkv = x.new_empty(b, h, w, 3 * c)
    attn = x.new_empty(b, h, w, c)
    out = x.new_empty(b, h, w, c)
    scratch = x.new_empty(plan.scratch_floats)
    # q, k, v: the column thirds of qkv (bases qkv + 0, C, 2 C; rows of 3 C
    # floats, so aligned with qkv where 3 C % 4 == 0, which the plan checks)
    hdp, vec = plan_window_attention(c // num_heads, num_heads, 3 * c,
                                     qkv.data_ptr() % 16 == 0)
    err = cuda.library().ff_window_attention_qkv_nhwc(
        *(cuda.ptr(t) for t in (x, wqkv, bqkv, wproj, bproj, bias, mask,
                                qkv, attn, out, scratch)),
        plan.scratch_floats, b, h, w, cin, c, num_heads, ws, scale, hdp,
        int(vec),
        cuda.stream(x))
    cuda.check(err, "window_attention_qkv_nhwc")
    cuda.launch_counts["window_attention_qkv_nhwc"] += 1
    return out


def _check_shifted(x_rolled, mask) -> None:
    if (x_rolled is None) != (mask is None):
        raise ValueError("x_rolled and mask must both be set (shifted) or "
                         "both be None")


def grl_mixed_attention_qkv_nhwc_reference(
        x, x_rolled, anchor, wqkv, bqkv, scale_w, scale_s1, scale_s2,
        bias_w, bias_s1, bias_s2, mask, num_heads_w: int, num_heads_s: int,
        window_size: int, down_factor: int = 2):
    """Plain PyTorch: the six q/k/v projections (window half from
    x_rolled, stripe half from x), then the plain mixed attention."""
    _check_shifted(x_rolled, mask)
    c2 = wqkv.shape[1] // 6
    xr = x if x_rolled is None else x_rolled
    qw, kw, vw = (_project(xr, wqkv, bqkv, i, c2) for i in range(3))
    qs, ks, vs = (_project(x, wqkv, bqkv, i, c2) for i in range(3, 6))
    return grl_mixed_attention_nhwc_reference(
        qw, kw, vw, qs, ks, vs, anchor, scale_w, scale_s1, scale_s2, bias_w,
        bias_s1, bias_s2, mask, num_heads_w, num_heads_s, window_size,
        down_factor)


def _grl_mixed_attention_qkv_nhwc_bf16(args, num_heads_w: int,
                                       num_heads_s: int, ws: int, df: int):
    """The bf16 kernel: x, x_rolled, the anchor, wqkv and bqkv bf16;
    scales and biases fp32, the mask cast to bf16 and laid out as #2's
    bf16 kernel takes it (:func:`grl_mask_layout`, once for a device
    table). C/2 even, at most 128; Cin even. wqkv goes to the kernel in :func:`wgmma.segment_layout`'s order,
    laid out once per weight (any view of it)."""
    (x, x_rolled, anchor, wqkv, bqkv, scale_w, scale_s1, scale_s2, bias_w,
     bias_s1, bias_s2, mask) = args
    b, h, w, cin = x.shape
    c2 = wqkv.shape[1] // 6
    n, na, dev, bf = ws * ws, (ws // df) ** 2, x.device, torch.bfloat16
    if c2 % 2 or c2 > 128:
        raise ValueError(f"grl_mixed_attention_qkv_nhwc (bf16): C/2={c2} "
                         "must be even and at most 128")
    cuda.require(x, "x", (b, h, w, cin), dev, bf)
    if x_rolled is not None:
        cuda.require(x_rolled, "x_rolled", (b, h, w, cin), dev, bf)
    cuda.require(anchor, "anchor", (b, h // df, w // df, c2), dev, bf)
    # read only through its layout: any view
    cuda.require(wqkv, "wqkv", (cin, 6 * c2), dev, bf, contiguous=False)
    cuda.require(bqkv, "bqkv", (6 * c2,), dev, bf)
    _check_terms(scale_w, scale_s1, scale_s2, bias_w, bias_s1, bias_s2, mask,
                 num_heads_w, num_heads_s, h, w, ws, n, na, dev)
    mask = table_as(mask, bf, grl_mask_layout)
    _check_aligned("grl_mixed_attention_qkv_nhwc (bf16)", anchor, mask)
    _check_aligned("grl_mixed_attention_qkv_nhwc (bf16)", bias_w, bias_s1,
                   bias_s2, align=8)
    lib = cuda.library()
    nbytes = lib.ff_grl_qkv_bf16_scratch_bytes(b * h * w, cin, c2)
    if nbytes < 0:
        raise ValueError(f"grl_mixed_attention_qkv_nhwc (bf16): Cin={cin}, "
                         f"C/2={c2} refused")
    wl = wgmma.segment_layouts(wqkv, 6)
    out_w = x.new_empty(b, h, w, c2)
    out_s = x.new_empty(b, h, w, c2)
    scratch = torch.empty(nbytes, device=dev, dtype=torch.uint8)
    err = lib.ff_grl_mixed_attention_qkv_nhwc_bf16(
        *(cuda.ptr(t) for t in (x, x_rolled, anchor, wl, bqkv, scale_w,
                                scale_s1, scale_s2, bias_w, bias_s1,
                                bias_s2, mask, out_w, out_s, scratch)),
        nbytes, b, h, w, cin, c2, wgmma.segment_cols(c2), num_heads_w,
        num_heads_s, ws, df, cuda.stream(x))
    cuda.check(err, "grl_mixed_attention_qkv_nhwc (bf16)")
    cuda.launch_counts["grl_mixed_attention_qkv_nhwc.bf16"] += 1
    return out_w, out_s


def grl_mixed_attention_qkv_nhwc(
        x: torch.Tensor, x_rolled: Optional[torch.Tensor],
        anchor: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
        scale_w: torch.Tensor, scale_s1: torch.Tensor,
        scale_s2: torch.Tensor, bias_w: torch.Tensor, bias_s1: torch.Tensor,
        bias_s2: torch.Tensor, mask: Optional[torch.Tensor],
        num_heads_w: int, num_heads_s: int, window_size: int,
        down_factor: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRL mixed attention with the 6-way qkv projection in the kernel.

    x [B, H, W, C]; x_rolled its (-s, -s) roll for shifted blocks, or None
    (then mask is None too): the window half projects from x_rolled, the
    stripe half from x. wqkv [C, 3C] / bqkv [3C] in _SplitQKV6's order
    (qw | kw | vw | qs | ks | vs, each C/2). anchor, scales, biases and
    mask as in grl_mixed_attention_nhwc, and the same geometry. Returns
    (x_window, x_stripe), each [B, H, W, C/2]. fp32 throughout, or x,
    x_rolled, the anchor, wqkv and bqkv in bf16 with fp32 scales, biases
    and mask (the bf16 kernel, bf16 outputs). wqkv may be a view
    (``models/grl.py`` hands the transposed parameter, so that the bf16
    kernel's cached layout is reused)."""
    _check_shifted(x_rolled, mask)
    b, h, w, cin = x.shape
    c2 = wqkv.shape[1] // 6
    ws, df = window_size, down_factor
    if x.device.type == "cpu":
        return grl_mixed_attention_qkv_nhwc_reference(
            x, x_rolled, anchor, wqkv, bqkv, scale_w, scale_s1, scale_s2,
            bias_w, bias_s1, bias_s2, mask, num_heads_w, num_heads_s, ws, df)
    if x.device.type != "cuda":
        raise ValueError(f"grl_mixed_attention_qkv_nhwc: unsupported device "
                         f"{x.device}")
    _check_grl("grl_mixed_attention_qkv_nhwc", h, w, c2, num_heads_w,
               num_heads_s, ws, df)
    if x.dtype == torch.bfloat16:
        plan_grl_attention_bf16(b, h, w, c2, num_heads_w, num_heads_s,
                                mask is not None)
        return _grl_mixed_attention_qkv_nhwc_bf16(
            (x, x_rolled, anchor, wqkv, bqkv, scale_w, scale_s1, scale_s2,
             bias_w, bias_s1, bias_s2, mask), num_heads_w, num_heads_s, ws,
            df)
    plan_grl_attention(b, h, w, c2, num_heads_w, num_heads_s)
    n, na = ws * ws, (ws // df) ** 2
    dev = x.device
    wqkv = wqkv.contiguous()  # the model hands a view of its parameter
    cuda.require(x, "x", (b, h, w, cin), dev)
    if x_rolled is not None:
        cuda.require(x_rolled, "x_rolled", (b, h, w, cin), dev)
    cuda.require(anchor, "anchor", (b, h // df, w // df, c2), dev)
    cuda.require(wqkv, "wqkv", (cin, 6 * c2), dev)
    cuda.require(bqkv, "bqkv", (6 * c2,), dev)
    cuda.require(scale_w, "scale_w", (num_heads_w, 1, 1), dev)
    cuda.require(scale_s1, "scale_s1", (num_heads_s, 1, 1), dev)
    cuda.require(scale_s2, "scale_s2", (num_heads_s, 1, 1), dev)
    cuda.require(bias_w, "bias_w", (num_heads_w, n, n), dev)
    cuda.require(bias_s1, "bias_s1", (num_heads_s, na, n), dev)
    cuda.require(bias_s2, "bias_s2", (num_heads_s, n, na), dev)
    if mask is not None:
        cuda.require(mask, "mask", ((h // ws) * (w // ws), n, n), dev)
    _check_aligned("grl_mixed_attention_qkv_nhwc", anchor, bias_w, bias_s1,
                   bias_s2, mask)
    plan = plan_grl_qkv_projections(b * h * w, cin, c2)
    out_w = x.new_empty(b, h, w, c2)
    out_s = x.new_empty(b, h, w, c2)
    scratch = x.new_empty(plan.scratch_floats)
    err = cuda.library().ff_grl_mixed_attention_qkv_nhwc(
        *(cuda.ptr(t) for t in (x, x_rolled, anchor, wqkv, bqkv, scale_w,
                                scale_s1, scale_s2, bias_w, bias_s1,
                                bias_s2, mask, out_w, out_s, scratch)),
        plan.scratch_floats, b, h, w, cin, c2, num_heads_w, num_heads_s, ws,
        df, cuda.stream(x))
    cuda.check(err, "grl_mixed_attention_qkv_nhwc")
    cuda.launch_counts["grl_mixed_attention_qkv_nhwc"] += 1
    return out_w, out_s
