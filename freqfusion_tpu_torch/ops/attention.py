"""Window attention kernels for DRCT and GRL, with their plain versions.

Counterpart of ``freqfusion_tpu/ops/pallas_attention.py``. Each public
function takes the Pallas wrapper's NHWC layout and argument order. A CPU
tensor goes to the plain PyTorch version (``*_reference``); a CUDA tensor
goes to the hand-written kernel in ``csrc/`` or the call raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda
from .window_attention import (multi_head_window_attention, window_partition,
                               window_reverse)

__all__ = ["window_attention_nhwc", "window_attention_nhwc_reference",
           "grl_mixed_attention_nhwc", "grl_mixed_attention_nhwc_reference"]


def window_attention_nhwc_reference(q, k, v, bias, mask, num_heads: int,
                                    window_size: int,
                                    scale: Optional[float] = None):
    """Plain PyTorch window attention: partition, attention, reverse."""
    _, h, w, c = q.shape
    scale = float((c // num_heads) ** -0.5) if scale is None else scale
    qw, kw, vw = (window_partition(t, window_size) for t in (q, k, v))
    out = multi_head_window_attention(qw, kw, vw, num_heads, bias, mask,
                                      scale)
    return window_reverse(out, window_size, h, w)


def window_attention_nhwc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, mask: Optional[torch.Tensor],
                          num_heads: int, window_size: int,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v [B, H, W, C] (H % ws == 0 == W % ws); bias [nH, N, N]; mask
    [nW, N, N] (row-major windows) or None. Returns [B, H, W, C]:
    softmax(q k^T * scale + bias + mask) v per window and head, scale
    defaulting to head_dim ** -0.5."""
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
        cuda.stream(q))
    cuda.check(err, "window_attention_nhwc")
    cuda.launch_counts["window_attention_nhwc"] += 1
    return out


def _cosine_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B_, N, C] -> per-head L2-normalised [B_, nH, N, hd]
    (F.normalize, eps 1e-12)."""
    b_, n, c = x.shape
    xh = x.reshape(b_, n, num_heads, c // num_heads).transpose(1, 2)
    return F.normalize(xh, dim=-1, eps=1e-12)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b_, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b_, n, h * d)


def grl_mixed_attention_nhwc_reference(qw, kw, vw, qs, ks, vs, anchor,
                                       scale_w, scale_s1, scale_s2, bias_w,
                                       bias_s1, bias_s2, mask,
                                       num_heads_w: int, num_heads_s: int,
                                       window_size: int,
                                       down_factor: int = 2):
    """Plain PyTorch GRL mixed attention (window half and anchored stripe
    half of each ws x ws tile)."""
    _, h, w, _ = qw.shape
    ws = window_size
    aws = ws // down_factor
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
    [B, H, W, C/2]."""
    b, h, w, c2 = qw.shape
    ws, df = window_size, down_factor
    if qw.device.type == "cpu":
        return grl_mixed_attention_nhwc_reference(
            qw, kw, vw, qs, ks, vs, anchor, scale_w, scale_s1, scale_s2,
            bias_w, bias_s1, bias_s2, mask, num_heads_w, num_heads_s, ws, df)
    if qw.device.type != "cuda":
        raise ValueError(f"grl_mixed_attention_nhwc: unsupported device "
                         f"{qw.device}")
    if (h % ws or w % ws or ws % df or c2 % num_heads_w
            or c2 % num_heads_s):
        raise ValueError(f"grl_mixed_attention_nhwc: bad geometry H={h} "
                         f"W={w} ws={ws} df={df} C/2={c2}")
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
