"""The fusion net's eval LKABlock: the CUDA kernel and the plain version.

Counterpart of ``freqfusion_tpu/ops/pallas_lka.py:lka_block_fused``, with
its argument layout: x [B, H, W, C] and ``p`` the flax tree {norm1,
lka{local_conv, h_conv, v_conv, pw_conv, bn}, scale1, norm2, ffn_0, ffn_2},
here as tensors (BN trees {scale, bias, mean, var}; depthwise kernels
[kh, kw, 1, C]; 1x1 kernels [1, 1, Cin, Cout]):

    t   = BN1(x)
    x1  = x + scale1 * t * sigmoid(BN(dw21x1(dw1x21(dw5x5(t))) @ pw))
    out = x1 + scale2 * (gelu(BN2(x1) @ ffn_0 + b) @ ffn_2 + b)

Eval BatchNorm (running statistics, eps 1e-5) is a per-channel affine,
folded on the host. GELU is exact (erf); the depthwise convolutions
zero-pad. A CPU tensor goes to the plain version; a CUDA tensor goes to
``csrc/lka.cu`` (a depthwise pass into a scratch, then the chain of
products) or the call raises. Unlike the JAX wrapper, the kernel takes
every H and W itself: there is no XLA fallback.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from . import cuda

__all__ = ["lka_block_fused", "lka_block_fused_reference"]

MAX_CHANNELS = 128  # the kernel's output row lives in registers
EPS = 1e-5


def _affine(bn: Dict[str, torch.Tensor]):
    s = bn["scale"] / torch.sqrt(bn["var"] + EPS)
    return s, bn["bias"] - bn["mean"] * s


def _dw(t: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """NHWC depthwise convolution, zero padding, kernel [kh, kw, 1, C]."""
    kh, kw = kernel.shape[:2]
    y = F.conv2d(t.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 padding=(kh // 2, kw // 2), groups=t.shape[-1])
    return y.permute(0, 2, 3, 1)


def lka_block_fused_reference(x: torch.Tensor, p: Dict[str, Any]
                              ) -> torch.Tensor:
    """Plain PyTorch version of :func:`lka_block_fused` (the JAX
    package's ``_lka_xla``)."""
    lka = p["lka"]
    a1, b1 = _affine(p["norm1"])
    t = x * a1 + b1
    a = _dw(_dw(_dw(t, lka["local_conv"]["kernel"]), lka["h_conv"]["kernel"]),
            lka["v_conv"]["kernel"])
    abn, bbn = _affine(lka["bn"])
    a = (a @ lka["pw_conv"]["kernel"][0, 0]) * abn + bbn
    x1 = x + p["scale1"] * (t * torch.sigmoid(a))
    a2, b2 = _affine(p["norm2"])
    hid = F.gelu((x1 * a2 + b2) @ p["ffn_0"]["kernel"][0, 0]
                 + p["ffn_0"]["bias"])
    f = hid @ p["ffn_2"]["kernel"][0, 0] + p["ffn_2"]["bias"]
    return x1 + p["scale2"] * f


def lka_block_fused(x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    """One eval LKABlock. x [B, H, W, C] contiguous, C a multiple of 4 and
    <= 128; p the tree above. Returns [B, H, W, C]."""
    if x.device.type == "cpu":
        return lka_block_fused_reference(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"lka_block_fused: unsupported device {x.device}")
    b, h, w, c = x.shape
    ch = p["ffn_0"]["kernel"].shape[-1]
    if c % 4 or c > MAX_CHANNELS:
        raise ValueError(f"lka_block_fused: C={c} is not a multiple of 4 "
                         f"<= {MAX_CHANNELS}")
    dev = x.device
    cuda.require(x, "x", (b, h, w, c), dev)
    if x.data_ptr() % 16:
        raise ValueError("lka_block_fused: x must be 16-byte aligned")
    lka = p["lka"]
    s1, b1 = _affine(p["norm1"])
    sbn, bbn = _affine(lka["bn"])
    s2, b2 = _affine(p["norm2"])
    w5 = lka["local_conv"]["kernel"].reshape(25, c).contiguous()
    wh = lka["h_conv"]["kernel"].reshape(21, c).contiguous()
    wv = lka["v_conv"]["kernel"].reshape(21, c).contiguous()
    pw = lka["pw_conv"]["kernel"][0, 0].contiguous()
    f0 = p["ffn_0"]["kernel"][0, 0].contiguous()
    f2 = p["ffn_2"]["kernel"][0, 0].contiguous()
    c0, c2 = p["ffn_0"]["bias"], p["ffn_2"]["bias"]
    for name, t, shape in (
            ("norm1 scale", s1, (c,)), ("norm1 shift", b1, (c,)),
            ("local_conv", w5, (25, c)), ("h_conv", wh, (21, c)),
            ("v_conv", wv, (21, c)), ("pw_conv", pw, (c, c)),
            ("bn scale", sbn, (c,)), ("bn shift", bbn, (c,)),
            ("norm2 scale", s2, (c,)), ("norm2 shift", b2, (c,)),
            ("ffn_0", f0, (c, ch)), ("ffn_0 bias", c0, (ch,)),
            ("ffn_2", f2, (ch, c)), ("ffn_2 bias", c2, (c,)),
            ("scale1", p["scale1"], ()), ("scale2", p["scale2"], ())):
        cuda.require(t, name, shape, dev)
    a = torch.empty_like(x)
    out = torch.empty_like(x)
    err = cuda.library().ff_lka_block(
        *(cuda.ptr(t) for t in (x, s1, b1, w5, wh, wv, pw, sbn, bbn, s2, b2,
                                f0, c0, f2, c2, p["scale1"], p["scale2"], a,
                                out)),
        b, h, w, c, ch, cuda.stream(x))
    cuda.check(err, "lka_block_fused")
    cuda.launch_counts["lka_block_fused"] += 1
    return out
