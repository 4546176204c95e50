"""Fused transformer FFN half: the CUDA kernel and its plain version.

Counterpart of ``freqfusion_tpu/ops/pallas_mlp.py:fused_mlp_block``, with
its argument layout (w1 [C, Ch], w2 [Ch, C]) and its two norm orders:

    pre-norm  (DRCT)  out = x + res_scale * fc2(gelu(fc1(LN(x))))
    post-norm (GRL)   out = x + res_scale * LN(fc2(gelu(fc1(x))))

GELU is exact (erf). A CPU tensor goes to the plain version; a CUDA tensor
goes to ``csrc/fused_mlp.cu``, which keeps the hidden activation on-chip,
or the call raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda

__all__ = ["fused_mlp_block", "fused_mlp_block_reference"]

MAX_CHANNELS = 384  # the kernel's output row lives in registers


def fused_mlp_block_reference(x, w1, b1, w2, b2, ln_scale, ln_bias,
                              prenorm: bool = True, res_scale: float = 1.0,
                              eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_mlp_block`."""
    c = x.shape[-1]
    t = F.layer_norm(x, (c,), ln_scale, ln_bias, eps) if prenorm else x
    y = F.gelu(t @ w1 + b1) @ w2 + b2
    if not prenorm:
        y = F.layer_norm(y, (c,), ln_scale, ln_bias, eps)
    return x + res_scale * y


def fused_mlp_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor,
                    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                    prenorm: bool = True, res_scale: float = 1.0,
                    eps: float = 1e-5) -> torch.Tensor:
    """x [..., C] (any leading shape); w1 [C, Ch]; b1 [Ch]; w2 [Ch, C];
    b2, ln_scale, ln_bias [C]. Returns x + res_scale * FFN-branch(x) with
    the norm order above, shaped like x."""
    if x.device.type == "cpu":
        return fused_mlp_block_reference(x, w1, b1, w2, b2, ln_scale,
                                         ln_bias, prenorm, res_scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_block: unsupported device {x.device}")
    c, ch = x.shape[-1], w1.shape[-1]
    if c > MAX_CHANNELS:
        raise ValueError(f"fused_mlp_block: C={c} > {MAX_CHANNELS}")
    m = x.numel() // c
    dev = x.device
    cuda.require(x, "x", x.shape, dev)
    cuda.require(w1, "w1", (c, ch), dev)
    cuda.require(b1, "b1", (ch,), dev)
    cuda.require(w2, "w2", (ch, c), dev)
    for name, t in (("b2", b2), ("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        cuda.require(t, name, (c,), dev)
    out = torch.empty_like(x)
    err = cuda.library().ff_fused_mlp(
        *(cuda.ptr(t) for t in (x, w1, b1, w2, b2, ln_scale, ln_bias, out)),
        m, c, ch, int(prenorm), float(res_scale), float(eps), cuda.stream(x))
    cuda.check(err, "fused_mlp_block")
    cuda.launch_counts["fused_mlp_block"] += 1
    return out
