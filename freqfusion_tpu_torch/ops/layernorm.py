"""One-pass LayerNorm over the last axis: the CUDA kernel, its plain version
and a module around it.

Counterpart of ``freqfusion_tpu/ops/layernorm.py``: ``fused_layernorm``
takes x of any leading shape, fp32 or bf16, with weight and bias [C] read
as fp32, and returns x's dtype. Its arithmetic is the JAX kernel's, not
``F.layer_norm``'s: an fp32 mean, var = E[x^2] - mean^2 with no clamp, then
(x - mean) * rsqrt(var + eps) * weight + bias. A CPU tensor goes to the
plain version; a CUDA tensor goes to ``csrc/layernorm.cu`` or the call
raises. As in the JAX package, no model uses it: the JAX models measured
it against flax's LayerNorm and kept flax's, and the port's models keep
``nn.LayerNorm``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from . import cuda

__all__ = ["fused_layernorm", "fused_layernorm_reference", "FusedLayerNorm"]

_DTYPES = (torch.float32, torch.bfloat16)


def fused_layernorm_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor,
                              eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_layernorm`."""
    xf = x.float()
    inv_c = 1.0 / x.shape[-1]
    mean = xf.sum(-1, keepdim=True) * inv_c
    var = (xf * xf).sum(-1, keepdim=True) * inv_c - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def fused_layernorm(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of x [..., C] (fp32 or bf16) over its last axis with
    weight and bias [C]; returns x's shape and dtype."""
    if x.device.type == "cpu":
        return fused_layernorm_reference(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layernorm: unsupported device {x.device}")
    c = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_layernorm: x must be float32 or bfloat16, "
                         f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_layernorm: x must be contiguous")
    w, b = (t.to(torch.float32).contiguous() for t in (weight, bias))
    for name, t in (("weight", w), ("bias", b)):
        cuda.require(t, name, (c,), x.device)
    out = torch.empty_like(x)
    rows = x.numel() // c if c else 0
    if rows == 0:
        return out
    if rows >= 2 ** 31:
        raise ValueError(f"fused_layernorm: {rows} rows, the kernel takes "
                         "fewer than 2^31")
    err = cuda.library().ff_layernorm(
        *(cuda.ptr(t) for t in (x, w, b, out)), rows, c,
        int(x.dtype == torch.bfloat16), float(eps), cuda.stream(x))
    cuda.check(err, "fused_layernorm")
    cuda.launch_counts["fused_layernorm"] += 1
    return out


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis through :func:`fused_layernorm`, with
    ``nn.LayerNorm``'s state-dict names (``weight``, ``bias``): the
    counterpart of the JAX ``FusedLayerNorm`` (params ``scale``, ``bias``;
    ``convert/from_jax.py:from_jax_layernorm`` carries them across)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layernorm(x, self.weight, self.bias, self.eps)
