"""Small shared pieces of the port's models: layout helpers, the kernel
gates and seeded init."""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["RGB_MEAN", "gate", "to_nhwc", "to_nchw", "conv1x1_nhwc",
           "conv_nhwc", "hwio", "LayerNorm2d", "Mlp", "PatchEmbed",
           "pixel_shuffle_upsampler", "init_weights"]

RGB_MEAN = (0.4488, 0.4371, 0.4040)


def gate(name: str) -> bool:
    """A fused-kernel gate of the JAX package (FREQFUSION_MLP, _CAB,
    _NAFBLOCK, _DWCONV, _ATTN_QKV, _GRL_QKV, _TOKEN_ATTN, _LKA, _HIER,
    _EDGE): on only when the variable is "1", read at forward time, as at
    the JAX call sites."""
    return os.environ.get(name) == "1"


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def conv1x1_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 Conv2d applied to an NHWC tensor as a channel matmul."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Any NCHW module applied to an NHWC tensor."""
    return to_nhwc(conv(to_nchw(x)))


def hwio(conv: nn.Conv2d) -> dict:
    """A Conv2d's parameters as the flax tree's {kernel [kh, kw, Cin/g,
    Cout], bias}, the layout the fused kernels take."""
    return {"kernel": conv.weight.permute(2, 3, 1, 0).contiguous(),
            "bias": conv.bias}


def hwio_view(conv: nn.Conv2d) -> dict:
    """:func:`hwio` with the kernel a view of the parameter: the bf16
    kernels lay it out once per parameter and reuse that while it is
    unchanged (a fresh copy would be laid out anew on every call)."""
    return {"kernel": conv.weight.permute(2, 3, 1, 0), "bias": conv.bias}


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel axis of an NCHW tensor."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), self.weight,
                         self.bias, self.eps)
        return y.permute(0, 3, 1, 2)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 over the last axis."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class PatchEmbed(nn.Module):
    """Holds the post-embedding LayerNorm as ``patch_embed.norm``."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)


def pixel_shuffle_upsampler(upscale: int, num_feat: int) -> nn.Sequential:
    """(conv 3x3 -> 4 num_feat, PixelShuffle(2)) per factor of 2."""
    layers = []
    for _ in range(int(math.log2(upscale))):
        layers += [nn.Conv2d(num_feat, 4 * num_feat, 3, 1, 1),
                   nn.PixelShuffle(2)]
    return nn.Sequential(*layers)


@torch.no_grad()
def init_weights(model: nn.Module, generator: Optional[torch.Generator]
                 ) -> None:
    """Seeded initialisation, layer by layer, following the reference
    architectures: Linear trunc_normal(0.02) with zero bias, Conv2d
    PyTorch's default (Kaiming-uniform a=sqrt(5), uniform bias), norms at
    1 / 0. A module with its own parameters to draw defines
    ``reset_extra(generator)``, which runs after its children."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, generator=g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=g)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.bias.uniform_(-bound, bound, generator=g)
        elif isinstance(m, (nn.LayerNorm, LayerNorm2d, nn.BatchNorm2d)):
            if m.weight is not None:
                m.weight.fill_(1.0)
                m.bias.zero_()
    for m in model.modules():
        if hasattr(m, "reset_extra"):
            m.reset_extra(g)
