"""Phases 3-4: large-kernel attention and per-pixel token attention.

Counterpart of ``freqfusion_tpu/models/fusion/lka.py``: the decomposed
21x21 LKA gate (5x5 DW -> 1x21 DW -> 21x1 DW -> 1x1 -> BN -> sigmoid),
LKABlock, per-pixel attention over the 9 bands (phase 3) and the 4 experts
(phase 4). BatchNorm runs with eval semantics (running statistics).
``TokenMultiheadAttention`` keeps nn.MultiheadAttention's parameter names.
The token LayerNorms use eps 1e-6, as the JAX model (flax's default) does.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_bilinear
from ..common import to_nchw, to_nhwc

__all__ = ["LargeKernelAttention", "LKABlock", "TokenMultiheadAttention",
           "EnhancedCrossBandWithLKA", "EnhancedCollaborativeWithLKA"]

_TOKEN_LN_EPS = 1e-6


def _dw(dim: int, kh: int, kw: int) -> nn.Conv2d:
    return nn.Conv2d(dim, dim, (kh, kw), padding=(kh // 2, kw // 2),
                     groups=dim, bias=False)


class LargeKernelAttention(nn.Module):
    def __init__(self, dim: int, kernel_size: int = 21):
        super().__init__()
        self.local_conv = _dw(dim, 5, 5)
        self.h_conv = _dw(dim, 1, kernel_size)
        self.v_conv = _dw(dim, kernel_size, 1)
        self.pw_conv = nn.Conv2d(dim, dim, 1, bias=False)
        self.bn = nn.BatchNorm2d(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.v_conv(self.h_conv(self.local_conv(x)))
        return x * torch.sigmoid(self.bn(self.pw_conv(attn)))


class LKABlock(nn.Module):
    """BN -> LKA -> +scale1 * res, BN -> FFN -> +scale2 * res."""

    def __init__(self, dim: int, kernel_size: int = 21,
                 ffn_ratio: float = 2.0):
        super().__init__()
        hidden = int(dim * ffn_ratio)
        self.norm1 = nn.BatchNorm2d(dim)
        self.lka = LargeKernelAttention(dim, kernel_size)
        self.scale1 = nn.Parameter(torch.tensor(0.1))
        self.norm2 = nn.BatchNorm2d(dim)
        self.ffn = nn.Sequential(nn.Conv2d(dim, hidden, 1), nn.GELU(),
                                 nn.Conv2d(hidden, dim, 1))
        self.scale2 = nn.Parameter(torch.tensor(0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.scale1 * self.lka(self.norm1(x))
        return x + self.scale2 * self.ffn(self.norm2(x))


class TokenMultiheadAttention(nn.Module):
    """Self-attention over a small token axis: x [..., T, E] -> [..., T, E],
    independently per leading index (eval: no dropout)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def reset_extra(self, g: torch.Generator) -> None:
        nn.init.xavier_uniform_(self.in_proj_weight, generator=g)
        self.in_proj_bias.zero_()
        self.out_proj.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e = x.shape[-1]
        hd = e // self.num_heads
        q, k, v = F.linear(x, self.in_proj_weight,
                           self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(*t.shape[:-1], self.num_heads, hd)
                   for t in (q, k, v))
        logits = torch.einsum("...qhd,...khd->...hqk", q, k) / hd ** 0.5
        out = torch.einsum("...hqk,...khd->...qhd", logits.softmax(-1), v)
        return self.out_proj(out.reshape(x.shape))


class EnhancedCrossBandWithLKA(nn.Module):
    """Phase 3: per-pixel attention across the 9 bands + shared LKA."""

    def __init__(self, dim: int = 64, num_heads: int = 4,
                 lka_kernel: int = 21):
        super().__init__()
        self.band_proj = nn.Conv2d(3, dim, 1)
        self.norm = nn.LayerNorm(dim, eps=_TOKEN_LN_EPS)
        self.band_attention = TokenMultiheadAttention(dim, num_heads)
        self.lka_block = LKABlock(dim, lka_kernel)
        self.out_proj = nn.Conv2d(dim, 3, 1)

    def forward(self, bands: List[torch.Tensor]) -> List[torch.Tensor]:
        w = self.band_proj.weight.flatten(1)
        projected = torch.stack([F.linear(to_nhwc(b), w, self.band_proj.bias)
                                 for b in bands], dim=-2)   # [B,H,W,T,dim]
        attn = self.band_attention(self.norm(projected)) + projected
        return [self.out_proj(self.lka_block(to_nchw(attn[..., i, :]))) + b
                for i, b in enumerate(bands)]


FEATURE_CHANNELS = {"drct": 180, "grl": 180, "nafnet": 64, "mamba": 180}


class EnhancedCollaborativeWithLKA(nn.Module):
    """Phase 4: per-pixel attention across experts + LKA + modulation."""

    EXPERT_NAMES = ("drct", "grl", "nafnet", "mamba")

    def __init__(self, num_experts: int = 4, feature_dim: int = 128,
                 num_heads: int = 8, lka_kernel: int = 21):
        super().__init__()
        self.names = self.EXPERT_NAMES[:num_experts]
        self.align_layers = nn.ModuleDict(
            {n: nn.Conv2d(FEATURE_CHANNELS[n], feature_dim, 1)
             for n in self.names})
        self.norm1 = nn.LayerNorm(feature_dim, eps=_TOKEN_LN_EPS)
        self.cross_attn = TokenMultiheadAttention(feature_dim, num_heads)
        self.norm2 = nn.LayerNorm(feature_dim, eps=_TOKEN_LN_EPS)
        self.ffn = nn.Sequential(nn.Linear(feature_dim, 2 * feature_dim),
                                 nn.GELU(),
                                 nn.Linear(2 * feature_dim, feature_dim))
        self.lka_global = LKABlock(feature_dim, lka_kernel)
        self.modulation = nn.ModuleList(
            nn.Sequential(nn.Conv2d(feature_dim, feature_dim // 4, 1),
                          nn.GELU(), nn.Conv2d(feature_dim // 4, 3, 1),
                          nn.Sigmoid())
            for _ in range(num_experts))

    def forward(self, feats: Dict[str, torch.Tensor],
                outputs: List[torch.Tensor]) -> List[torch.Tensor]:
        stacked = torch.stack(
            [F.linear(to_nhwc(feats[n]), self.align_layers[n].weight.flatten(1),
                      self.align_layers[n].bias) for n in self.names], dim=-2)
        stacked = stacked + self.cross_attn(self.norm1(stacked))
        stacked = stacked + self.ffn(self.norm2(stacked))
        h_sr, w_sr = outputs[0].shape[-2:]
        enhanced = []
        for i, out in enumerate(outputs):
            feat = self.lka_global(to_nchw(stacked[..., i, :]))
            mod = self.modulation[i](resize_bilinear(feat, h_sr, w_sr))
            enhanced.append((out * (1.0 + 0.2 * (mod - 0.5))).clamp(0.0, 1.0))
        return enhanced
