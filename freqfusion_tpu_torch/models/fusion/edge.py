"""Phase 7b: Laplacian-pyramid edge refinement.

Counterpart of ``freqfusion_tpu/models/fusion/edge.py`` (NCHW): a 3-level
pyramid (5x5 Gaussian, sigma 1.5, zero padded; 2x2 average pool), one
residual refiner with spatial attention per level, softmax level weights,
a fusion conv to an edge map and a per-pixel gate scaled by a learnable
edge strength (0.15). Output clamped to [0, 1]. With FREQFUSION_EDGE=1
and 3 levels (``freqfusion_tpu/models/fusion/edge.py:109``) each level's
refiner runs in ``ops/edge.py``'s refine kernel and the weighted concat,
fusion, gate and clip in its fuse kernel, reading the NCHW tensors through
their strides; the pyramid and the resizes to HR stay in PyTorch.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.edge import edge_fuse_fused, edge_refine_fused
from ...ops.resize import resize_bilinear
from ...ops.window_attention import device_table
from .. import common

__all__ = ["EdgeRefineBlock", "LaplacianPyramidRefinement",
           "gaussian_blur_5x5"]


def _gaussian_kernel_np(kernel_size: int = 5, sigma: float = 1.5
                        ) -> np.ndarray:
    coords = np.arange(kernel_size, dtype=np.float32) - kernel_size // 2
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def gaussian_blur_5x5(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 5x5 Gaussian blur, zero padded; the kernel in x's dtype
    (rounded to bf16 for a bf16 x, as the JAX module's)."""
    c = x.shape[1]
    k = device_table(_gaussian_kernel_np, 5, 1.5, device=x.device).to(x.dtype)
    return F.conv2d(x, k.view(1, 1, 5, 5).expand(c, 1, 5, 5), padding=2,
                    groups=c)


def _hwio_view(conv: nn.Conv2d) -> dict:
    """A Conv2d's parameters as {kernel [kh, kw, Cin, Cout], bias}, the
    kernel a view of the OIHW weight, no copy: ``ops/edge.py`` reads it
    through its strides."""
    return {"kernel": conv.weight.permute(2, 3, 1, 0), "bias": conv.bias}


class _SpatialAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(c, c // 4, 1), nn.GELU(),
                                  nn.Conv2d(c // 4, 1, 3, 1, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv(x)


class EdgeRefineBlock(nn.Module):
    def __init__(self, in_ch: int = 3, feat_ch: int = 32):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, feat_ch, 1)
        self.conv1 = nn.Conv2d(in_ch, feat_ch, 3, 1, 1)
        self.conv2 = nn.Conv2d(feat_ch, feat_ch, 3, 1, 1)
        self.conv3 = nn.Conv2d(feat_ch, feat_ch, 3, 1, 1)
        self.attn = _SpatialAttention(feat_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.conv2(F.gelu(self.conv1(x))))
        return self.attn(self.conv3(h) + self.proj(x))

    def fused_params(self) -> dict:
        """The block as the flax tree ``ops/edge.py`` takes, the kernels
        as views (``ops/edge.py`` reads them through their strides)."""
        return {"proj": _hwio_view(self.proj), "conv1": _hwio_view(self.conv1),
                "conv2": _hwio_view(self.conv2),
                "conv3": _hwio_view(self.conv3),
                "attn_0": _hwio_view(self.attn.conv[0]),
                "attn_2": _hwio_view(self.attn.conv[2])}


def build_laplacian_pyramid(img: torch.Tensor, num_levels: int
                            ) -> List[torch.Tensor]:
    pyramid, current = [], img
    for level in range(num_levels):
        if level < num_levels - 1:
            down = F.avg_pool2d(gaussian_blur_5x5(current), 2, 2)
            pyramid.append(current - resize_bilinear(down,
                                                     *current.shape[-2:]))
            current = down
        else:
            pyramid.append(current)
    return pyramid


class LaplacianPyramidRefinement(nn.Module):
    def __init__(self, num_levels: int = 3, channels: int = 32,
                 init_edge_strength: float = 0.15):
        super().__init__()
        self.num_levels = num_levels
        self.edge_refiners = nn.ModuleList(EdgeRefineBlock(3, channels)
                                           for _ in range(num_levels))
        self.fusion = nn.Sequential(
            nn.Conv2d(channels * num_levels, channels, 3, 1, 1), nn.GELU(),
            nn.Conv2d(channels, 3, 3, 1, 1))
        self.edge_gate = nn.Sequential(
            nn.Conv2d(6, 16, 3, 1, 1), nn.GELU(), nn.Conv2d(16, 1, 3, 1, 1),
            nn.Sigmoid())
        self.level_weights = nn.Parameter(torch.full((num_levels,),
                                                     1.0 / num_levels))
        self.edge_strength = nn.Parameter(torch.tensor(init_edge_strength))

    def forward(self, sr: torch.Tensor) -> torch.Tensor:
        h, w = sr.shape[-2:]
        lw = torch.softmax(self.level_weights, 0)
        if common.gate("FREQFUSION_EDGE") and self.num_levels == 3:
            return self._fused(sr.contiguous(), lw)
        feats = [resize_bilinear(refine(lap), h, w) * lw[i]
                 for i, (refine, lap) in enumerate(zip(
                     self.edge_refiners,
                     build_laplacian_pyramid(sr, self.num_levels)))]
        edge_map = self.fusion(torch.cat(feats, 1))
        gate = self.edge_gate(torch.cat([sr, edge_map], 1))
        return (sr + gate * self.edge_strength * edge_map).clamp(0.0, 1.0)

    def _fused(self, sr: torch.Tensor, lw: torch.Tensor) -> torch.Tensor:
        """The gated route: NCHW tensors handed to the kernels as NHWC
        views (no copies)."""
        h, w = sr.shape[-2:]
        feats = []
        for refine, lap in zip(self.edge_refiners,
                               build_laplacian_pyramid(sr, 3)):
            f = edge_refine_fused(lap.contiguous().permute(0, 2, 3, 1),
                                  refine.fused_params()).permute(0, 3, 1, 2)
            feats.append(resize_bilinear(f, h, w).permute(0, 2, 3, 1))
        out = edge_fuse_fused(sr.permute(0, 2, 3, 1), *feats, lw,
                              self.edge_strength, self.fuse_params())
        return out.permute(0, 3, 1, 2)

    def fuse_params(self) -> dict:
        """The fusion and edge gate as the flax tree ``ops/edge.py``'s fuse
        takes, the kernels as views."""
        return {"fusion_0": _hwio_view(self.fusion[0]),
                "fusion_2": _hwio_view(self.fusion[2]),
                "edge_gate_0": _hwio_view(self.edge_gate[0]),
                "edge_gate_2": _hwio_view(self.edge_gate[2])}
