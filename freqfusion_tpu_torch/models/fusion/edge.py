"""Phase 7b: Laplacian-pyramid edge refinement.

Counterpart of ``freqfusion_tpu/models/fusion/edge.py`` (NCHW): a 3-level
pyramid (5x5 Gaussian, sigma 1.5, zero padded; 2x2 average pool), one
residual refiner with spatial attention per level, softmax level weights,
a fusion conv to an edge map and a per-pixel gate scaled by a learnable
edge strength (0.15). Output clamped to [0, 1].
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_bilinear
from ...ops.window_attention import device_table

__all__ = ["EdgeRefineBlock", "LaplacianPyramidRefinement",
           "gaussian_blur_5x5"]


def _gaussian_kernel_np(kernel_size: int = 5, sigma: float = 1.5
                        ) -> np.ndarray:
    coords = np.arange(kernel_size, dtype=np.float32) - kernel_size // 2
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def gaussian_blur_5x5(x: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    k = device_table(_gaussian_kernel_np, 5, 1.5, device=x.device)
    return F.conv2d(x, k.view(1, 1, 5, 5).expand(c, 1, 5, 5), padding=2,
                    groups=c)


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
        feats = [resize_bilinear(refine(lap), h, w) * lw[i]
                 for i, (refine, lap) in enumerate(zip(
                     self.edge_refiners,
                     build_laplacian_pyramid(sr, self.num_levels)))]
        edge_map = self.fusion(torch.cat(feats, 1))
        gate = self.edge_gate(torch.cat([sr, edge_map], 1))
        return (sr + gate * self.edge_strength * edge_map).clamp(0.0, 1.0)
