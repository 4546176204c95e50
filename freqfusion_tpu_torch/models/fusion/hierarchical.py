"""Phase 5a: hierarchical multi-resolution fusion (HR/4 -> HR/2 -> HR).

Counterpart of ``freqfusion_tpu/models/fusion/hierarchical.py`` (NCHW):
each stage is conv-GELU-conv-GELU -> spatial gate -> residual block over
the concatenated expert RGBs, with learnable cross-stage weights (0.2).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ...ops.resize import resize_bilinear

__all__ = ["SpatialGate", "FusionResBlock", "HierarchicalMultiResolutionFusion"]


class SpatialGate(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.gate = nn.Sequential(nn.Conv2d(c, c // 4, 1), nn.GELU(),
                                  nn.Conv2d(c // 4, 1, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gate(x)


class FusionResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block = nn.Sequential(nn.Conv2d(c, c, 3, 1, 1, bias=False),
                                   nn.GELU(),
                                   nn.Conv2d(c, c, 3, 1, 1, bias=False))
        self.scale = nn.Parameter(torch.tensor(0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.scale * self.block(x)


def _conv_pair(cin: int, c1: int, c2: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, c1, 3, 1, 1), nn.GELU(),
                         nn.Conv2d(c1, c2, 3, 1, 1), nn.GELU())


class HierarchicalMultiResolutionFusion(nn.Module):
    def __init__(self, num_experts: int = 4, base_channels: int = 64):
        super().__init__()
        bc, cin = base_channels, 3 * num_experts
        self.stage1_conv = _conv_pair(cin, bc, bc)
        self.stage1_gate = SpatialGate(bc)
        self.stage1_res = FusionResBlock(bc)
        self.stage2_conv = _conv_pair(bc + cin, bc, bc)
        self.stage2_gate = SpatialGate(bc)
        self.stage2_res = FusionResBlock(bc)
        self.stage3_conv = _conv_pair(bc + cin, bc, bc // 2)
        self.stage3_gate = SpatialGate(bc // 2)
        self.stage3_res = FusionResBlock(bc // 2)
        self.to_rgb = nn.Sequential(nn.Conv2d(bc // 2, bc // 4, 3, 1, 1),
                                    nn.GELU(), nn.Conv2d(bc // 4, 3, 3, 1, 1),
                                    nn.Sigmoid())
        self.residual_weight_1_2 = nn.Parameter(torch.tensor(0.2))
        self.residual_weight_2_3 = nn.Parameter(torch.tensor(0.2))
        self.half = bc // 2

    def forward(self, expert_outputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        stack = torch.cat(list(expert_outputs.values()), dim=1)
        h, w = stack.shape[-2:]
        f1 = self.stage1_res(self.stage1_gate(self.stage1_conv(
            resize_bilinear(stack, max(h // 4, 1), max(w // 4, 1)))))
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        f1_up = resize_bilinear(f1, h2, w2)
        f2 = self.stage2_res(self.stage2_gate(self.stage2_conv(
            torch.cat([f1_up, resize_bilinear(stack, h2, w2)], 1))))
        f2 = f2 + self.residual_weight_1_2 * f1_up
        f2_up = resize_bilinear(f2, h, w)
        f3 = self.stage3_res(self.stage3_gate(self.stage3_conv(
            torch.cat([f2_up, stack], 1))))
        f3 = f3 + self.residual_weight_2_3 * f2_up[:, :self.half]
        return self.to_rgb(f3)
