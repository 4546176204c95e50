"""The 7-phase fusion network (eval), NCHW.

Counterpart of ``freqfusion_tpu/models/fusion/fusion_v2.py``: frequency
decomposition, cross-band attention, collaborative expert attention,
hierarchical + frequency-guided fusion, per-pixel difficulty gating, CNN
refinement, Laplacian edge enhancement and a bilinear LR residual, over
explicit expert outputs and features. Expert order is pinned to
``EXPERT_ORDER``. GELU is the exact (erf) form everywhere.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ...ops.resize import resize_bilinear
from ..common import init_weights
from .edge import LaplacianPyramidRefinement
from .frequency import MultiDomainFrequencyDecomposition
from .hierarchical import HierarchicalMultiResolutionFusion
from .lka import EnhancedCollaborativeWithLKA, EnhancedCrossBandWithLKA

__all__ = ["DynamicExpertSelector", "CompleteEnhancedFusionSR", "EXPERT_ORDER"]

EXPERT_ORDER = ("drct", "grl", "nafnet", "mamba")


def _head(out_ch: int, out_kernel: int, hidden: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(3, hidden, 3, 1, 1), nn.ReLU(),
        nn.Conv2d(hidden, hidden, 3, 1, 1), nn.ReLU(),
        nn.Conv2d(hidden, out_ch, out_kernel, 1, out_kernel // 2))


class DynamicExpertSelector(nn.Module):
    """Per-pixel difficulty + adaptive-threshold expert gates."""

    def __init__(self, hidden_dim: int = 32, num_experts: int = 4):
        super().__init__()
        self.difficulty_net = _head(1, 3, hidden_dim)
        self.gate_net = _head(num_experts, 1, hidden_dim)
        self.temperature = nn.Parameter(torch.tensor(10.0))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        difficulty = torch.sigmoid(self.difficulty_net(x))
        gates = torch.sigmoid(self.temperature
                              * (self.gate_net(x) - (0.7 - 0.5 * difficulty)))
        gate_sum = gates.sum(1, keepdim=True) + 1e-8
        return gates / torch.clamp(gate_sum, min=0.3), difficulty


class CompleteEnhancedFusionSR(nn.Module):
    def __init__(self, num_experts: int = 4, fusion_dim: int = 128,
                 refine_channels: int = 128, refine_depth: int = 6,
                 base_channels: int = 64, block_size: int = 8,
                 upscale: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.names = EXPERT_ORDER[:num_experts]
        self.upscale = upscale
        self.freq_decomp = MultiDomainFrequencyDecomposition(block_size)
        self.cross_band = EnhancedCrossBandWithLKA(64, 4, 21)
        self.collaborative = EnhancedCollaborativeWithLKA(
            num_experts, fusion_dim, 8, 21)
        self.multi_res = HierarchicalMultiResolutionFusion(num_experts,
                                                           base_channels)
        self.freq_weight_conv = nn.Sequential(
            nn.Conv2d(3, 16, 1), nn.GELU(), nn.Conv2d(16, num_experts, 1))
        self.dynamic_selector = DynamicExpertSelector(32, num_experts)
        refine = [nn.Conv2d(3, refine_channels, 3, 1, 1), nn.GELU()]
        for _ in range(refine_depth - 2):
            refine += [nn.Conv2d(refine_channels, refine_channels, 3, 1, 1),
                       nn.GELU()]
        refine.append(nn.Conv2d(refine_channels, 3, 3, 1, 1))
        self.refine = nn.Sequential(*refine)
        self.edge_enhance = LaplacianPyramidRefinement(3, 32, 0.15)
        self.residual_scale = nn.Parameter(torch.tensor(0.1))
        init_weights(self, generator)

    def forward(self, lr: torch.Tensor, expert_imgs: Dict[str, torch.Tensor],
                expert_feats: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """lr [B, 3, H, W]; expert_imgs {name: [B, 3, 4H, 4W]};
        expert_feats {name: [B, C_name, H, W]}. Returns SR in [0, 1]."""
        h_hr, w_hr = lr.shape[-2] * self.upscale, lr.shape[-1] * self.upscale
        outputs = [expert_imgs[n] for n in self.names if n in expert_imgs]

        bands = self.cross_band(self.freq_decomp(lr))
        routing_lr = bands[0] + bands[1] + bands[2]

        if expert_feats is not None and all(n in expert_feats
                                            for n in self.names):
            outputs = self.collaborative(expert_feats, outputs)

        hierarchical = self.multi_res(dict(zip(self.names, outputs)))
        freq_w = torch.softmax(self.freq_weight_conv(
            resize_bilinear(routing_lr, h_hr, w_hr)), dim=1)
        freq_fused = sum(o * freq_w[:, i:i + 1] for i, o in enumerate(outputs))
        fused = hierarchical * 0.7 + freq_fused * 0.3

        gates, difficulty = self.dynamic_selector(routing_lr)
        gates_hr = resize_bilinear(gates, h_hr, w_hr)
        gated = sum(o * gates_hr[:, i:i + 1] for i, o in enumerate(outputs))
        dynamic = gated / (gates_hr.sum(1, keepdim=True) + 1e-8)
        blend = 0.3 + 0.4 * resize_bilinear(difficulty, h_hr, w_hr)
        fused = (1.0 - blend) * fused + blend * dynamic

        fused = self.edge_enhance(fused + 0.1 * self.refine(fused))
        sr = fused + self.residual_scale * resize_bilinear(lr, h_hr, w_hr)
        return sr.clamp(0.0, 1.0)
