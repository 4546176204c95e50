"""The x4 FreqFusionSR pipeline: four frozen experts + the fusion net.

Counterpart of ``freqfusion_tpu/models/pipeline.py``: reflect-pad the LR
image to a multiple of 16, run DRCT-L, GRL-B, NAFNet-SIDD-64 and MambaIR,
crop the SR outputs to 4x the original size and the features to the
original LR size (NAFNet's HR feature is resized down bilinearly), clamp
MambaIR's output, and run the fusion net on the unpadded LR. A missing
expert degrades to the bilinear image and zero features. With
``expert_dtype=torch.bfloat16`` the experts run in bf16 (their floating
parameters cast once, the padded LR cast before them), as the JAX
pipeline's ``expert_dtype``. With ``fusion_dtype=torch.bfloat16`` the
fusion net runs in bf16, as the JAX pipeline's ``fusion_dtype`` (its
bench mode, ``bench.py:bench_full``): its floating parameters and buffers
(BN running statistics and the scalar parameters too) cast once, the
experts' outputs and features cast to it before the crops and NAFNet's
feature resize, the bilinear fallbacks and zero features made in it, the
LR cast to it before the fusion net and the result cast back to fp32.
Without it the experts' outputs are cast back to fp32 and the fusion net
runs in fp32. No variable sets ``fusion_dtype``: as in the JAX package,
only the constructor takes it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.pad import pad_reflect
from ..ops.resize import resize_bilinear
from .drct import DRCT
from .fusion.fusion_v2 import EXPERT_ORDER, CompleteEnhancedFusionSR
from .fusion.lka import FEATURE_CHANNELS
from .grl import GRL
from .mambair import MambaIR
from .nafnet import NAFNetSR

__all__ = ["FreqFusionPipeline", "build_expert_models", "EXPERT_ORDER",
           "FEATURE_CHANNELS", "GRL_DEPTHS"]

GRL_DEPTHS = (4, 4, 8, 8, 8, 4, 4)


def expert_configs(scale: int = 4) -> Dict[str, dict]:
    """The challenge configurations of the four experts."""
    return {
        "drct": dict(upscale=scale, embed_dim=180, num_layers=12,
                     num_heads=6, window_size=16),
        "grl": dict(upscale=scale, embed_dim=180, depths=GRL_DEPTHS,
                    num_heads_w=3, num_heads_s=3, window_size=8),
        "nafnet": dict(upscale=scale, width=64, middle_blk_num=12,
                       enc_blk_nums=(2, 2, 4, 8), dec_blk_nums=(2, 2, 2, 2)),
        "mamba": dict(upscale=scale, embed_dim=180, depths=(6,) * 6,
                      mlp_ratio=2.0),
    }


_CLASSES = {"drct": DRCT, "grl": GRL, "nafnet": NAFNetSR, "mamba": MambaIR}


def build_expert_models(scale: int = 4,
                        overrides: Optional[Dict[str, dict]] = None,
                        generator: Optional[torch.Generator] = None,
                        names=EXPERT_ORDER) -> Dict[str, nn.Module]:
    """The experts in their challenge configurations (``overrides`` updates
    a config per expert), initialised from `generator`."""
    cfg = expert_configs(scale)
    for name, kw in (overrides or {}).items():
        cfg[name].update(kw)
    return {n: _CLASSES[n](**cfg[n], generator=generator) for n in names}


class FreqFusionPipeline(nn.Module):
    """lr [B, 3, H, W] in [0, 1] -> SR [B, 3, 4H, 4W], fp32.
    ``expert_dtype`` casts the experts' floating parameters in place,
    once; ``fusion_dtype`` the fusion net's (parameters and buffers)."""

    def __init__(self, experts: Dict[str, nn.Module],
                 fusion: CompleteEnhancedFusionSR, scale: int = 4,
                 expert_dtype: Optional[torch.dtype] = None,
                 fusion_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if expert_dtype is not None:
            for model in experts.values():
                model.to(expert_dtype)
        if fusion_dtype is not None:
            fusion.to(fusion_dtype)
        self.experts = nn.ModuleDict(experts)
        self.fusion = fusion
        self.scale = scale
        self.expert_dtype = expert_dtype
        self.fusion_dtype = fusion_dtype

    @property
    def _fdt(self) -> torch.dtype:
        return self.fusion_dtype or torch.float32

    def run_experts(self, lr_padded: torch.Tensor
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Expert outputs and features on a padded LR batch, in
        ``fusion_dtype`` (fp32 without one), cast from ``expert_dtype``."""
        imgs, feats = {}, {}
        x = (lr_padded if self.expert_dtype is None
             else lr_padded.to(self.expert_dtype))
        for name in EXPERT_ORDER:
            if name in self.experts:
                sr, feat = self.experts[name](x)
                sr, feat = sr.to(self._fdt), feat.to(self._fdt)
                imgs[name] = sr.clamp(0.0, 1.0) if name == "mamba" else sr
                feats[name] = feat
        return imgs, feats

    def forward(self, lr: torch.Tensor) -> torch.Tensor:
        b, _, h, w = lr.shape
        s, fdt = self.scale, self._fdt
        ph, pw = (16 - h % 16) % 16, (16 - w % 16) % 16
        lr_padded = pad_reflect(lr, 0, ph, 0, pw)
        imgs, feats = self.run_experts(lr_padded)
        hp, wp = lr_padded.shape[-2:]
        for name in EXPERT_ORDER:
            if name in imgs:
                imgs[name] = imgs[name][..., :h * s, :w * s]
                f = feats[name]
                feats[name] = (resize_bilinear(f, h, w)
                               if f.shape[-2:] != (hp, wp) else f[..., :h, :w])
            else:
                imgs[name] = resize_bilinear(lr, h * s, w * s).to(fdt)
                feats[name] = lr.new_zeros(b, FEATURE_CHANNELS[name], h, w,
                                           dtype=fdt)
        return self.fusion(lr.to(fdt), imgs, feats).float()
