"""Resizing with PyTorch's interpolate semantics on NCHW tensors.

``freqfusion_tpu/ops/resize.py`` rebuilds F.interpolate (half-pixel
centres, no antialias, bicubic a = -0.75) as matmuls for the TPU; here it
is F.interpolate itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["resize_bilinear", "upscale_bicubic"]


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if x.shape[-2:] == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


def upscale_bicubic(x: torch.Tensor, scale: int) -> torch.Tensor:
    return F.interpolate(x, size=(x.shape[-2] * scale, x.shape[-1] * scale),
                         mode="bicubic", align_corners=False)
