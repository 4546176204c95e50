"""Resizing with PyTorch's interpolate semantics on NCHW tensors.

``freqfusion_tpu/ops/resize.py`` rebuilds F.interpolate (half-pixel
centres, no antialias, bicubic a = -0.75) as matmuls for the TPU; here it
is F.interpolate itself. On a bf16 tensor the JAX resize runs one axis at
a time, rows then columns, each product summed in fp32 and rounded to
bf16; :func:`resize_bilinear` does the same with one F.interpolate an
axis. The JAX matrices are rounded to bf16 too, F.interpolate's weights
are not: they agree where the weights are exact in bf16 (the pipeline's
x4 and /4 resizes of whole 16-multiple images: 1/8 steps and halves).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["resize_bilinear", "upscale_bicubic"]


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if x.shape[-2:] == (h, w):
        return x
    if x.dtype == torch.bfloat16:
        if x.shape[-2] != h:
            x = F.interpolate(x, size=(h, x.shape[-1]), mode="bilinear",
                              align_corners=False)
        if x.shape[-1] != w:
            x = F.interpolate(x, size=(h, w), mode="bilinear",
                              align_corners=False)
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


def upscale_bicubic(x: torch.Tensor, scale: int) -> torch.Tensor:
    return F.interpolate(x, size=(x.shape[-2] * scale, x.shape[-1] * scale),
                         mode="bicubic", align_corners=False)
