"""Depthwise 3x3 convolution over NHWC: the CUDA kernel and its plain version.

Counterpart of ``freqfusion_tpu/ops/pallas_dwconv.py:dwconv3x3_pallas``,
with its argument layout: x [B, H, W, C], kernel [3, 3, 1, C] (HWIO with
one input channel per group), bias [C]; zero padding, stride 1. A CPU
tensor goes to the plain version (nine shifted multiply-adds); a CUDA
tensor goes to ``csrc/dwconv.cu``, which reads NHWC directly, or the call
raises. The kernel takes every shape itself: there is no library fallback
for small ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda

__all__ = ["dwconv3x3", "dwconv3x3_reference"]


def dwconv3x3_reference(x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`dwconv3x3`."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = bias.expand_as(x).clone()
    for dy in range(3):
        for dx in range(3):
            out = out + xp[:, dy:dy + h, dx:dx + w] * kernel[dy, dx, 0]
    return out


def dwconv3x3(x: torch.Tensor, kernel: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C]; kernel [3, 3, 1, C]; bias [C]. Returns [B, H, W, C]."""
    if x.device.type == "cpu":
        return dwconv3x3_reference(x, kernel, bias)
    if x.device.type != "cuda":
        raise ValueError(f"dwconv3x3: unsupported device {x.device}")
    cuda.fp32_only("dwconv3x3", x)
    b, h, w, c = x.shape
    dev = x.device
    cuda.require(x, "x", (b, h, w, c), dev)
    cuda.require(kernel, "kernel", (3, 3, 1, c), dev)
    cuda.require(bias, "bias", (c,), dev)
    out = torch.empty_like(x)
    err = cuda.library().ff_dwconv3x3(
        *(cuda.ptr(t) for t in (x, kernel, bias, out)), b, h, w, c,
        cuda.stream(x))
    cuda.check(err, "dwconv3x3")
    cuda.launch_counts["dwconv3x3"] += 1
    return out
