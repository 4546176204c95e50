"""Depthwise 3x3 convolution over NHWC: the CUDA kernel and its plain version.

Counterpart of ``freqfusion_tpu/ops/pallas_dwconv.py:dwconv3x3_pallas``,
with its argument layout: x [B, H, W, C], kernel [3, 3, 1, C] (HWIO with
one input channel per group), bias [C]; zero padding, stride 1. A CPU
tensor goes to the plain version (nine shifted multiply-adds); a CUDA
tensor goes to ``csrc/dwconv.cu``, which reads NHWC directly, or the call
raises. The kernel takes every shape itself: there is no library fallback
for small ones. bf16 tensors (the bf16 expert mode) go to the bf16 plain
version or to the kernel's bf16 instantiation: fp32 taps and sums, the
output rounded once, as the JAX kernel rounds it; counted as
``dwconv3x3.bf16``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda

__all__ = ["dwconv3x3", "dwconv3x3_reference"]


def dwconv3x3_reference(x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`dwconv3x3` (for bf16 operands in
    fp32, rounded once)."""
    if x.dtype == torch.bfloat16:
        return dwconv3x3_reference(x.float(), kernel.float(),
                                   bias.float()).to(torch.bfloat16)
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
    b, h, w, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    dev, dtype = x.device, torch.bfloat16 if bf16 else torch.float32
    cuda.require(x, "x", (b, h, w, c), dev, dtype)
    cuda.require(kernel, "kernel", (3, 3, 1, c), dev, dtype)
    cuda.require(bias, "bias", (c,), dev, dtype)
    out = torch.empty_like(x)
    lib = cuda.library()
    err = (lib.ff_dwconv3x3_bf16 if bf16 else lib.ff_dwconv3x3)(
        *(cuda.ptr(t) for t in (x, kernel, bias, out)), b, h, w, c,
        cuda.stream(x))
    name = "dwconv3x3.bf16" if bf16 else "dwconv3x3"
    cuda.check(err, name)
    cuda.launch_counts[name] += 1
    return out
