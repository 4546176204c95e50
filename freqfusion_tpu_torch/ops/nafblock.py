"""A whole NAFBlock: the CUDA kernels and the plain version.

Counterpart of ``freqfusion_tpu/ops/pallas_nafblock.py:nafblock_fused``,
with its argument layout: x [B, H, W, C] and ``w`` the flax NAFBlock tree,
here as tensors: norm1/norm2 {scale, bias} [C]; conv1/conv4 kernels
[1, 1, C, 2C], conv3/conv5/sca kernels [1, 1, C, C] (each with its bias);
conv2 (depthwise) kernel [3, 3, 1, 2C] and bias [2C]; beta, gamma [C].

    g   = SimpleGate(dw3x3(conv1(LN1(x))))          LN eps 1e-6
    y   = x + beta * conv3(g * sca(mean_hw(g)))
    out = y + gamma * conv5(SimpleGate(conv4(LN2(y))))

The kernels read each 1x1 kernel's [C, N] matrix as it lies in the tree,
so no packed copy of the weights is made (the TPU wrapper's
``pack_nafblock_weights`` splits the gate halves for its lane layout; the
CUDA gate kernel reads both halves of the [.., 2C] rows instead). A CPU
tensor goes to the plain version; a CUDA tensor goes to
``csrc/nafblock.cu`` (pass A: conv1 and the gate with the SCA pool's
per-tile sums; the [B, C] SCA product in PyTorch; pass B: conv3, the beta
residual and the FFN half) or the call raises. Every H and W is taken by
the kernels: there is no XLA-style fallback for small shapes.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from . import cuda

__all__ = ["nafblock_fused", "nafblock_fused_reference"]

EPS = 1e-6


def _mat(w: Dict[str, Any], name: str) -> torch.Tensor:
    return w[name]["kernel"][0, 0]


def nafblock_fused_reference(x: torch.Tensor, w: Dict[str, Any]
                             ) -> torch.Tensor:
    """Plain PyTorch version of :func:`nafblock_fused`."""
    c = x.shape[-1]
    xn = F.layer_norm(x, (c,), w["norm1"]["scale"], w["norm1"]["bias"], EPS)
    u = xn @ _mat(w, "conv1") + w["conv1"]["bias"]
    u = F.conv2d(u.permute(0, 3, 1, 2),
                 w["conv2"]["kernel"].permute(3, 2, 0, 1), w["conv2"]["bias"],
                 padding=1, groups=2 * c).permute(0, 2, 3, 1)
    g = u[..., :c] * u[..., c:]
    s = g.mean((1, 2)) @ _mat(w, "sca") + w["sca"]["bias"]
    x3 = (g * s[:, None, None, :]) @ _mat(w, "conv3") + w["conv3"]["bias"]
    y = x + x3 * w["beta"]
    t2 = F.layer_norm(y, (c,), w["norm2"]["scale"], w["norm2"]["bias"], EPS)
    u2 = t2 @ _mat(w, "conv4") + w["conv4"]["bias"]
    o = (u2[..., :c] * u2[..., c:]) @ _mat(w, "conv5") + w["conv5"]["bias"]
    return y + o * w["gamma"]


def nafblock_fused(x: torch.Tensor, w: Dict[str, Any]) -> torch.Tensor:
    """One NAFBlock (dw_expand = ffn_expand = 2). x [B, H, W, C]; w the
    tree above. Returns [B, H, W, C]."""
    if x.device.type == "cpu":
        return nafblock_fused_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"nafblock_fused: unsupported device {x.device}")
    b, h, w_, c = x.shape
    dev = x.device
    cuda.require(x, "x", (b, h, w_, c), dev)
    mats = {n: _mat(w, n) for n in ("conv1", "conv3", "conv4", "conv5", "sca")}
    for n, m in mats.items():
        cuda.require(m, n, (c, 2 * c if n in ("conv1", "conv4") else c), dev)
        cuda.require(w[n]["bias"], f"{n} bias", (m.shape[1],), dev)
    cuda.require(w["conv2"]["kernel"], "conv2", (3, 3, 1, 2 * c), dev)
    cuda.require(w["conv2"]["bias"], "conv2 bias", (2 * c,), dev)
    vecs = (w["norm1"]["scale"], w["norm1"]["bias"], w["norm2"]["scale"],
            w["norm2"]["bias"], w["beta"], w["gamma"])
    for i, v in enumerate(vecs):
        cuda.require(v, f"vector {i}", (c,), dev)
    lib = cuda.library()
    stream = cuda.stream(x)
    tiles = lib.ff_nafblock_tiles(h, w_)
    u = torch.empty(b, h, w_, 2 * c, device=dev, dtype=torch.float32)
    g = torch.empty_like(x)
    partials = torch.empty(b, tiles, c, device=dev, dtype=torch.float32)
    err = lib.ff_nafblock_gate(
        *(cuda.ptr(t) for t in (
            x, w["norm1"]["scale"], w["norm1"]["bias"], mats["conv1"],
            w["conv1"]["bias"], u, w["conv2"]["kernel"], w["conv2"]["bias"],
            g, partials)),
        b, h, w_, c, EPS, stream)
    cuda.check(err, "nafblock_fused (gate)")
    s = (partials.sum(1) / (h * w_) @ mats["sca"] + w["sca"]["bias"]
         ).contiguous()
    del u
    y, g2, out = (torch.empty_like(x) for _ in range(3))
    err = lib.ff_nafblock_apply(
        *(cuda.ptr(t) for t in (
            g, s, x, mats["conv3"], w["conv3"]["bias"], w["beta"], y,
            w["norm2"]["scale"], w["norm2"]["bias"], mats["conv4"],
            w["conv4"]["bias"], g2, mats["conv5"], w["conv5"]["bias"],
            w["gamma"], out)),
        b, h, w_, c, EPS, stream)
    cuda.check(err, "nafblock_fused (apply)")
    cuda.launch_counts["nafblock_fused"] += 1
    return out
