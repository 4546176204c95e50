"""Laplacian edge refinement, per level and fused: the CUDA kernels and the
plain versions.

Counterparts of ``freqfusion_tpu/ops/pallas_edge.py:edge_refine_fused``
and ``edge_fuse_fused``, with their argument layouts (tensors NHWC, conv
kernels [kh, kw, Cin, Cout], HWIO):

- ``edge_refine_fused(lap, p)``: one EdgeRefineBlock over a Laplacian
  level lap [B, H, W, 3], p {proj, conv1, conv2, conv3, attn_0, attn_2}:

      hid = conv3(gelu(conv2(gelu(conv1(lap))))) + proj(lap)
      out = hid * sigmoid(attn_2(gelu(attn_0(hid))))        [B, H, W, 32]

- ``edge_fuse_fused(sr, f0, f1, f2, lw, strength, p)``: the three refined
  levels at HR (unweighted), the softmaxed level weights lw [3], the edge
  strength, p {fusion_0, fusion_2, edge_gate_0, edge_gate_2}:

      edge = fusion_2(gelu(fusion_0(cat(lw0 f0, lw1 f1, lw2 f2))))
      gate = sigmoid(edge_gate_2(gelu(edge_gate_0(cat(sr, edge)))))
      out  = clip(sr + gate * strength * edge, 0, 1)          [B, H, W, 3]

GELU is exact (erf); the convolutions zero-pad. A CPU tensor goes to the
plain version; a CUDA tensor goes to ``csrc/edge.cu`` or the call raises.
The CUDA route takes its image inputs NHWC-contiguous or as
NCHW-contiguous tensors viewed as NHWC (``u.permute(0, 2, 3, 1)``, no
copy), all in one layout, and returns its output in that layout. Unlike
the JAX wrappers, the kernels take every H and W themselves: there is no
XLA fallback.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from . import cuda
from .hier import conv3x3, dense1x1

__all__ = ["edge_refine_fused", "edge_refine_fused_reference",
           "edge_fuse_fused", "edge_fuse_fused_reference"]


def edge_refine_fused_reference(lap: torch.Tensor, p: Dict[str, Any]
                                ) -> torch.Tensor:
    """Plain PyTorch version of :func:`edge_refine_fused` (the JAX
    package's ``_refine_xla``)."""
    t = F.gelu(conv3x3(F.gelu(conv3x3(lap, p["conv1"])), p["conv2"]))
    t = conv3x3(t, p["conv3"]) + dense1x1(lap, p["proj"])
    a = conv3x3(F.gelu(dense1x1(t, p["attn_0"])), p["attn_2"])
    return t * torch.sigmoid(a)


def edge_refine_fused(lap: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    """lap [B, H, W, Cin]; p the tree above (F = conv1's outputs, F / 4 =
    8). Returns [B, H, W, F]."""
    if lap.device.type == "cpu":
        return edge_refine_fused_reference(lap, p)
    if lap.device.type != "cuda":
        raise ValueError(f"edge_refine_fused: unsupported device {lap.device}")
    b, h, w, cin = lap.shape
    f = p["conv1"]["kernel"].shape[-1]
    if f != 32:
        raise ValueError(f"edge_refine_fused: {f} features, expected 32 "
                         "(the attention's squeeze must be 8 wide)")
    dev = lap.device
    nchw = cuda.nhwc_layout(lap)
    cuda.require_layout(lap, "lap", (b, h, w, cin), dev, nchw)
    # conv3 and the 1x1 projection as one conv over cat(h, lap): the
    # projection's weights at the centre tap, zeros around it
    proj = torch.zeros(3, 3, cin, f, device=dev)
    proj[1, 1] = p["proj"]["kernel"][0, 0]
    w3p = torch.cat([p["conv3"]["kernel"], proj], 2)
    b3p = p["conv3"]["bias"] + p["proj"]["bias"]
    tensors = [
        ("conv1", p["conv1"]["kernel"], (3, 3, cin, f)),
        ("conv1 bias", p["conv1"]["bias"], (f,)),
        ("conv2", p["conv2"]["kernel"], (3, 3, f, f)),
        ("conv2 bias", p["conv2"]["bias"], (f,)),
        ("conv3 + proj", w3p, (3, 3, f + cin, f)),
        ("conv3 + proj bias", b3p, (f,)),
        ("attn_0", p["attn_0"]["kernel"][0, 0], (f, f // 4)),
        ("attn_0 bias", p["attn_0"]["bias"], (f // 4,)),
        ("attn_2", p["attn_2"]["kernel"], (3, 3, f // 4, 1)),
        ("attn_2 bias", p["attn_2"]["bias"], (1,))]
    for name, t, shape in tensors:
        cuda.require(t, name, shape, dev)
    t1 = torch.empty(b, h, w, f, device=dev)
    t2 = torch.empty(b, h, w, f, device=dev)
    out = cuda.empty_nhwc(b, h, w, f, nchw, dev)
    err = cuda.library().ff_edge_refine(
        lap.data_ptr(), nchw, *(t.data_ptr() for _, t, _ in tensors),
        t1.data_ptr(), t2.data_ptr(), out.data_ptr(), b, h, w, cin, f,
        cuda.stream(lap))
    cuda.check(err, "edge_refine_fused")
    cuda.launch_counts["edge_refine_fused"] += 1
    return out


def edge_fuse_fused_reference(sr, f0, f1, f2, lw, strength,
                              p: Dict[str, Any]) -> torch.Tensor:
    """Plain PyTorch version of :func:`edge_fuse_fused` (the JAX package's
    ``_fuse_xla``)."""
    allf = torch.cat([f0 * lw[0], f1 * lw[1], f2 * lw[2]], -1)
    edge = conv3x3(F.gelu(conv3x3(allf, p["fusion_0"])), p["fusion_2"])
    g = conv3x3(torch.cat([sr, edge], -1), p["edge_gate_0"])
    gate = torch.sigmoid(conv3x3(F.gelu(g), p["edge_gate_2"]))
    return torch.clamp(sr + gate * strength * edge, 0.0, 1.0)


def edge_fuse_fused(sr: torch.Tensor, f0: torch.Tensor, f1: torch.Tensor,
                    f2: torch.Tensor, lw: torch.Tensor,
                    strength: torch.Tensor, p: Dict[str, Any]
                    ) -> torch.Tensor:
    """sr [B, H, W, 3]; f0, f1, f2 [B, H, W, F]; lw [3]; strength a
    scalar tensor; p the tree above. Returns [B, H, W, 3]."""
    if sr.device.type == "cpu":
        return edge_fuse_fused_reference(sr, f0, f1, f2, lw, strength, p)
    if sr.device.type != "cuda":
        raise ValueError(f"edge_fuse_fused: unsupported device {sr.device}")
    b, h, w, _ = sr.shape
    f = f0.shape[-1]
    if f > 64:
        raise ValueError(f"edge_fuse_fused: {f} features > 64")
    dev = sr.device
    nchw = cuda.nhwc_layout(sr)
    cuda.require_layout(sr, "sr", (b, h, w, 3), dev, nchw)
    for name, t in (("f0", f0), ("f1", f1), ("f2", f2)):
        cuda.require_layout(t, name, (b, h, w, f), dev, nchw)
    cuda.require(lw, "lw", (3,), dev)
    # each level's weight folded into its input channels' weights
    wf0 = p["fusion_0"]["kernel"] * lw.repeat_interleave(f)[:, None]
    tensors = [
        ("strength", strength, ()),
        ("fusion_0", wf0, (3, 3, 3 * f, f)),
        ("fusion_0 bias", p["fusion_0"]["bias"], (f,)),
        ("fusion_2", p["fusion_2"]["kernel"], (3, 3, f, 3)),
        ("fusion_2 bias", p["fusion_2"]["bias"], (3,)),
        ("edge_gate_0", p["edge_gate_0"]["kernel"], (3, 3, 6, 16)),
        ("edge_gate_0 bias", p["edge_gate_0"]["bias"], (16,)),
        ("edge_gate_2", p["edge_gate_2"]["kernel"], (3, 3, 16, 1)),
        ("edge_gate_2 bias", p["edge_gate_2"]["bias"], (1,))]
    for name, t, shape in tensors:
        cuda.require(t, name, shape, dev)
    e1 = torch.empty(b, h, w, f, device=dev)
    e = torch.empty(b, h, w, 3, device=dev)
    g = torch.empty(b, h, w, 16, device=dev)
    out = cuda.empty_nhwc(b, h, w, 3, nchw, dev)
    err = cuda.library().ff_edge_fuse(
        *(t.data_ptr() for t in (sr, f0, f1, f2)), nchw,
        *(t.data_ptr() for _, t, _ in tensors), e1.data_ptr(), e.data_ptr(),
        g.data_ptr(), out.data_ptr(), b, h, w, f, cuda.stream(sr))
    cuda.check(err, "edge_fuse_fused")
    cuda.launch_counts["edge_fuse_fused"] += 1
    return out
