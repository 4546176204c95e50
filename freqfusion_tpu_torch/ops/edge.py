"""Laplacian edge refinement, per level and fused: the CUDA kernels and the
plain versions.

Counterparts of ``freqfusion_tpu/ops/pallas_edge.py:edge_refine_fused``
and ``edge_fuse_fused``, with their argument layouts (tensors NHWC, conv
kernels [kh, kw, Cin, Cout], HWIO, here of any strides: the modules hand
views of PyTorch's OIHW weights):

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
plain version; a CUDA tensor goes to ``csrc/edge.cu`` (each conv a 3xTF32
implicit GEMM on the tensor cores, ``csrc/conv3x3_tf32.cuh``, after one
launch that splits every conv's weights, folding in the projection and
the level weights) or the call raises. The CUDA route takes its image
inputs NHWC-contiguous or as NCHW-contiguous tensors viewed as NHWC
(``u.permute(0, 2, 3, 1)``, no copy), all in one layout, and returns its
output in that layout; the wrappers launch no PyTorch kernel. Unlike the
JAX wrappers, the kernels take every H and W themselves: there is no XLA
fallback.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import cuda
from .hier import CK, TILE_W, ConvPlan, conv3x3, conv_smem, dense1x1

__all__ = ["edge_refine_fused", "edge_refine_fused_reference",
           "edge_fuse_fused", "edge_fuse_fused_reference", "plan_edge",
           "EdgePlan"]

# csrc/edge.cu: (n-tiles a block, m-tiles a warp) of refine's conv1,
# conv2, conv3 (+ the projection) and attention conv, and of fuse's
# fusion_0, fusion_2, edge_gate_0 and edge_gate_2
REFINE_TILES = ((4, 3), (4, 3), (4, 3), (1, 4))
FUSE_TILES = ((4, 3), (1, 4), (2, 4), (1, 4))
GATE_HIDDEN = 16  # edge_gate_0's outputs


def _pad(c: int) -> int:
    return -(-c // CK) * CK


class EdgePlan(NamedTuple):
    """How ``csrc/edge.cu`` runs a refine or fuse call (its
    ``edge_plan``): each conv's plan, its sources' channels padded to CK
    one by one (a stage never mixes two tensors), and the scratch of split
    weights (18 cinp coutp floats a conv)."""
    convs: Tuple[ConvPlan, ...]
    sources: Tuple[Tuple[int, ...], ...]  # each conv's sources, padded
    scratch_floats: int


@functools.lru_cache(maxsize=64)
def plan_edge(h: int, w: int, cin: int = 3, f: int = 32,
              fuse: bool = False) -> EdgePlan:
    """The plan of refine on [B, h, w, cin] (conv1 cin -> f, conv2,
    conv3 over (h, lap): f + cin -> f, the attention conv f / 4 -> 1) or
    of fuse on [B, h, w, f] levels (fusion_0 over (f0, f1, f2), fusion_2
    f -> 3, edge_gate_0 over (sr, edge): 3 + 3 -> 16, edge_gate_2 16 ->
    1)."""
    if fuse:
        convs = (((f, f, f), f), ((f,), 3), ((3, 3), GATE_HIDDEN),
                 ((GATE_HIDDEN,), 1))
        tiles = FUSE_TILES
    else:
        convs = (((cin,), f), ((f,), f), ((f, cin), f), ((f // 4,), 1))
        tiles = REFINE_TILES
    plans, sources = [], []
    for (srcs, co), (nt, mt) in zip(convs, tiles):
        pads = tuple(_pad(c) for c in srcs)
        coutp = -(-co // (8 * nt)) * 8 * nt
        n_tiles = -(-h // (8 * mt)) * -(-w // TILE_W)
        plans.append(ConvPlan(sum(srcs), co, sum(pads), coutp, nt, mt,
                              n_tiles, n_tiles * coutp // (8 * nt),
                              conv_smem(nt, mt)))
        sources.append(pads)
    return EdgePlan(tuple(plans), tuple(sources),
                    sum(18 * c.cinp * c.coutp for c in plans))


def _weights(p: Dict[str, Any], convs, device) -> list:
    """The kernels' arguments for the convs named in `convs` (name, HWIO
    shape): each kernel's pointer and its four element strides, so a view
    (the modules hand PyTorch's OIHW weights permuted, no copy) goes as
    it is, then its bias's pointer."""
    args = []
    for name, shape in convs:
        k, b = p[name]["kernel"], p[name]["bias"]
        if k.device != device or k.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {device}")
        if tuple(k.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(k.shape)}, expected "
                             f"{shape}")
        cuda.require(b, f"{name} bias", shape[-1:], device)
        args += [k.data_ptr(), *k.stride(), b.data_ptr()]
    return args


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
    cuda.fp32_only("edge_refine_fused", lap)
    b, h, w, cin = lap.shape
    f = p["conv1"]["kernel"].shape[-1]
    if f != 32:
        raise ValueError(f"edge_refine_fused: {f} features, expected 32 "
                         "(the attention's squeeze must be 8 wide)")
    dev = lap.device
    nchw = cuda.nhwc_layout(lap)
    cuda.require_layout(lap, "lap", (b, h, w, cin), dev, nchw)
    args = _weights(p, [("conv1", (3, 3, cin, f)), ("conv2", (3, 3, f, f)),
                        ("conv3", (3, 3, f, f)), ("proj", (1, 1, cin, f)),
                        ("attn_0", (1, 1, f, f // 4)),
                        ("attn_2", (3, 3, f // 4, 1))], dev)
    plan = plan_edge(h, w, cin, f)
    t1 = torch.empty(b, h, w, f + f // 4, device=dev)
    t2 = torch.empty(b, h, w, f, device=dev)
    scratch = torch.empty(plan.scratch_floats, device=dev)
    out = cuda.empty_nhwc(b, h, w, f, nchw, dev)
    err = cuda.library().ff_edge_refine(
        lap.data_ptr(), nchw, *args, t1.data_ptr(), t2.data_ptr(),
        scratch.data_ptr(), plan.scratch_floats, out.data_ptr(), b, h, w,
        cin, f, cuda.stream(lap))
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
    cuda.fp32_only("edge_fuse_fused", sr)
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
    cuda.require(strength, "strength", (), dev)
    args = _weights(p, [("fusion_0", (3, 3, 3 * f, f)),
                        ("fusion_2", (3, 3, f, 3)),
                        ("edge_gate_0", (3, 3, 6, GATE_HIDDEN)),
                        ("edge_gate_2", (3, 3, GATE_HIDDEN, 1))], dev)
    plan = plan_edge(h, w, 3, f, fuse=True)
    e1 = torch.empty(b, h, w, f, device=dev)
    e = torch.empty(b, h, w, 3, device=dev)
    g = torch.empty(b, h, w, GATE_HIDDEN, device=dev)
    scratch = torch.empty(plan.scratch_floats, device=dev)
    out = cuda.empty_nhwc(b, h, w, 3, nchw, dev)
    err = cuda.library().ff_edge_fuse(
        *(t.data_ptr() for t in (sr, f0, f1, f2)), nchw, lw.data_ptr(),
        strength.data_ptr(), *args, e1.data_ptr(), e.data_ptr(),
        g.data_ptr(), scratch.data_ptr(), plan.scratch_floats,
        out.data_ptr(), b, h, w, f, cuda.stream(sr))
    cuda.check(err, "edge_fuse_fused")
    cuda.launch_counts["edge_fuse_fused"] += 1
    return out
