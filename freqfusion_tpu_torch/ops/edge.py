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
fallback. In bf16 (every image and parameter bf16, as ``fusion_dtype``
casts them) both routes follow the JAX kernels' rounding points: each
conv's input and refine's two 1x1 operands rounded to bf16 (fuse's levels
after their weights: bf16(lw f)), fp32 sums and biases, hid, the edge map,
GELU, the gates and the residual in fp32, the output rounded; the CUDA
routes are ``ff_edge_refine_bf16`` and ``ff_edge_fuse_bf16`` (the inputs
packed NHWC, the levels times lw, then the bf16 convs of
``csrc/conv3x3_tf32.cuh``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import cuda
from .hier import (CK, CK16, TILE_W, ConvPlan, conv3x3, conv3x3_bf16,
                   conv_smem, dense1x1, dense1x1_bf16, rounded, split_floats)

__all__ = ["edge_refine_fused", "edge_refine_fused_reference",
           "edge_fuse_fused", "edge_fuse_fused_reference", "plan_edge",
           "EdgePlan"]

# csrc/edge.cu: (n-tiles a block, m-tiles a warp) of refine's conv1,
# conv2, conv3 (+ the projection) and attention conv, and of fuse's
# fusion_0, fusion_2, edge_gate_0 and edge_gate_2
REFINE_TILES = ((4, 3), (4, 3), (4, 3), (1, 4))
FUSE_TILES = ((4, 3), (1, 4), (2, 4), (1, 4))
GATE_HIDDEN = 16  # edge_gate_0's outputs


def _pad(c: int, ck: int = CK) -> int:
    return -(-c // ck) * ck


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
              fuse: bool = False, bf16: bool = False) -> EdgePlan:
    """The plan of refine on [B, h, w, cin] (conv1 cin -> f, conv2,
    conv3 over (h, lap): f + cin -> f, the attention conv f / 4 -> 1) or
    of fuse on [B, h, w, f] levels (fusion_0 over (f0, f1, f2), fusion_2
    f -> 3, edge_gate_0 over (sr, edge): 3 + 3 -> 16, edge_gate_2 16 ->
    1); bf16: of the bf16 entries (sources padded to CK16)."""
    if fuse:
        convs = (((f, f, f), f), ((f,), 3), ((3, 3), GATE_HIDDEN),
                 ((GATE_HIDDEN,), 1))
        tiles = FUSE_TILES
    else:
        convs = (((cin,), f), ((f,), f), ((f, cin), f), ((f // 4,), 1))
        tiles = REFINE_TILES
    plans, sources = [], []
    for (srcs, co), (nt, mt) in zip(convs, tiles):
        pads = tuple(_pad(c, CK16 if bf16 else CK) for c in srcs)
        coutp = -(-co // (8 * nt)) * 8 * nt
        n_tiles = -(-h // (8 * mt)) * -(-w // TILE_W)
        plans.append(ConvPlan(sum(srcs), co, sum(pads), coutp, nt, mt,
                              n_tiles, n_tiles * coutp // (8 * nt),
                              conv_smem(nt, mt, bf16)))
        sources.append(pads)
    return EdgePlan(tuple(plans), tuple(sources),
                    sum(split_floats(c.cinp, c.coutp, bf16) for c in plans))


def _weights(p: Dict[str, Any], convs, device,
             dtype: torch.dtype = torch.float32) -> list:
    """The kernels' arguments for the convs named in `convs` (name, HWIO
    shape): each kernel's pointer and its four element strides, so a view
    (the modules hand PyTorch's OIHW weights permuted, no copy) goes as
    it is, then its bias's pointer."""
    args = []
    for name, shape in convs:
        k, b = p[name]["kernel"], p[name]["bias"]
        if k.device != device or k.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {device}")
        if tuple(k.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(k.shape)}, expected "
                             f"{shape}")
        cuda.require(b, f"{name} bias", shape[-1:], device, dtype)
        args += [k.data_ptr(), *k.stride(), b.data_ptr()]
    return args


def _refine_bf16_reference(lap: torch.Tensor, p: Dict[str, Any]
                           ) -> torch.Tensor:
    """The JAX kernel's arithmetic on a bf16 level (``pallas_edge.py:
    94-116``)."""
    x = lap.float()
    t = F.gelu(conv3x3_bf16(F.gelu(conv3x3_bf16(x, p["conv1"])), p["conv2"]))
    hid = conv3x3_bf16(t, p["conv3"]) + dense1x1_bf16(x, p["proj"])
    a = conv3x3_bf16(F.gelu(dense1x1_bf16(hid, p["attn_0"])), p["attn_2"])
    return (hid * torch.sigmoid(a)).to(torch.bfloat16)


def edge_refine_fused_reference(lap: torch.Tensor, p: Dict[str, Any]
                                ) -> torch.Tensor:
    """Plain PyTorch version of :func:`edge_refine_fused` (the JAX
    package's ``_refine_xla``; in bf16 the Pallas kernel's rounding
    points)."""
    if lap.dtype == torch.bfloat16:
        return _refine_bf16_reference(lap, p)
    t = F.gelu(conv3x3(F.gelu(conv3x3(lap, p["conv1"])), p["conv2"]))
    t = conv3x3(t, p["conv3"]) + dense1x1(lap, p["proj"])
    a = conv3x3(F.gelu(dense1x1(t, p["attn_0"])), p["attn_2"])
    return t * torch.sigmoid(a)


def edge_refine_fused(lap: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    """lap [B, H, W, Cin], fp32 or bf16 (every parameter then bf16); p
    the tree above (F = conv1's outputs, F / 4 = 8). Returns [B, H, W, F]
    in lap's dtype."""
    if lap.device.type == "cpu":
        return edge_refine_fused_reference(lap, p)
    if lap.device.type != "cuda":
        raise ValueError(f"edge_refine_fused: unsupported device {lap.device}")
    bf = lap.dtype == torch.bfloat16
    dt = lap.dtype if bf else torch.float32
    b, h, w, cin = lap.shape
    f = p["conv1"]["kernel"].shape[-1]
    if f != 32:
        raise ValueError(f"edge_refine_fused: {f} features, expected 32 "
                         "(the attention's squeeze must be 8 wide)")
    dev = lap.device
    nchw = cuda.nhwc_layout(lap)
    cuda.require_layout(lap, "lap", (b, h, w, cin), dev, nchw, dt)
    args = _weights(p, [("conv1", (3, 3, cin, f)), ("conv2", (3, 3, f, f)),
                        ("conv3", (3, 3, f, f)), ("proj", (1, 1, cin, f)),
                        ("attn_0", (1, 1, f, f // 4)),
                        ("attn_2", (3, 3, f // 4, 1))], dev, dt)
    plan = plan_edge(h, w, cin, f, bf16=bf)
    scratch = torch.empty(plan.scratch_floats, device=dev)
    out = cuda.empty_nhwc(b, h, w, f, nchw, dev, dt)
    if bf:  # lap made NHWC, conv1's output (then the squeeze), conv2's,
        # hid in fp32
        if cin > 8:
            raise ValueError(f"edge_refine_fused: bf16 takes <= 8 channels, "
                             f"got {cin}")
        bufs = (torch.empty(b, h, w, 8, device=dev, dtype=dt),
                torch.empty(b, h, w, f, device=dev, dtype=dt),
                torch.empty(b, h, w, f, device=dev, dtype=dt),
                torch.empty(b, h, w, f, device=dev))
    else:
        bufs = (torch.empty(b, h, w, f + f // 4, device=dev),
                torch.empty(b, h, w, f, device=dev))
    entry = (cuda.library().ff_edge_refine_bf16 if bf
             else cuda.library().ff_edge_refine)
    err = entry(
        lap.data_ptr(), nchw, *args, *(t.data_ptr() for t in bufs),
        scratch.data_ptr(), plan.scratch_floats, out.data_ptr(), b, h, w,
        cin, f, cuda.stream(lap))
    name = "edge_refine_fused" + (".bf16" if bf else "")
    cuda.check(err, name)
    cuda.launch_counts[name] += 1
    return out


def _fuse_bf16_reference(sr, f0, f1, f2, lw, strength,
                         p: Dict[str, Any]) -> torch.Tensor:
    """The JAX kernel's arithmetic on bf16 images (``pallas_edge.py:
    220-231``)."""
    s, lw = sr.float(), lw.float()
    allf = torch.cat([f0.float() * lw[0], f1.float() * lw[1],
                      f2.float() * lw[2]], -1)
    edge = conv3x3_bf16(F.gelu(conv3x3_bf16(allf, p["fusion_0"])),
                        p["fusion_2"])
    g = F.gelu(conv3x3_bf16(torch.cat([s, edge], -1), p["edge_gate_0"]))
    gate = torch.sigmoid(conv3x3_bf16(g, p["edge_gate_2"]))
    out = s + gate * strength.float() * edge
    return torch.clamp(out, 0.0, 1.0).to(torch.bfloat16)


def edge_fuse_fused_reference(sr, f0, f1, f2, lw, strength,
                              p: Dict[str, Any]) -> torch.Tensor:
    """Plain PyTorch version of :func:`edge_fuse_fused` (the JAX package's
    ``_fuse_xla``; in bf16 the Pallas kernel's rounding points)."""
    if sr.dtype == torch.bfloat16:
        return _fuse_bf16_reference(sr, f0, f1, f2, lw, strength, p)
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
    scalar tensor; p the tree above; all fp32, or all bf16. Returns [B, H,
    W, 3] in sr's dtype."""
    if sr.device.type == "cpu":
        return edge_fuse_fused_reference(sr, f0, f1, f2, lw, strength, p)
    if sr.device.type != "cuda":
        raise ValueError(f"edge_fuse_fused: unsupported device {sr.device}")
    bf = sr.dtype == torch.bfloat16
    dt = sr.dtype if bf else torch.float32
    b, h, w, _ = sr.shape
    f = f0.shape[-1]
    if f > 64:
        raise ValueError(f"edge_fuse_fused: {f} features > 64")
    dev = sr.device
    nchw = cuda.nhwc_layout(sr)
    cuda.require_layout(sr, "sr", (b, h, w, 3), dev, nchw, dt)
    for name, t in (("f0", f0), ("f1", f1), ("f2", f2)):
        cuda.require_layout(t, name, (b, h, w, f), dev, nchw, dt)
    cuda.require(lw, "lw", (3,), dev, dt)
    cuda.require(strength, "strength", (), dev, dt)
    args = _weights(p, [("fusion_0", (3, 3, 3 * f, f)),
                        ("fusion_2", (3, 3, f, 3)),
                        ("edge_gate_0", (3, 3, 6, GATE_HIDDEN)),
                        ("edge_gate_2", (3, 3, GATE_HIDDEN, 1))], dev, dt)
    plan = plan_edge(h, w, 3, f, fuse=True, bf16=bf)
    # fusion_0's output, the edge map (fp32 either way), the gate's hidden;
    # bf16: the levels times lw and sr made NHWC, the edge map's bf16 copy
    e1 = torch.empty(b, h, w, f, device=dev, dtype=dt)
    e = torch.empty(b, h, w, 3, device=dev)
    g = torch.empty(b, h, w, GATE_HIDDEN, device=dev, dtype=dt)
    bufs = [e1, e, g]
    if bf:
        if f % 8:
            raise ValueError(f"edge_fuse_fused: bf16 takes F % 8 == 0, "
                             f"got {f}")
        bufs = [torch.empty(b, h, w, 3 * f, device=dev, dtype=dt),
                torch.empty(b, h, w, 8, device=dev, dtype=dt), e1, e,
                torch.empty(b, h, w, 8, device=dev, dtype=dt), g]
    scratch = torch.empty(plan.scratch_floats, device=dev)
    out = cuda.empty_nhwc(b, h, w, 3, nchw, dev, dt)
    entry = (cuda.library().ff_edge_fuse_bf16 if bf
             else cuda.library().ff_edge_fuse)
    err = entry(
        *(t.data_ptr() for t in (sr, f0, f1, f2)), nchw, lw.data_ptr(),
        strength.data_ptr(), *args, *(t.data_ptr() for t in bufs),
        scratch.data_ptr(), plan.scratch_floats,
        out.data_ptr(), b, h, w, f, cuda.stream(sr))
    name = "edge_fuse_fused" + (".bf16" if bf else "")
    cuda.check(err, name)
    cuda.launch_counts[name] += 1
    return out
