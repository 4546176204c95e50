"""Hierarchical fusion stage 3 + to_rgb: the CUDA kernels and the plain
version.

Counterpart of ``freqfusion_tpu/ops/pallas_hier.py:hier_stage3_fused``,
with its argument layout: s3_in [B, H, W, 76] (f2_up's 64 channels, then
the expert stack's 12) and ``p`` the flax tree {stage3_conv_0,
stage3_conv_2, stage3_gate{gate_0, gate_2}, stage3_res{block_0, block_2,
scale}, rw23, to_rgb_0, to_rgb_2}, here as tensors (conv kernels
[kh, kw, Cin, Cout], HWIO):

    a   = gelu(conv3x3(gelu(conv3x3(s3_in))))          76 -> 64 -> 32
    f   = a * sigmoid(gate_2(gelu(gate_0(a))))          SpatialGate
    f3  = f + scale * block_2(gelu(block_0(f))) + rw23 * s3_in[..., :32]
    out = sigmoid(to_rgb_2(gelu(to_rgb_0(f3))))         [B, H, W, 3]

GELU is exact (erf); the convolutions zero-pad. A CPU tensor goes to the
plain version; a CUDA tensor goes to ``csrc/hier.cu`` (the six convs as
3xTF32 implicit GEMMs on the tensor cores, ``csrc/conv3x3_tf32.cuh``, the
SpatialGate in conv1's epilogue) or the call raises. The CUDA route takes
s3_in NHWC-contiguous or as an NCHW-contiguous tensor viewed as NHWC
(``u.permute(0, 2, 3, 1)``, no copy) and returns the output in the same
layout. Unlike the JAX wrapper, the kernel takes every H and W itself:
there is no XLA fallback.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import cuda

__all__ = ["hier_stage3_fused", "hier_stage3_fused_reference", "conv3x3",
           "dense1x1", "plan_hier", "HierPlan", "ConvPlan"]

# csrc/conv3x3_tf32.cuh: output tile columns (an m-tile's rows), input
# channels a stage, stages in the ring
TILE_W = 16
CK = 8
STAGES = 2
# csrc/hier.cu: (n-tiles a block, m-tiles a warp) of conv0, conv1,
# block_0, block_2, to_rgb_0, to_rgb_2
CONV_TILES = ((4, 3), (4, 3), (4, 3), (4, 3), (2, 4), (1, 4))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class ConvPlan(NamedTuple):
    """One conv of ``csrc/hier.cu``: a block of 8 warps takes 8 mt x 16
    output pixels and 8 nt output channels, K = 9 cinp in stages of CK
    channels."""
    cin: int
    cout: int
    cinp: int    # cin padded to CK
    coutp: int   # cout padded to 8 nt
    nt: int      # n-tiles a block
    mt: int      # m-tiles (output rows) a warp
    tiles: int   # (8 mt) x 16 output tiles an image
    blocks: int  # blocks an image: tiles x coutp / (8 nt)
    smem: int    # bytes of shared memory a block takes


class HierPlan(NamedTuple):
    convs: Tuple[ConvPlan, ...]  # conv0, conv1, block_0, block_2, to_rgb
    scratch_floats: int          # the six convs' split weights


def conv_smem(nt: int, mt: int) -> int:
    """Bytes of shared memory a conv block takes: STAGES stages of the
    halo ((8 mt + 2) x 18 pixels x CK channels, split in registers as it
    is read) and of the split weights of 9 taps (9 x CK x 8 nt, hi and
    lo), an mbarrier a stage."""
    halo = (8 * mt + 2) * (TILE_W + 2)
    stage = halo * CK + 9 * CK * 8 * nt * 2
    return 4 * STAGES * stage + 8 * STAGES


def plan_hier(h: int, w: int, cin: int, c1: int = 64) -> HierPlan:
    """How ``csrc/hier.cu`` runs a call on [B, h, w, cin] (its
    ``hier_plan``): each conv's padded extents, tiles and shared memory,
    and the scratch of split weights (18 cinp coutp floats a conv)."""
    c2, ct = c1 // 2, c1 // 4
    convs = []
    for (ci, co), (nt, mt) in zip(((cin, c1), (c1, c2), (c2, c2), (c2, c2),
                                   (c2, ct), (ct, 3)), CONV_TILES):
        coutp = _round_up(co, 8 * nt)
        tiles = -(-h // (8 * mt)) * -(-w // TILE_W)
        convs.append(ConvPlan(ci, co, _round_up(ci, CK), coutp, nt, mt, tiles,
                              tiles * coutp // (8 * nt), conv_smem(nt, mt)))
    return HierPlan(tuple(convs), sum(18 * c.cinp * c.coutp for c in convs))


def conv3x3(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """NHWC 3x3 convolution, zero padding, HWIO kernel, optional bias."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["kernel"].permute(3, 2, 0, 1),
                 p.get("bias"), padding=1)
    return y.permute(0, 2, 3, 1)


def dense1x1(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """NHWC 1x1 convolution with bias, kernel [1, 1, Cin, Cout]."""
    return x @ p["kernel"][0, 0] + p["bias"]


def hier_stage3_fused_reference(s3_in: torch.Tensor, p: Dict[str, Any]
                                ) -> torch.Tensor:
    """Plain PyTorch version of :func:`hier_stage3_fused` (the JAX
    package's ``_hier_stage3_xla``)."""
    a = F.gelu(conv3x3(F.gelu(conv3x3(s3_in, p["stage3_conv_0"])),
                       p["stage3_conv_2"]))
    g = p["stage3_gate"]
    f = a * torch.sigmoid(dense1x1(F.gelu(dense1x1(a, g["gate_0"])),
                                   g["gate_2"]))
    r = p["stage3_res"]
    f3 = f + r["scale"] * conv3x3(F.gelu(conv3x3(f, r["block_0"])),
                                  r["block_2"])
    f3 = f3 + p["rw23"] * s3_in[..., :a.shape[-1]]
    return torch.sigmoid(conv3x3(F.gelu(conv3x3(f3, p["to_rgb_0"])),
                                 p["to_rgb_2"]))


def hier_stage3_fused(s3_in: torch.Tensor, p: Dict[str, Any]
                      ) -> torch.Tensor:
    """s3_in [B, H, W, Cin]; p the tree above at base_channels 64 (the
    outputs of stage3_conv_0). Returns [B, H, W, 3]."""
    if s3_in.device.type == "cpu":
        return hier_stage3_fused_reference(s3_in, p)
    if s3_in.device.type != "cuda":
        raise ValueError(f"hier_stage3_fused: unsupported device "
                         f"{s3_in.device}")
    cuda.fp32_only("hier_stage3_fused", s3_in)
    b, h, w, cin = s3_in.shape
    c1 = p["stage3_conv_0"]["kernel"].shape[-1]
    c2, cg, ct = c1 // 2, c1 // 8, c1 // 4
    if c1 != 64 or cin < c2:
        raise ValueError(f"hier_stage3_fused: base channels {c1}, expected "
                         "64 (the gate's squeeze must be 8 wide and conv1's "
                         f"32 channels one block's), and Cin {cin} >= {c2}")
    dev = s3_in.device
    nchw = cuda.nhwc_layout(s3_in)
    cuda.require_layout(s3_in, "s3_in", (b, h, w, cin), dev, nchw)
    g, r = p["stage3_gate"], p["stage3_res"]
    tensors = [
        ("stage3_conv_0", p["stage3_conv_0"]["kernel"], (3, 3, cin, c1)),
        ("stage3_conv_0 bias", p["stage3_conv_0"]["bias"], (c1,)),
        ("stage3_conv_2", p["stage3_conv_2"]["kernel"], (3, 3, c1, c2)),
        ("stage3_conv_2 bias", p["stage3_conv_2"]["bias"], (c2,)),
        ("gate_0", g["gate_0"]["kernel"][0, 0], (c2, cg)),
        ("gate_0 bias", g["gate_0"]["bias"], (cg,)),
        ("gate_2", g["gate_2"]["kernel"][0, 0, :, 0], (cg,)),
        ("gate_2 bias", g["gate_2"]["bias"], (1,)),
        ("block_0", r["block_0"]["kernel"], (3, 3, c2, c2)),
        ("block_2", r["block_2"]["kernel"], (3, 3, c2, c2)),
        ("to_rgb_0", p["to_rgb_0"]["kernel"], (3, 3, c2, ct)),
        ("to_rgb_0 bias", p["to_rgb_0"]["bias"], (ct,)),
        ("to_rgb_2", p["to_rgb_2"]["kernel"], (3, 3, ct, 3)),
        ("to_rgb_2 bias", p["to_rgb_2"]["bias"], (3,)),
        ("scale", r["scale"], ()), ("rw23", p["rw23"], ())]
    for name, t, shape in tensors:
        cuda.require(t, name, shape, dev)
    plan = plan_hier(h, w, cin, c1)
    buf64 = torch.empty(b, h, w, c1, device=dev)
    buf32 = torch.empty(b, h, w, c2, device=dev)
    scratch = torch.empty(plan.scratch_floats, device=dev)
    out = cuda.empty_nhwc(b, h, w, 3, nchw, dev)
    err = cuda.library().ff_hier_stage3(
        s3_in.data_ptr(), nchw, *(t.data_ptr() for _, t, _ in tensors),
        buf64.data_ptr(), buf32.data_ptr(), scratch.data_ptr(),
        plan.scratch_floats, out.data_ptr(), b, h, w, cin, c1,
        cuda.stream(s3_in))
    cuda.check(err, "hier_stage3_fused")
    cuda.launch_counts["hier_stage3_fused"] += 1
    return out
