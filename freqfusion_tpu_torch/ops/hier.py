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
there is no XLA fallback. The conv kernels may be views (the module hands
views of its parameters); the fp32 route copies them contiguous. In bf16
(s3_in and every parameter bf16, as ``fusion_dtype`` casts them) both
routes follow the JAX kernel's rounding points: each conv's input and the
gate's two 1x1 operands rounded to bf16, fp32 sums and biases, GELU, the
gate, the residuals in fp32, the output rounded after its sigmoid; the
CUDA route is ``ff_hier_stage3_bf16``: six wgmma launches
(:func:`plan_hier_bf16`), conv0 staging s3_in itself, the weights laid out
once per parameter (``ops/wgmma.py:conv_layouts``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import cuda, wgmma

__all__ = ["hier_stage3_fused", "hier_stage3_fused_reference", "conv3x3",
           "dense1x1", "conv3x3_bf16", "dense1x1_bf16", "rounded",
           "plan_hier", "split_floats", "HierPlan", "ConvPlan",
           "plan_hier_bf16", "HierBf16Plan", "HierBf16Conv", "HIER_BF16_N"]

# csrc/conv3x3_tf32.cuh (the fp32 convs here, and edge.cu's fp32 and bf16
# ones): output tile columns (an m-tile's rows), input channels a stage
# (fp32, bf16), stages in the ring (fp32, bf16)
TILE_W = 16
CK = 8
CK16 = 16
STAGES = 2
STAGES_BF16 = 4
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


def conv_smem(nt: int, mt: int, bf16: bool = False) -> int:
    """Bytes of shared memory a conv3x3_tf32.cuh block takes: STAGES
    stages of the halo ((8 mt + 2) x 18 pixels x CK channels, split in
    registers as it is read) and of the split weights of 9 taps (9 x CK x
    8 nt, hi and lo), an mbarrier a stage; bf16: STAGES_BF16 stages of
    CK16 channels and 9 x CK16 x 8 nt bf16 weights."""
    halo = (8 * mt + 2) * (TILE_W + 2)
    stage = halo * CK + 9 * 8 * nt * (CK16 // 2 if bf16 else 2 * CK)
    ring = STAGES_BF16 if bf16 else STAGES
    return 4 * ring * stage + 8 * ring


def split_floats(cinp: int, coutp: int, bf16: bool = False) -> int:
    """4-byte words of a conv3x3_tf32.cuh conv's split weights: 18 cinp
    coutp (fp32, hi and lo), 4.5 cinp coutp (bf16)."""
    return 9 * cinp * coutp // 2 if bf16 else 18 * cinp * coutp


def plan_hier(h: int, w: int, cin: int, c1: int = 64) -> HierPlan:
    """How ``csrc/hier.cu`` runs an fp32 call on [B, h, w, cin] (its
    ``hier_plan``): each conv's padded extents, tiles and shared memory,
    and the scratch of split weights."""
    c2, ct = c1 // 2, c1 // 4
    convs = []
    for (ci, co), (nt, mt) in zip(((cin, c1), (c1, c2), (c2, c2), (c2, c2),
                                   (c2, ct), (ct, 3)), CONV_TILES):
        coutp = _round_up(co, 8 * nt)
        tiles = -(-h // (8 * mt)) * -(-w // TILE_W)
        convs.append(ConvPlan(ci, co, _round_up(ci, CK), coutp, nt, mt,
                              tiles, tiles * coutp // (8 * nt),
                              conv_smem(nt, mt)))
    return HierPlan(tuple(convs), sum(split_floats(c.cinp, c.coutp)
                                      for c in convs))


# csrc/hier.cu's bf16 convs (conv0, conv1, block_0, block_2, to_rgb_0,
# to_rgb_2): N (Cout padded: wgmma's width), output rows a tile; an
# m-tile is 64 pixels of a row, its halo 66 wide
HIER_BF16_N = (64, 32, 32, 32, 16, 8)
HIER_BF16_ROWS = (4, 8, 8, 8, 8, 8)
HIER_BF16_SEG = 64
HIER_BF16_MAX_CIN = 80


class HierBf16Conv(NamedTuple):
    """One conv of ``ff_hier_stage3_bf16``: a persistent block (one an SM)
    walks tiles of `rows` x 64 output pixels, N output channels, its
    weights (9 cinp N bf16) resident in shared memory, the halo ((rows +
    2) x 66 pixels x cinp) in a ring of two."""
    cin: int
    cout: int
    cinp: int      # cin padded to 16: the wgmma k16 steps
    n: int         # cout padded: wgmma's N (8, 16, 32 or 64)
    rows: int      # output rows a tile
    halo: int      # halo pixels a tile
    tiles: int     # tiles an image
    smem: int      # bytes of shared memory a block
    reread: float  # halo pixels staged per output pixel


class HierBf16Plan(NamedTuple):
    convs: Tuple[HierBf16Conv, ...]


def plan_hier_bf16(h: int, w: int, cin: int, c1: int = 64) -> HierBf16Plan:
    """How ``ff_hier_stage3_bf16`` runs a call on [B, h, w, cin]
    (``ff_hier_bf16_plan`` a conv): each conv's padded extents, tiles a
    batch element and shared memory (the barriers' 128 bytes, the
    weights, two halos)."""
    if c1 != 64 or not c1 // 2 <= cin <= HIER_BF16_MAX_CIN:
        raise ValueError(f"hier_stage3_fused (bf16): base channels {c1} "
                         f"(64) and Cin {cin} (32 to {HIER_BF16_MAX_CIN})")
    c2, ct = c1 // 2, c1 // 4
    convs = []
    for (ci, co), n, rows in zip(((cin, c1), (c1, c2), (c2, c2), (c2, c2),
                                  (c2, ct), (ct, 3)), HIER_BF16_N,
                                 HIER_BF16_ROWS):
        cinp = _round_up(ci, 16)
        halo = (rows + 2) * (HIER_BF16_SEG + 2)
        convs.append(HierBf16Conv(
            ci, co, cinp, n, rows, halo,
            -(-h // rows) * -(-w // HIER_BF16_SEG),
            128 + 18 * cinp * n + 2 * 2 * cinp * halo,
            halo / (rows * HIER_BF16_SEG)))
    return HierBf16Plan(tuple(convs))


def conv3x3(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """NHWC 3x3 convolution, zero padding, HWIO kernel, optional bias."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["kernel"].permute(3, 2, 0, 1),
                 p.get("bias"), padding=1)
    return y.permute(0, 2, 3, 1)


def dense1x1(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """NHWC 1x1 convolution with bias, kernel [1, 1, Cin, Cout]."""
    return x @ p["kernel"][0, 0] + p["bias"]


def rounded(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16, as fp32."""
    return t.to(torch.bfloat16).float()


def conv3x3_bf16(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """:func:`conv3x3` as a JAX kernel's bf16 conv: x and the kernel
    rounded to bf16, fp32 sums, the bias added in fp32."""
    y = F.conv2d(rounded(x).permute(0, 3, 1, 2),
                 rounded(p["kernel"]).permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1)
    return y + p["bias"].float() if p.get("bias") is not None else y


def dense1x1_bf16(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """:func:`dense1x1` on operands rounded to bf16, fp32 sums."""
    return rounded(x) @ rounded(p["kernel"][0, 0]) + p["bias"].float()


def _hier_bf16_reference(s3_in: torch.Tensor, p: Dict[str, Any]
                         ) -> torch.Tensor:
    """The JAX kernel's arithmetic on bf16 s3_in (``pallas_hier.py:
    56-98``)."""
    x = s3_in.float()
    a = F.gelu(conv3x3_bf16(F.gelu(conv3x3_bf16(x, p["stage3_conv_0"])),
                            p["stage3_conv_2"]))
    g = p["stage3_gate"]
    f = a * torch.sigmoid(dense1x1_bf16(F.gelu(dense1x1_bf16(a, g["gate_0"])),
                                        g["gate_2"]))
    r = p["stage3_res"]
    f3 = f + r["scale"].float() * conv3x3_bf16(
        F.gelu(conv3x3_bf16(f, r["block_0"])), r["block_2"])
    f3 = f3 + p["rw23"].float() * x[..., :a.shape[-1]]
    out = torch.sigmoid(conv3x3_bf16(F.gelu(conv3x3_bf16(f3, p["to_rgb_0"])),
                                     p["to_rgb_2"]))
    return out.to(torch.bfloat16)


def hier_stage3_fused_reference(s3_in: torch.Tensor, p: Dict[str, Any]
                                ) -> torch.Tensor:
    """Plain PyTorch version of :func:`hier_stage3_fused` (the JAX
    package's ``_hier_stage3_xla``; in bf16 the Pallas kernel's rounding
    points)."""
    if s3_in.dtype == torch.bfloat16:
        return _hier_bf16_reference(s3_in, p)
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
    """s3_in [B, H, W, Cin], fp32 or bf16 (every parameter then bf16); p
    the tree above at base_channels 64 (the outputs of stage3_conv_0).
    Returns [B, H, W, 3] in s3_in's dtype."""
    if s3_in.device.type == "cpu":
        return hier_stage3_fused_reference(s3_in, p)
    if s3_in.device.type != "cuda":
        raise ValueError(f"hier_stage3_fused: unsupported device "
                         f"{s3_in.device}")
    bf = s3_in.dtype == torch.bfloat16
    dt = s3_in.dtype if bf else torch.float32
    b, h, w, cin = s3_in.shape
    c1 = p["stage3_conv_0"]["kernel"].shape[-1]
    c2, cg, ct = c1 // 2, c1 // 8, c1 // 4
    if c1 != 64 or cin < c2:
        raise ValueError(f"hier_stage3_fused: base channels {c1}, expected "
                         "64 (the gate's squeeze must be 8 wide and conv1's "
                         f"32 channels one block's), and Cin {cin} >= {c2}")
    dev = s3_in.device
    nchw = cuda.nhwc_layout(s3_in)
    cuda.require_layout(s3_in, "s3_in", (b, h, w, cin), dev, nchw, dt)
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
    convs = {"stage3_conv_0": 0, "stage3_conv_2": 1, "block_0": 2,
             "block_2": 3, "to_rgb_0": 4, "to_rgb_2": 5}
    for name, t, shape in tensors:
        # the six conv kernels: any view (the module hands views)
        cuda.require(t, name, shape, dev, dt, contiguous=name not in convs)
    out = cuda.empty_nhwc(b, h, w, 3, nchw, dev, dt)
    if bf:
        plan_hier_bf16(h, w, cin, c1)  # refuses what the kernels do
        # each conv kernel laid out for wgmma once per parameter
        args = [wgmma.conv_layouts(t, HIER_BF16_N[convs[name]])
                if name in convs else t for name, t, _ in tensors]
        # conv0's output (then block_0's and f3, then to_rgb_0's), f in
        # fp32, f rounded
        bufs = [torch.empty(b * h * w * c1, device=dev, dtype=dt),
                torch.empty(b, h, w, c2, device=dev),
                torch.empty(b * h * w * c2, device=dev, dtype=dt)]
        err = cuda.library().ff_hier_stage3_bf16(
            s3_in.data_ptr(), nchw, *(t.data_ptr() for t in args),
            *(t.data_ptr() for t in bufs), out.data_ptr(), b, h, w, cin, c1,
            cuda.stream(s3_in))
        cuda.check(err, "hier_stage3_fused.bf16")
        cuda.launch_counts["hier_stage3_fused.bf16"] += 1
        return out
    plan = plan_hier(h, w, cin, c1)
    # two fp32 scratch images (64 and 32 channels) and the split weights
    bufs = [torch.empty(b, h, w, c1, device=dev),
            torch.empty(b, h, w, c2, device=dev)]
    scratch = torch.empty(plan.scratch_floats, device=dev)
    # the conv kernels contiguous (a view's copy held until the launch is
    # queued: the caching allocator reuses its memory only after it)
    args = [t.contiguous() if name in convs else t for name, t, _ in tensors]
    err = cuda.library().ff_hier_stage3(
        s3_in.data_ptr(), nchw, *(t.data_ptr() for t in args),
        *(t.data_ptr() for t in bufs), scratch.data_ptr(),
        plan.scratch_floats, out.data_ptr(), b, h, w, cin, c1,
        cuda.stream(s3_in))
    cuda.check(err, "hier_stage3_fused")
    cuda.launch_counts["hier_stage3_fused"] += 1
    return out
