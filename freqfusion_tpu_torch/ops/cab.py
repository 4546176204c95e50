"""Fused CAB (conv-attention block): the CUDA kernels and the plain version.

Counterpart of ``freqfusion_tpu/ops/pallas_cab.py:cab_fused``, with its
argument layout: x [B, H, W, C] and ``w`` the flax CAB tree, here as
tensors: ``cab_0`` / ``cab_2`` kernels [3, 3, Cin, Cout] (HWIO) and biases,
``ca_1`` / ``ca_3`` kernels [1, 1, Cin, Cout] and biases.

    y   = conv3x3(gelu(conv3x3(LN(x) or x)))        C -> C/cr -> C
    out = y * sigmoid(ca_3(relu(ca_1(mean_hw(y)))))  (+ x * skip_scale)

GELU is exact (erf); the convolutions zero-pad. A CPU tensor goes to the
plain version; a CUDA tensor goes to ``csrc/cab.cu`` (pass A: both convs
as 3xTF32 implicit GEMMs on the tensor cores, writing y and per-tile
channel sums; the [B, C] squeeze MLP in PyTorch; pass B: the scale and the
skip) or the call raises. Unlike the JAX wrapper, the kernel takes every H
and W itself: there is no XLA fallback for small or indivisible shapes.
bf16 tensors (the bf16 expert mode) go to the bf16 plain version or to the
file's bf16 kernels (both convs on ``wgmma``, ``csrc/bf16_wgmma.cuh``, the
nine taps read from one staged halo through shifted descriptors, the
weights laid out once per module by ``ops/wgmma.py:conv_layouts``, planned
by ``plan_cab_bf16``; y kept in fp32 between the passes, as JAX recomputes
it in fp32), both with the JAX kernel's rounding points, counted as
``cab_fused.bf16``. The conv kernels may be views (the models hand
``conv.weight.permute(2, 3, 1, 0)``): the bf16 kernels read only their
cached layouts, the fp32 kernels a contiguous copy of a view.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import cuda, wgmma
from .attention import _bf16

__all__ = ["cab_fused", "cab_fused_reference", "plan_cab", "CabPlan"]

MAX_CHANNELS = 256  # the LN prologue holds a pixel's channels in registers
# csrc/cab.cu's conv tiles: output pixels a side, input channels a stage,
# halo pixels, stages in the ring
TILE = 16
CK = 8
HALO = (TILE + 2) ** 2
STAGES = 2


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def conv_tiles(cout: int) -> int:
    """n-tiles (8 output channels each) a conv block takes: 4 or 6,
    whichever pads `cout` less, 6 on a tie."""
    return 4 if _round_up(cout, 32) < _round_up(cout, 48) else 6


def conv_smem(nt: int) -> int:
    """Bytes of shared memory a conv block with `nt` n-tiles takes: two
    stages of the split halo ([2][HALO][CK]) and of the split weights of 9
    taps ([9][CK][8 nt], hi and lo), then each halo pixel's mean and
    1/std, and an mbarrier a stage."""
    stage = 2 * HALO * CK + 9 * CK * 8 * nt * 2
    return 4 * (STAGES * stage + 2 * HALO) + 8 * STAGES


class CabPlan(NamedTuple):
    """How ``csrc/cab.cu`` runs one call (its ``cab_plan``): conv1 (C ->
    Cr) and conv2 (Cr -> C)."""
    tiles: int           # 16 x 16 output tiles an image (partials' axis 1)
    nt1: int             # n-tiles a conv1 block
    nt2: int             # n-tiles a conv2 block
    cinp1: int           # C padded to CK
    coutp1: int          # Cr padded to 8 nt1
    cinp2: int           # Cr padded to CK
    coutp2: int          # C padded to 8 nt2
    scratch_floats: int  # both convs' weights split, 18 cinp coutp each
    smem1: int           # bytes of shared memory a conv1 block takes
    smem2: int
    blocks1: int         # conv1 blocks an image
    blocks2: int


def plan_cab(h: int, w: int, c: int, cr: int) -> CabPlan:
    """Tiles, padded extents, scratch and shared memory of a call on
    [B, h, w, c] with C/cr = `cr` channels in the middle."""
    if max(c, cr) > MAX_CHANNELS:
        raise ValueError(f"cab_fused: C={c}, C/cr={cr} > {MAX_CHANNELS}")
    tiles = -(-h // TILE) * -(-w // TILE)
    nt1, nt2 = conv_tiles(cr), conv_tiles(c)
    cinp1, coutp1 = _round_up(c, CK), _round_up(cr, 8 * nt1)
    cinp2, coutp2 = _round_up(cr, CK), _round_up(c, 8 * nt2)
    return CabPlan(tiles, nt1, nt2, cinp1, coutp1, cinp2, coutp2,
                   18 * (cinp1 * coutp1 + cinp2 * coutp2), conv_smem(nt1),
                   conv_smem(nt2), tiles * coutp1 // (8 * nt1),
                   tiles * coutp2 // (8 * nt2))


def _conv3x3(t: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """NHWC 3x3 convolution, zero padding, HWIO kernel."""
    y = F.conv2d(t.permute(0, 3, 1, 2), p["kernel"].permute(3, 2, 0, 1),
                 p["bias"], padding=1)
    return y.permute(0, 2, 3, 1)


def _squeeze(mean: torch.Tensor, w) -> torch.Tensor:
    """[B, C] channel mean -> [B, C] sigmoid scale (the CA squeeze MLP), in
    the mean's dtype (bf16 weights widened to the fp32 mean, as the JAX
    wrapper runs it)."""
    def p(name, part):
        return w[name][part].to(mean.dtype)
    a = torch.relu(mean @ p("ca_1", "kernel")[0, 0] + p("ca_1", "bias"))
    return torch.sigmoid(a @ p("ca_3", "kernel")[0, 0] + p("ca_3", "bias"))


def _cab_fused_bf16(x, w, ln, skip_scale, eps: float) -> torch.Tensor:
    """bf16 operands, the JAX kernel's rounding points (pallas_cab.py:
    _conv_bank, _y_tile, _apply_kernel): each conv's input rounded (LN(x)
    in fp32, then the GELU output), biases and y in fp32, the pool and the
    squeeze in fp32, the output rounded once."""
    f = x.float()
    c = x.shape[-1]
    t = f if ln is None else F.layer_norm(f, (c,), ln["scale"].float(),
                                          ln["bias"].float(), eps)

    def conv(v, p):
        return _conv3x3(_bf16(v), {"kernel": p["kernel"].float(),
                                   "bias": p["bias"].float()})
    y = conv(F.gelu(conv(t, w["cab_0"])), w["cab_2"])
    out = y * _squeeze(y.mean((1, 2)), w)[:, None, None, :]
    if skip_scale is not None:
        out = out + f * skip_scale.float()
    return out.to(torch.bfloat16)


def cab_fused_reference(x, w, ln=None, skip_scale=None, eps: float = 1e-5):
    """Plain PyTorch version of :func:`cab_fused` (in bf16 for a bf16 x,
    see :func:`_cab_fused_bf16`)."""
    if x.dtype == torch.bfloat16:
        return _cab_fused_bf16(x, w, ln, skip_scale, eps)
    c = x.shape[-1]
    t = x if ln is None else F.layer_norm(x, (c,), ln["scale"], ln["bias"],
                                          eps)
    y = _conv3x3(F.gelu(_conv3x3(t, w["cab_0"])), w["cab_2"])
    out = y * _squeeze(y.mean((1, 2)), w)[:, None, None, :]
    if skip_scale is not None:
        out = out + x * skip_scale
    return out


def cab_fused(x: torch.Tensor, w: Dict[str, Dict[str, torch.Tensor]],
              ln: Optional[Dict[str, torch.Tensor]] = None,
              skip_scale: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
    """x [B, H, W, C]; w the CAB tree above; ln optional pre-LN {scale,
    bias} [C] (MambaIR's ln_2); skip_scale optional [C]: returns
    x * skip_scale + CAB(...) when given, else the CAB branch."""
    if x.device.type == "cpu":
        return cab_fused_reference(x, w, ln, skip_scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"cab_fused: unsupported device {x.device}")
    if x.dtype == torch.bfloat16:
        return _cab_fused_bf16_kernel(x, w, ln, skip_scale, eps)
    b, h, w_, c = x.shape
    cr = w["cab_0"]["kernel"].shape[-1]
    plan = plan_cab(h, w_, c, cr)
    dev = x.device
    k1, k2 = (w[k]["kernel"].contiguous() for k in ("cab_0", "cab_2"))
    cuda.require(x, "x", (b, h, w_, c), dev)
    cuda.require(k1, "cab_0", (3, 3, c, cr), dev)
    cuda.require(w["cab_0"]["bias"], "cab_0 bias", (cr,), dev)
    cuda.require(k2, "cab_2", (3, 3, cr, c), dev)
    cuda.require(w["cab_2"]["bias"], "cab_2 bias", (c,), dev)
    if ln is not None:
        cuda.require(ln["scale"], "ln scale", (c,), dev)
        cuda.require(ln["bias"], "ln bias", (c,), dev)
    if skip_scale is not None:
        cuda.require(skip_scale, "skip_scale", (c,), dev)
    lib = cuda.library()
    u = torch.empty(b, h, w_, cr, device=dev, dtype=torch.float32)
    y = torch.empty_like(x)
    partials = torch.empty(b, plan.tiles, c, device=dev, dtype=torch.float32)
    scratch = torch.empty(plan.scratch_floats, device=dev,
                          dtype=torch.float32)
    lnp = (None, None) if ln is None else (ln["scale"], ln["bias"])
    err = lib.ff_cab_pool(
        *(cuda.ptr(t) for t in (x, k1, w["cab_0"]["bias"], *lnp, u, k2,
                                w["cab_2"]["bias"], y, partials, scratch)),
        plan.scratch_floats, b, h, w_, c, cr, float(eps), cuda.stream(x))
    cuda.check(err, "cab_fused (pool)")
    a = _squeeze(partials.sum(1) / (h * w_), w).contiguous()
    out = torch.empty_like(x)
    err = lib.ff_cab_apply(
        *(cuda.ptr(t) for t in (y, a, x, skip_scale, out)),
        b, h, w_, c, cuda.stream(x))
    cuda.check(err, "cab_fused (apply)")
    cuda.launch_counts["cab_fused"] += 1
    return out


def _cab_fused_bf16_kernel(x, w, ln, skip_scale, eps: float) -> torch.Tensor:
    """The bf16 kernels: x, the conv weights (views or not) and the vectors
    bf16 (the squeeze MLP's weights are widened in PyTorch); C even up to
    256, C/cr up to 64."""
    bf, dev = torch.bfloat16, x.device
    b, h, w_, c = x.shape
    cr = w["cab_0"]["kernel"].shape[-1]
    plan = wgmma.plan_cab_bf16(h, w_, c, cr, b)
    cuda.require(x, "x", (b, h, w_, c), dev, bf)
    cuda.require(w["cab_0"]["kernel"], "cab_0", (3, 3, c, cr), dev, bf,
                 contiguous=False)
    cuda.require(w["cab_0"]["bias"], "cab_0 bias", (cr,), dev, bf)
    cuda.require(w["cab_2"]["kernel"], "cab_2", (3, 3, cr, c), dev, bf,
                 contiguous=False)
    cuda.require(w["cab_2"]["bias"], "cab_2 bias", (c,), dev, bf)
    if ln is not None:
        cuda.require(ln["scale"], "ln scale", (c,), dev, bf)
        cuda.require(ln["bias"], "ln bias", (c,), dev, bf)
    if skip_scale is not None:
        cuda.require(skip_scale, "skip_scale", (c,), dev, bf)
    w1l = wgmma.conv_layouts(w["cab_0"]["kernel"], plan.bn1)
    w2l = wgmma.conv_layouts(w["cab_2"]["kernel"], wgmma.CAB_BN2)
    lib = cuda.library()
    scratch = torch.empty(plan.scratch_bytes, device=dev, dtype=torch.uint8)
    y = torch.empty(b, h, w_, c, device=dev, dtype=torch.float32)
    partials = torch.empty(b, plan.tiles2, c, device=dev, dtype=torch.float32)
    lnp = (None, None) if ln is None else (ln["scale"], ln["bias"])
    err = lib.ff_cab_pool_bf16(
        *(cuda.ptr(t) for t in (x, w1l, w["cab_0"]["bias"], *lnp, w2l,
                                w["cab_2"]["bias"], y, partials, scratch)),
        plan.scratch_bytes, b, h, w_, c, cr, float(eps), cuda.stream(x))
    cuda.check(err, "cab_fused (bf16 pool)")
    a = _squeeze(partials.sum(1) / (h * w_), w).contiguous()
    out = torch.empty_like(x)
    err = lib.ff_cab_apply_bf16(
        *(cuda.ptr(t) for t in (y, a, x, skip_scale, out)),
        b, h, w_, c, cuda.stream(x))
    cuda.check(err, "cab_fused (bf16 apply)")
    cuda.launch_counts["cab_fused.bf16"] += 1
    return out
