"""A whole NAFBlock: the CUDA kernels and the plain version.

Counterpart of ``freqfusion_tpu/ops/pallas_nafblock.py:nafblock_fused``,
with its argument layout: x [B, H, W, C] and ``w`` the flax NAFBlock tree,
here as tensors: norm1/norm2 {scale, bias} [C]; conv1/conv4 kernels
[1, 1, C, 2C], conv3/conv5/sca kernels [1, 1, C, C] (each with its bias);
conv2 (depthwise) kernel [3, 3, 1, 2C] and bias [2C]; beta, gamma [C].

    g   = SimpleGate(dw3x3(conv1(LN1(x))))          LN eps 1e-6
    y   = x + beta * conv3(g * sca(mean_hw(g)))
    out = y + gamma * conv5(SimpleGate(conv4(LN2(y))))

The kernels read each 1x1 kernel's [C, N] matrix as it lies in the tree
and split it into their own fragment order once a call (conv4's two gate
halves interleaved, conv3's rows scaled by each image's SCA vector). A CPU
tensor goes to the plain version; a CUDA tensor goes to
``csrc/nafblock.cu`` (pass A: the splits, LN1, conv1 and the gate with
the SCA pool's per-tile sums; the [B, C] SCA product in PyTorch, as the
JAX wrapper runs it between its two Pallas calls; pass B: conv3 with the
beta residual, LN2, the gated conv4 and conv5 with the gamma residual, the
products in 3xTF32 on the tensor cores, ``csrc/tf32_gemm.cuh``) through a
scratch that :func:`plan_nafblock` sizes, or the call raises. Every H and
W is taken by the kernels: there is no XLA-style fallback for small
shapes. bf16 tensors (the bf16 expert mode) go to the bf16 plain version
or to the file's bf16 kernels (the four products on ``csrc/bf16_wgmma.cuh``'s
wgmma GEMMs, the weights laid out once by ``ops/wgmma.py``; at C <= 256
two launches, pass A over halo tiles with u kept on chip and pass B with
y, T2 and g2 kept on chip; above, nine; :func:`wgmma.plan_nafblock_bf16`),
both with the JAX kernel's rounding points, counted as
``nafblock_fused.bf16``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from . import cuda, wgmma
from .attention import _bf16
from .tf32_gemm import (BK, MAX_CHANNELS, ROWS, GemmPlan, _round_up,
                        plan_gemm)

__all__ = ["nafblock_fused", "nafblock_fused_reference", "plan_nafblock",
           "NafPlan", "MAX_CHANNELS"]

EPS = 1e-6


class NafPlan(NamedTuple):
    """How ``csrc/nafblock.cu`` runs one call (its ``naf_plan``)."""
    kp: int              # C padded to BK: every product's K
    mpi: int             # H W padded to ROWS: A's rows an image
    conv1: GemmPlan      # C -> 2C
    conv3: GemmPlan      # C -> C, one W3 copy an image (conv5's the same)
    conv4: GemmPlan      # C -> 2 kp virtual columns, the halves interleaved
    scratch_floats: int  # the splits, two tiled A buffers, u / y
    bytes_per_pixel: int  # device memory the nine launches move a pixel
    bound_bytes_per_pixel: int  # x in, out out


def plan_nafblock(m: int, c: int, batch: int = 1) -> NafPlan:
    """The padded extents, tiles and scratch of a call on `batch` images
    of `m` pixels each, `c` channels."""
    if c > MAX_CHANNELS:
        raise ValueError(f"nafblock_fused: C={c} > {MAX_CHANNELS}")
    kp, mpi = _round_up(c, BK), _round_up(m, ROWS)
    rows = batch * mpi
    conv1, conv3 = plan_gemm(rows, c, 2 * c), plan_gemm(rows, c, c)
    conv4 = plan_gemm(rows, c, 2 * kp)
    scratch = (conv1.split_floats + conv4.split_floats
               + (1 + batch) * conv3.split_floats + 2 * rows * kp
               + 2 * batch * m * c)
    # LN1 x -> T1, conv1 T1 -> u, gate u -> g, conv3 g + x -> y, LN2 y ->
    # T2, conv4 T2 -> g2, conv5 g2 + y -> out; fp32
    moved = 4 * ((c + kp) + (kp + 2 * c) + (2 * c + kp) + (kp + 2 * c)
                 + (c + kp) + 2 * kp + (kp + 2 * c))
    return NafPlan(kp, mpi, conv1, conv3, conv4, scratch, moved, 8 * c)


def _mat(w: Dict[str, Any], name: str) -> torch.Tensor:
    return w[name]["kernel"][0, 0]


def _nafblock_fused_bf16(x: torch.Tensor, w: Dict[str, Any]) -> torch.Tensor:
    """bf16 operands, the JAX kernel's rounding points (pallas_nafblock.py:
    _gate_tile, _apply_kernel): LN1(x) rounded; conv1's bias, the
    depthwise taps, the gate, the SCA in fp32; g s rounded; y fp32; LN2(y)
    rounded; the gate g2 rounded; the output rounded once."""
    c = x.shape[-1]

    def p(name, part="kernel"):
        return w[name][part].float()

    def mat(name):
        return _mat(w, name).float()
    f = x.float()
    xn = _bf16(F.layer_norm(f, (c,), p("norm1", "scale"), p("norm1", "bias"),
                            EPS))
    u = xn @ mat("conv1") + p("conv1", "bias")
    u = F.conv2d(u.permute(0, 3, 1, 2), p("conv2").permute(3, 2, 0, 1),
                 p("conv2", "bias"), padding=1, groups=2 * c).permute(
                     0, 2, 3, 1)
    g = u[..., :c] * u[..., c:]
    s = g.mean((1, 2)) @ mat("sca") + p("sca", "bias")
    x3 = _bf16(g * s[:, None, None, :]) @ mat("conv3") + p("conv3", "bias")
    y = f + x3 * w["beta"].float()
    t2 = _bf16(F.layer_norm(y, (c,), p("norm2", "scale"), p("norm2", "bias"),
                            EPS))
    u2 = t2 @ mat("conv4") + p("conv4", "bias")
    o = _bf16(u2[..., :c] * u2[..., c:]) @ mat("conv5") + p("conv5", "bias")
    return (y + o * w["gamma"].float()).to(torch.bfloat16)


def nafblock_fused_reference(x: torch.Tensor, w: Dict[str, Any]
                             ) -> torch.Tensor:
    """Plain PyTorch version of :func:`nafblock_fused` (in bf16 for a bf16
    x, see :func:`_nafblock_fused_bf16`)."""
    if x.dtype == torch.bfloat16:
        return _nafblock_fused_bf16(x, w)
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
    if x.dtype == torch.bfloat16:
        return _nafblock_fused_bf16_kernel(x, w)
    b, h, w_, c = x.shape
    dev = x.device
    plan = plan_nafblock(h * w_, c, b)
    cuda.require(x, "x", (b, h, w_, c), dev)
    mats = {n: _mat(w, n).contiguous()
            for n in ("conv1", "conv3", "conv4", "conv5", "sca")}
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
    partials = torch.empty(b, tiles, c, device=dev, dtype=torch.float32)
    scratch = torch.empty(plan.scratch_floats, device=dev,
                          dtype=torch.float32)
    err = lib.ff_nafblock_gate(
        *(cuda.ptr(t) for t in (
            x, w["norm1"]["scale"], w["norm1"]["bias"], mats["conv1"],
            w["conv1"]["bias"], mats["conv4"], mats["conv5"],
            w["conv2"]["kernel"], w["conv2"]["bias"], partials, scratch)),
        plan.scratch_floats, b, h, w_, c, EPS, stream)
    cuda.check(err, "nafblock_fused (gate)")
    s = (partials.sum(1) / (h * w_) @ mats["sca"] + w["sca"]["bias"]
         ).contiguous()
    out = torch.empty_like(x)
    err = lib.ff_nafblock_apply(
        *(cuda.ptr(t) for t in (
            s, x, mats["conv3"], w["conv3"]["bias"], w["beta"],
            w["norm2"]["scale"], w["norm2"]["bias"], w["conv4"]["bias"],
            w["conv5"]["bias"], w["gamma"], out, scratch)),
        plan.scratch_floats, b, h, w_, c, EPS, stream)
    cuda.check(err, "nafblock_fused (apply)")
    cuda.launch_counts["nafblock_fused"] += 1
    return out


def _nafblock_fused_bf16_kernel(x: torch.Tensor, w: Dict[str, Any]
                                ) -> torch.Tensor:
    """The bf16 kernels: x and every tensor of the tree bf16 (the SCA's
    weight is widened in PyTorch); C even, at most 1024. The four 1x1
    weights go to the kernels laid out in wgmma's order, once per weight
    (:func:`wgmma.weight_layouts`: hand views of the module's parameters,
    as ``models/nafnet.py`` does, so that the layouts are reused)."""
    bf, dev = torch.bfloat16, x.device
    b, h, w_, c = x.shape
    plan = wgmma.plan_nafblock_bf16(h, w_, c, b)
    cuda.require(x, "x", (b, h, w_, c), dev, bf)
    mats = {n: _mat(w, n) for n in ("conv1", "conv3", "conv4", "conv5", "sca")}
    # read only through their layouts (sca's by a PyTorch product): views
    for n, m in mats.items():
        cuda.require(m, n, (c, 2 * c if n in ("conv1", "conv4") else c), dev,
                     bf, contiguous=False)
        cuda.require(w[n]["bias"], f"{n} bias", (m.shape[1],), dev, bf)
    cuda.require(w["conv2"]["kernel"], "conv2", (3, 3, 1, 2 * c), dev, bf)
    cuda.require(w["conv2"]["bias"], "conv2 bias", (2 * c,), dev, bf)
    vecs = (w["norm1"]["scale"], w["norm1"]["bias"], w["norm2"]["scale"],
            w["norm2"]["bias"], w["beta"], w["gamma"])
    for i, v in enumerate(vecs):
        cuda.require(v, f"vector {i}", (c,), dev, bf)
    lib = cuda.library()
    stream = cuda.stream(x)
    nbytes = lib.ff_nafblock_bf16_scratch_bytes(b * h * w_, c)
    tiles = lib.ff_nafblock_bf16_tiles(h, w_, c)
    if nbytes != plan.scratch_bytes or tiles != plan.tiles:
        raise ValueError(f"nafblock_fused (bf16): C={c} refused")
    w1 = wgmma.weight_layouts(mats["conv1"], plan.bn1, True)
    w3 = wgmma.weight_layouts(mats["conv3"], plan.bn)
    w4 = wgmma.weight_layouts(mats["conv4"], plan.bn, True)
    w5 = wgmma.weight_layouts(mats["conv5"], plan.bn)
    scratch = torch.empty(nbytes, device=dev, dtype=torch.uint8)
    partials = torch.empty(b, tiles, c, device=dev, dtype=torch.float32)
    err = lib.ff_nafblock_gate_bf16(
        *(cuda.ptr(t) for t in (
            x, w["norm1"]["scale"], w["norm1"]["bias"], w1,
            w["conv1"]["bias"], w["conv2"]["kernel"], w["conv2"]["bias"],
            partials, scratch)),
        nbytes, b, h, w_, c, EPS, stream)
    cuda.check(err, "nafblock_fused (bf16 gate)")
    s = (partials.sum(1) / (h * w_) @ mats["sca"].float()
         + w["sca"]["bias"].float()).contiguous()
    out = torch.empty_like(x)
    err = lib.ff_nafblock_apply_bf16(
        *(cuda.ptr(t) for t in (
            s, x, w3, w["conv3"]["bias"], w["beta"], w["norm2"]["scale"],
            w["norm2"]["bias"], w4, w["conv4"]["bias"], w5,
            w["conv5"]["bias"], w["gamma"], out, scratch)),
        nbytes, b, h, w_, c, EPS, stream)
    cuda.check(err, "nafblock_fused (bf16 apply)")
    cuda.launch_counts["nafblock_fused.bf16"] += 1
    return out
