"""The fusion net's eval LKABlock: the CUDA kernel and the plain version.

Counterpart of ``freqfusion_tpu/ops/pallas_lka.py:lka_block_fused``, with
its argument layout: x [B, H, W, C] and ``p`` the flax tree {norm1,
lka{local_conv, h_conv, v_conv, pw_conv, bn}, scale1, norm2, ffn_0, ffn_2},
here as tensors (BN trees {scale, bias, mean, var}; depthwise kernels
[kh, kw, 1, C]; 1x1 kernels [1, 1, Cin, Cout]):

    t   = BN1(x)
    x1  = x + scale1 * t * sigmoid(BN(dw21x1(dw1x21(dw5x5(t))) @ pw))
    out = x1 + scale2 * (gelu(BN2(x1) @ ffn_0 + b) @ ffn_2 + b)

Eval BatchNorm (running statistics, eps 1e-5) is a per-channel affine.
GELU is exact (erf); the depthwise convolutions zero-pad. A CPU tensor goes
to the plain version; a CUDA tensor goes to ``csrc/lka.cu`` or the call
raises. In bf16 (x and every parameter bf16, as ``fusion_dtype`` casts
them) both follow the JAX kernel's rounding points: the affines from the
bf16 statistics in fp32, the taps in fp32, each product's operands
rounded to bf16 (a, BN2(x1), the GELU output; the weights as they are)
with fp32 sums, the gate, GELU and residuals in fp32, the output rounded;
the CUDA route is ``ff_lka_block_bf16``, which folds nothing into the
weights. The fp32 CUDA route is a prep launch (the affines from the running statistics, folded into
the products where they can be: sbn into pw's columns, BN2 into ffn_0's
rows and bias; the products' weights split for the tensor cores), a
depthwise pass into a scratch, then the chain of products in 3xTF32 on the
tensor cores. The wrapper launches no PyTorch kernel (it allocates the
scratch and the output): the kernels read the weights through their
strides, so the module's views need no copy. Unlike
the JAX wrapper, the kernel takes every H and W itself: there is no XLA
fallback.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from . import cuda

__all__ = ["lka_block_fused", "lka_block_fused_reference", "plan_lka",
           "LkaPlan", "fold_lka"]

MAX_CHANNELS = 128  # the mix's widest tile
EPS = 1e-5
# csrc/lka.cu: the depthwise pass's output tile and channels a block; the
# mix's rows, warps and ring stages a block, by padded width
DW_TILE = 32
DW_CHANNELS = 4
MIX = {64: dict(rows=64, warps=8, ring=4), 128: dict(rows=96, warps=12,
                                                     ring=4)}


class LkaPlan(NamedTuple):
    """How ``csrc/lka.cu`` runs a call on M = B H W pixels of C channels
    (its ``ff_lka_scratch_floats``)."""
    cp: int              # C padded to the mix's width: 64 or 128
    rows: int            # pixels a mix block
    warps: int           # warps a mix block
    ring: int            # 16-row weight stages in its ring
    stages: int          # stages of the weight stream: 5 Cp / 16
    mix_blocks: int
    mix_smem: int        # bytes of shared memory a mix block takes
    dw_blocks: int       # (C / 4) x 32 x 32 tiles
    dw_smem: int
    scratch_floats: int  # split weights 10 Cp^2, vectors 5 Cp, a C M


def plan_lka(b: int, h: int, w: int, c: int, ch: int,
             bf16: bool = False) -> LkaPlan:
    """Padded width, tiles, shared memory and scratch of a call on
    [b, h, w, c] with a hidden of `ch` units (bf16: of the bf16 kernels,
    the scratch in 4-byte words)."""
    if c % 4 or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"lka_block_fused: C={c} is not a multiple of 4 "
                         f"<= {MAX_CHANNELS}")
    cp = 64 if c <= 64 else 128
    if not 0 < ch <= 2 * cp:
        raise ValueError(f"lka_block_fused: hidden {ch} > 2 x {cp}")
    m = b * h * w
    mix = MIX[cp]
    stage = 2 * (cp // 8) * 128  # floats: 16 weight rows of Cp columns
    mix_smem = 4 * (2 * mix["rows"] * (cp + 8) + mix["ring"] * stage) \
        + 8 * mix["ring"]
    scratch = 10 * cp * cp + 5 * cp + c * m
    if bf16:  # A and T bf16, x1 fp32; a stage 16 rows of bf16 pairs
        mix_smem = 8 * mix["rows"] * (cp + 8) + 4 * mix["ring"] * 8 * cp \
            + 8 * mix["ring"]
        scratch = 5 * cp * cp // 2 + 9 * cp + (c * m + 1) // 2
    s1, s2 = DW_TILE + 24, DW_TILE + 20
    dw_smem = 4 * DW_CHANNELS * (s1 * s1 + s2 * 65 + 67)
    tiles = -(-h // DW_TILE) * -(-w // DW_TILE)
    return LkaPlan(cp, mix["rows"], mix["warps"], mix["ring"], 5 * cp // 16,
                   -(-m // mix["rows"]), mix_smem, tiles * c // DW_CHANNELS,
                   dw_smem, scratch)


def _affine(bn: Dict[str, torch.Tensor]):
    """An eval BN as (s, b) in fp32, from fp32 or bf16 statistics (the JAX
    wrapper's ``_affine``)."""
    s = bn["scale"].float() / torch.sqrt(bn["var"].float() + EPS)
    return s, bn["bias"].float() - bn["mean"].float() * s


def _bf16_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w on operands rounded to bf16, summed in fp32 (a JAX dot of
    bf16 operands with preferred_element_type fp32)."""
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def _dw(t: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """NHWC depthwise convolution, zero padding, kernel [kh, kw, 1, C]."""
    kh, kw = kernel.shape[:2]
    y = F.conv2d(t.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 padding=(kh // 2, kw // 2), groups=t.shape[-1])
    return y.permute(0, 2, 3, 1)


def lka_block_fused_reference(x: torch.Tensor, p: Dict[str, Any]
                              ) -> torch.Tensor:
    """Plain PyTorch version of :func:`lka_block_fused` (the JAX
    package's ``_lka_xla``; in bf16 the Pallas kernel's rounding
    points)."""
    if x.dtype == torch.bfloat16:
        return _lka_bf16_reference(x, p)
    lka = p["lka"]
    a1, b1 = _affine(p["norm1"])
    t = x * a1 + b1
    a = _dw(_dw(_dw(t, lka["local_conv"]["kernel"]), lka["h_conv"]["kernel"]),
            lka["v_conv"]["kernel"])
    abn, bbn = _affine(lka["bn"])
    a = (a @ lka["pw_conv"]["kernel"][0, 0]) * abn + bbn
    x1 = x + p["scale1"] * (t * torch.sigmoid(a))
    a2, b2 = _affine(p["norm2"])
    hid = F.gelu((x1 * a2 + b2) @ p["ffn_0"]["kernel"][0, 0]
                 + p["ffn_0"]["bias"])
    f = hid @ p["ffn_2"]["kernel"][0, 0] + p["ffn_2"]["bias"]
    return x1 + p["scale2"] * f


def _lka_bf16_reference(x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    """The JAX kernel's arithmetic on bf16 x (``pallas_lka.py:67-111``)."""
    lka = p["lka"]
    x = x.float()
    a1, b1 = _affine(p["norm1"])
    t = x * a1 + b1
    a = _dw(_dw(_dw(t, lka["local_conv"]["kernel"].float()),
                lka["h_conv"]["kernel"].float()),
            lka["v_conv"]["kernel"].float())
    abn, bbn = _affine(lka["bn"])
    a = _bf16_product(a, lka["pw_conv"]["kernel"][0, 0]) * abn + bbn
    x1 = x + p["scale1"].float() * (t * torch.sigmoid(a))
    a2, b2 = _affine(p["norm2"])
    hid = F.gelu(_bf16_product(x1 * a2 + b2, p["ffn_0"]["kernel"][0, 0])
                 + p["ffn_0"]["bias"].float())
    f = _bf16_product(hid, p["ffn_2"]["kernel"][0, 0]) \
        + p["ffn_2"]["bias"].float()
    return (x1 + p["scale2"].float() * f).to(torch.bfloat16)


def fold_lka(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The LKABlock's weights as ``csrc/lka.cu``'s prep folds them, in
    plain PyTorch: s1/b1 (BN1), pw' = pw diag(sbn) with bbn, f0' = diag(s2)
    f0 and c0' = c0 + b2 f0 (BN2 folded into the FFN's first product)."""
    lka = p["lka"]
    s1, b1 = _affine(p["norm1"])
    sbn, bbn = _affine(lka["bn"])
    s2, b2 = _affine(p["norm2"])
    f0 = p["ffn_0"]["kernel"][0, 0]
    return {"s1": s1, "b1": b1, "pw": lka["pw_conv"]["kernel"][0, 0] * sbn,
            "bbn": bbn, "f0": s2[:, None] * f0,
            "c0": p["ffn_0"]["bias"] + b2 @ f0}


def _strided(t: torch.Tensor, name: str, axes, shape, device,
             dtype: torch.dtype = torch.float32):
    """A weight as the 2-D [K, N] its kernel reads: its pointer and the
    strides of K (the merged dims `axes[0]`, outer first) and N (dim
    `axes[1]`), from the tensor's own strides where the dims merge, else
    from a reshaped copy. `shape` is [K, N]."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {device}")
    if t.numel() != shape[0] * shape[1]:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape[0] * shape[1]} elements")
    st, sz = t.stride(), t.shape
    k = axes[0]
    if all(st[k[i]] == st[k[i + 1]] * sz[k[i + 1]] for i in range(len(k) - 1)):
        return t.data_ptr(), st[k[-1]], st[axes[1]]
    v = t.reshape(shape)
    return v.data_ptr(), v.stride(0), v.stride(1)


def lka_block_fused(x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    """One eval LKABlock. x [B, H, W, C] contiguous, fp32 and 16-byte
    aligned or bf16 and 8-byte aligned (every parameter then bf16), C a
    multiple of 4 and <= 128, the hidden <= 2 x (64 or 128); p the tree
    above. Returns [B, H, W, C] in x's dtype."""
    if x.device.type == "cpu":
        return lka_block_fused_reference(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"lka_block_fused: unsupported device {x.device}")
    bf = x.dtype == torch.bfloat16
    dt = x.dtype if bf else torch.float32
    b, h, w, c = x.shape
    ch = p["ffn_0"]["kernel"].shape[-1]
    plan = plan_lka(b, h, w, c, ch, bf16=bf)
    dev = x.device
    cuda.require(x, "x", (b, h, w, c), dev, dt)
    if x.data_ptr() % (8 if bf else 16):
        raise ValueError("lka_block_fused: x must be "
                         f"{8 if bf else 16}-byte aligned")
    lka = p["lka"]
    vectors = []
    for bn_name, bn in (("norm1", p["norm1"]), ("bn", lka["bn"]),
                        ("norm2", p["norm2"])):
        for k in ("scale", "bias", "mean", "var"):
            cuda.require(bn[k], f"{bn_name} {k}", (c,), dev, dt)
            vectors.append(bn[k].data_ptr())
    cuda.require(p["ffn_0"]["bias"], "ffn_0 bias", (ch,), dev, dt)
    cuda.require(p["ffn_2"]["bias"], "ffn_2 bias", (c,), dev, dt)
    cuda.require(p["scale1"], "scale1", (), dev, dt)
    cuda.require(p["scale2"], "scale2", (), dev, dt)
    # kernels [kh, kw, 1, C] and [1, 1, Cin, Cout] as [K, N]
    w5 = _strided(lka["local_conv"]["kernel"], "local_conv", ((0, 1), 3),
                  (25, c), dev, dt)
    wh = _strided(lka["h_conv"]["kernel"], "h_conv", ((1,), 3), (21, c), dev,
                  dt)
    wv = _strided(lka["v_conv"]["kernel"], "v_conv", ((0,), 3), (21, c), dev,
                  dt)
    pw = _strided(lka["pw_conv"]["kernel"], "pw_conv", ((2,), 3), (c, c),
                  dev, dt)
    f0 = _strided(p["ffn_0"]["kernel"], "ffn_0", ((2,), 3), (c, ch), dev, dt)
    f2 = _strided(p["ffn_2"]["kernel"], "ffn_2", ((2,), 3), (ch, c), dev, dt)
    scratch = torch.empty(plan.scratch_floats, device=dev)
    out = torch.empty_like(x)
    entry = (cuda.library().ff_lka_block_bf16 if bf
             else cuda.library().ff_lka_block)
    err = entry(
        x.data_ptr(), *vectors, *w5, *wh, *wv, *pw, *f0,
        p["ffn_0"]["bias"].data_ptr(), *f2, p["ffn_2"]["bias"].data_ptr(),
        p["scale1"].data_ptr(), p["scale2"].data_ptr(), scratch.data_ptr(),
        plan.scratch_floats, out.data_ptr(), b, h, w, c, ch,
        cuda.stream(x))
    name = "lka_block_fused" + (".bf16" if bf else "")
    cuda.check(err, name)
    cuda.launch_counts[name] += 1
    return out
