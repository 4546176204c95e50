"""Fused transformer FFN half: the CUDA kernel and its plain version.

Counterpart of ``freqfusion_tpu/ops/pallas_mlp.py:fused_mlp_block``, with
its argument layout (w1 [C, Ch], w2 [Ch, C]) and its two norm orders:

    pre-norm  (DRCT)  out = x + res_scale * fc2(gelu(fc1(LN(x))))
    post-norm (GRL)   out = x + res_scale * LN(fc2(gelu(fc1(x))))

GELU is exact (erf). A CPU tensor goes to the plain version; a CUDA tensor
goes to ``csrc/fused_mlp.cu`` (both products in 3xTF32 on the tensor
cores, the hidden through a scratch that :func:`plan_fused_mlp` sizes), or
the call raises. bf16 tensors (the bf16 expert mode) go to the bf16 plain
version or to the file's bf16 kernels (two launches on ``wgmma``,
``csrc/bf16_wgmma.cuh``, the weights laid out once per module by
``ops/wgmma.py:weight_layouts``, planned by ``plan_ffn_bf16``), both with
the JAX kernel's rounding points, counted as ``fused_mlp_block.bf16``.
The weights may be views (the models hand ``fc1.weight.t()``): the bf16
kernels read only their cached layouts, the fp32 kernel a contiguous copy
of a view.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import cuda, wgmma
from .attention import _bf16
from .tf32_gemm import BK, SMEM_LIMIT, _ring_bytes, _round_up

__all__ = ["fused_mlp_block", "fused_mlp_block_reference", "plan_fused_mlp",
           "MlpPlan"]

MAX_CHANNELS = 384  # the down product's output row lives in registers
# csrc/fused_mlp.cu's tiles (K columns a stage is tf32_gemm.BK): rows of an
# up block (T and H have their rows padded to UP_ROWS) and its hidden
# columns, whichever of UP_COLS pads Ch less (the wider on a tie); rows of a
# down block (which spans all of C); the n-tiles a warp of the down product
# is instantiated for (4 warps across C); stages in the rings
UP_ROWS, UP_COLS = 128, (64, 128)
DOWN_ROWS = 64
DOWN_TILES = (2, 4, 6, 8, 9, 10, 12)
UP_STAGES, DOWN_STAGES = 4, 3


class MlpPlan(NamedTuple):
    """How ``csrc/fused_mlp.cu`` runs one call (its ``ffn_plan``)."""
    kp1: int             # C padded to BK: the up product's K
    upn: int             # hidden columns an up block (of UP_COLS)
    np1: int             # Ch padded to upn: W1's split columns
    kp2: int             # Ch padded to BK: the down product's K, H's stride
    nt: int              # n-tiles a warp of the down product
    cp: int              # 32 nt: the down product's padded N (>= C)
    scratch_floats: int  # W1, W2 split; H, T = LN(x): [Mp, kp2], [Mp, kp1]
    up_smem: int         # bytes of shared memory an up block takes
    down_smem: int       # ... a down block
    up_blocks: int
    down_blocks: int


def plan_fused_mlp(m: int, c: int, ch: int) -> MlpPlan:
    """The padded extents, scratch and shared memory of a call on `m` rows
    of `c` channels with `ch` hidden units."""
    need = -(-c // 32)
    nt = next((n for n in DOWN_TILES if n >= need), None)
    if nt is None or c > MAX_CHANNELS:
        raise ValueError(f"fused_mlp_block: C={c} > {MAX_CHANNELS}")
    upn = min(UP_COLS[::-1], key=lambda n: _round_up(ch, n))
    kp1, np1 = _round_up(c, BK), _round_up(ch, upn)
    kp2, cp = _round_up(ch, BK), 32 * nt
    mp = _round_up(m, UP_ROWS)
    return MlpPlan(kp1, upn, np1, kp2, nt, cp,
                   2 * kp1 * np1 + 2 * kp2 * cp + mp * (kp2 + kp1),
                   _ring_bytes(UP_ROWS, upn, UP_STAGES),
                   _ring_bytes(DOWN_ROWS, cp, DOWN_STAGES),
                   (np1 // upn) * (mp // UP_ROWS), -(-m // DOWN_ROWS))


def _fused_mlp_block_bf16(x, w1, b1, w2, b2, ln_scale, ln_bias,
                          prenorm: bool, res_scale: float,
                          eps: float) -> torch.Tensor:
    """bf16 operands, the JAX kernel's rounding points
    (pallas_mlp.py:_kernel): LN in fp32, T rounded; T W1 in fp32 plus b1,
    GELU, rounded; H W2 + b2 (and the post-norm LN) in fp32; the residual
    rounded once."""
    f = x.float()
    c = x.shape[-1]
    ls, lb = ln_scale.float(), ln_bias.float()
    t = F.layer_norm(f, (c,), ls, lb, eps) if prenorm else f
    h = _bf16(F.gelu(_bf16(t) @ w1.float() + b1.float()))
    y = h @ w2.float() + b2.float()
    if not prenorm:
        y = F.layer_norm(y, (c,), ls, lb, eps)
    return (f + res_scale * y).to(torch.bfloat16)


def fused_mlp_block_reference(x, w1, b1, w2, b2, ln_scale, ln_bias,
                              prenorm: bool = True, res_scale: float = 1.0,
                              eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_mlp_block` (in bf16 for a
    bf16 x, see :func:`_fused_mlp_block_bf16`)."""
    if x.dtype == torch.bfloat16:
        return _fused_mlp_block_bf16(x, w1, b1, w2, b2, ln_scale, ln_bias,
                                     prenorm, res_scale, eps)
    c = x.shape[-1]
    t = F.layer_norm(x, (c,), ln_scale, ln_bias, eps) if prenorm else x
    y = F.gelu(t @ w1 + b1) @ w2 + b2
    if not prenorm:
        y = F.layer_norm(y, (c,), ln_scale, ln_bias, eps)
    return x + res_scale * y


def fused_mlp_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor,
                    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                    prenorm: bool = True, res_scale: float = 1.0,
                    eps: float = 1e-5) -> torch.Tensor:
    """x [..., C] (any leading shape); w1 [C, Ch]; b1 [Ch]; w2 [Ch, C];
    b2, ln_scale, ln_bias [C]. Returns x + res_scale * FFN-branch(x) with
    the norm order above, shaped like x."""
    if x.device.type == "cpu":
        return fused_mlp_block_reference(x, w1, b1, w2, b2, ln_scale,
                                         ln_bias, prenorm, res_scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_block: unsupported device {x.device}")
    if x.dtype == torch.bfloat16:
        return _fused_mlp_block_bf16_kernel(x, w1, b1, w2, b2, ln_scale,
                                            ln_bias, prenorm, res_scale, eps)
    c, ch = x.shape[-1], w1.shape[-1]
    m = x.numel() // c
    plan = plan_fused_mlp(m, c, ch)
    dev = x.device
    w1, w2 = w1.contiguous(), w2.contiguous()
    cuda.require(x, "x", x.shape, dev)
    cuda.require(w1, "w1", (c, ch), dev)
    cuda.require(b1, "b1", (ch,), dev)
    cuda.require(w2, "w2", (ch, c), dev)
    for name, t in (("b2", b2), ("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        cuda.require(t, name, (c,), dev)
    out = torch.empty_like(x)
    scratch = torch.empty(plan.scratch_floats, device=dev,
                          dtype=torch.float32)
    err = cuda.library().ff_fused_mlp(
        *(cuda.ptr(t) for t in (x, w1, b1, w2, b2, ln_scale, ln_bias, out,
                                scratch)),
        plan.scratch_floats, m, c, ch, int(prenorm), float(res_scale),
        float(eps), cuda.stream(x))
    cuda.check(err, "fused_mlp_block")
    cuda.launch_counts["fused_mlp_block"] += 1
    return out


def _fused_mlp_block_bf16_kernel(x, w1, b1, w2, b2, ln_scale, ln_bias,
                                 prenorm: bool, res_scale: float,
                                 eps: float) -> torch.Tensor:
    """The bf16 kernels: every operand bf16, C even up to 320, any Ch; w1
    and w2 may be views (read through their cached layouts)."""
    bf, dev = torch.bfloat16, x.device
    c, ch = x.shape[-1], w1.shape[-1]
    m = x.numel() // c
    plan = wgmma.plan_ffn_bf16(m, c, ch)
    cuda.require(x, "x", x.shape, dev, bf)
    cuda.require(w1, "w1", (c, ch), dev, bf, contiguous=False)
    cuda.require(b1, "b1", (ch,), dev, bf)
    cuda.require(w2, "w2", (ch, c), dev, bf, contiguous=False)
    for name, t in (("b2", b2), ("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        cuda.require(t, name, (c,), dev, bf)
    w1l = wgmma.weight_layouts(w1, plan.bn1)
    w2l = wgmma.weight_layouts(w2, plan.bn2)
    out = torch.empty_like(x)
    scratch = torch.empty(plan.scratch_bytes, device=dev, dtype=torch.uint8)
    err = cuda.library().ff_fused_mlp_bf16(
        *(cuda.ptr(t) for t in (x, w1l, b1, w2l, b2, ln_scale, ln_bias, out,
                                scratch)),
        plan.scratch_bytes, m, c, ch, plan.bn1, plan.bn2, int(prenorm),
        float(res_scale), float(eps), cuda.stream(x))
    cuda.check(err, "fused_mlp_block (bf16)")
    cuda.launch_counts["fused_mlp_block.bf16"] += 1
    return out
