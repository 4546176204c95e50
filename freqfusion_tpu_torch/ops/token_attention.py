"""Per-pixel token attention (the fusion net's band and expert attention),
with its plain version.

Counterpart of ``freqfusion_tpu/ops/pallas_token_attention.py``: torch
``nn.MultiheadAttention`` in eval over a short token axis (T <= 16),
independently at every pixel, in- and out-projections included and the
residual left to the caller. The weights come in the JAX wrapper's
[in, out] layout (``in_proj_w`` [E, 3E], ``out_w`` [E, E]), of any
strides: the port's ``TokenMultiheadAttention`` holds torch's
``in_proj_weight`` [3E, E] and ``out_proj.weight`` [E, E] and hands their
transposed views (strides (1, E)), which the kernel reads as they are. A
CPU tensor goes to the plain version; a CUDA tensor goes to
``csrc/token_attention.cu`` (a launch that lays the weights out in
fragment order, the q-scale folded in, then the fused kernel: both
projections in 3xTF32 on the tensor cores around the softmax on the fp32
cores) or the call raises.

bf16 operands (the fusion net under ``fusion_dtype`` bf16) take the JAX
kernel's rounding points, in the plain version and in the bf16 kernel
(``ff_token_attention_bf16``, counted as ``token_attention.bf16``: both
projections on bf16 tensor-core products, the attention on the fp32
cores): the q-scale folded into Win's q columns and bias in fp32 and
rounded; q | k | v rounded after an fp32 bias add; the logits fp32 sums
of the exact q k products; the softmax in fp32, not rounded; P V summed
in fp32 and rounded a head; the output rounded once after an fp32 bias
add.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import cuda
from .attention import _bf16
from .tf32_gemm import SMEM_LIMIT

__all__ = ["token_attention", "token_attention_reference",
           "plan_token_attention", "TokenAttentionPlan"]

# csrc/token_attention.cu
MAX_ROWS = 128     # rows a tile: 4 row groups of warps, 32 rows each
MAX_T, MAX_E = 16, 160
SM_SMEM = 233472   # shared memory an SM has for blocks (228 KB)
BLOCK_RESERVED = 1024  # the runtime's reserve a block


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class TokenAttentionPlan(NamedTuple):
    """How ``csrc/token_attention.cu`` runs a call (its ``ta_plan``): a
    persistent grid of blocks of 4 x `wc` warps in `teams` teams walks
    `tiles` tiles, each team `pixels` whole pixels of a tile (`rows`
    rows, padded to `rows_pad`), `heads` heads a group (hd padded to
    `hdq`); every tile streams all the laid-out weights from L2 through a
    ring of `stages` pieces that the teams share."""
    wc: int             # warp column groups: 2 (8 warps) or 4 (16)
    heads: int          # heads a group: wc / 2
    hdq: int            # head dim padded to 16
    groups: int         # head groups (the last padded with zero heads)
    chunks: int         # q|k|v pieces a group, and out pieces
    kp: int             # E padded to 8: the q|k|v product's K
    np: int             # E padded to the out product's column tiles
    stages: int         # ring stages: 3 at wc 2, 2 at wc 4
    piece_floats: int   # a ring stage: max(kp 24 wc, 8 wc np)
    teams: int          # 2, or 1 where two teams' rows do not fit
    pixels: int         # whole pixels a team takes of a tile
    rows: int           # their rows (pixels T)
    rows_pad: int       # rows padded to 32 (a warp's two m-tiles)
    tiles: int          # tiles of teams x pixels covering P
    smem: int           # bytes of shared memory a block takes
    blocks_per_sm: int  # blocks an SM's shared memory holds
    weight_floats: int  # the laid-out weights: groups hdq heads (3 kp + np)
    scratch_floats: int  # those and the biases (groups 3 hdq heads + np)
    l2_weight_bytes: int  # weight bytes the tiles pull from L2 a call


@functools.lru_cache(maxsize=64)
def plan_token_attention(p: int, t: int, e: int,
                         heads: int) -> TokenAttentionPlan:
    """The plan of a call on x [p, t, e] with `heads` heads: 16 warps and
    two heads a group where heads are 16 wide or less and E > 64 (8 warps
    would then hold one block an SM: the out sums' registers), else 8 and
    one; two teams of 64 rows or less where they fit, else one of 128 or
    less: the first of (2 teams, 64 or 32 rows a team; 1 team, 128 .. 32)
    whose shared memory fits (the ring, the x tile [rows_pad][kp + 8] and
    the q|k|v tile [rows_pad][3 hdq heads + 8] a team, an mbarrier and a
    counter a stage): 2 x 64 rows wherever hd <= 16."""
    hd = e // heads
    wc = 4 if hd <= 16 and e > 64 else 2
    g, hdq = wc // 2, _round_up(hd, 16)
    gw = g * hdq
    groups, chunks = -(-heads // g), gw // (8 * wc)
    kp = _round_up(e, 8)
    np_ = 64 if e <= 64 else 128 if e <= 128 else 160
    stages = 3 if wc == 2 else 2
    qkv, out = 24 * wc * kp, 8 * wc * np_
    piece = max(qkv, out)
    fits = False
    for teams in (2, 1):
        for cap in range(MAX_ROWS // teams, 0, -32):
            pixels = cap // t
            rows = pixels * t
            rows_pad = _round_up(rows, 32)
            smem = 4 * (stages * piece
                        + teams * rows_pad * (kp + 8 + 3 * gw + 8)) \
                + 16 * stages
            fits = smem <= SMEM_LIMIT
            if fits:
                break
        if fits:
            break
    weights = groups * chunks * (qkv + out)
    tiles = -(-p // (teams * pixels))
    return TokenAttentionPlan(
        wc, g, hdq, groups, chunks, kp, np_, stages, piece, teams, pixels,
        rows, rows_pad, tiles, smem,
        min(2048 // (128 * wc), SM_SMEM // (smem + BLOCK_RESERVED)),
        weights, weights + 3 * groups * gw + np_, 4 * weights * tiles)


def token_attention_reference(x: torch.Tensor, in_proj_w: torch.Tensor,
                              in_proj_b: torch.Tensor, out_w: torch.Tensor,
                              out_b: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """Plain PyTorch: packed projection, per-head softmax attention over
    T, output projection (in bf16 for bf16 x, see
    :func:`_token_attention_bf16`)."""
    if x.dtype == torch.bfloat16:
        return _token_attention_bf16(x, in_proj_w, in_proj_b, out_w, out_b,
                                     num_heads)
    e = x.shape[-1]
    hd = e // num_heads
    q, k, v = F.linear(x, in_proj_w.t(), in_proj_b).chunk(3, dim=-1)
    q, k, v = (t.reshape(*t.shape[:-1], num_heads, hd) for t in (q, k, v))
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) / hd ** 0.5
    out = torch.einsum("...hqk,...khd->...qhd", logits.softmax(-1), v)
    return F.linear(out.reshape(x.shape), out_w.t(), out_b)


def _q_scale(hd: int) -> float:
    """hd ** -0.5 in fp32, as the JAX wrapper computes the folded scale."""
    return float(torch.tensor(float(hd)) ** -0.5)


def _token_attention_bf16(x, in_proj_w, in_proj_b, out_w, out_b,
                          num_heads: int) -> torch.Tensor:
    """bf16 token attention with the JAX kernel's rounding points
    (pallas_token_attention.py): Win's q columns and bias times the
    q-scale in fp32, rounded (:96-105); qkv = bf16(x Win + bin) (:51);
    each logit the fp32 sum of the exact q k products (:57: the source
    rounds each product to bf16 before its fp32 sum, but XLA, whose
    excess-precision rule is on by default, drops that round trip, so the
    kernel as JAX runs it sums the fp32 products; rounding them moves
    ~45% of the outputs by an ulp); the softmax in fp32, not rounded; o =
    bf16(sum of p v in fp32) a head (:58-63); out = bf16(o Wout + bout)
    (:69)."""
    e = x.shape[-1]
    hd = e // num_heads
    fold = torch.ones(3 * e, device=x.device)
    fold[:e] = _q_scale(hd)
    win = _bf16(in_proj_w.float() * fold)
    bin_ = _bf16(in_proj_b.float() * fold)
    qkv = _bf16(x.float() @ win + bin_)
    q, k, v = (t.reshape(*t.shape[:-1], num_heads, hd)
               for t in qkv.chunk(3, dim=-1))          # [..., T, nH, hd]
    logits = (q[..., :, None, :, :] * k[..., None, :, :, :]).sum(-1)
    ex = torch.exp(logits - logits.amax(-2, keepdim=True))  # [.., Tq, Tk, nH]
    o = _bf16(torch.einsum("...qkh,...khd->...qhd",
                           ex / ex.sum(-2, keepdim=True), v))
    out = o.reshape(x.shape) @ _bf16(out_w.float()) + _bf16(out_b.float())
    return out.to(torch.bfloat16)


def _weight(w: torch.Tensor, name: str, shape, device,
            dtype: torch.dtype = torch.float32) -> None:
    if w.device != device or w.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {device}")
    if tuple(w.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(w.shape)}, expected "
                         f"{shape}")


def _token_attention_bf16_kernel(x, in_proj_w, in_proj_b, out_w, out_b,
                                 num_heads: int) -> torch.Tensor:
    """The bf16 kernel: x, the weights (any strides) and the biases bf16.
    T <= 16; E a multiple of 8 and of the heads; head dims 8, 16 or 32."""
    p, t, e = x.shape
    hd = e // num_heads if num_heads > 0 and e % num_heads == 0 else 0
    if not 1 <= t <= MAX_T or e % 8 or hd not in (8, 16, 32) or p < 1:
        raise ValueError(f"token_attention (bf16): T={t} must be 1..16, "
                         f"E={e} a multiple of 8 and of heads={num_heads} "
                         f"with head dims 8, 16 or 32, P={p} positive")
    dev, bf = x.device, torch.bfloat16
    cuda.require(x, "x", (p, t, e), dev, bf)
    _weight(in_proj_w, "in_proj_w", (e, 3 * e), dev, bf)
    _weight(out_w, "out_w", (e, e), dev, bf)
    cuda.require(in_proj_b, "in_proj_b", (3 * e,), dev, bf)
    cuda.require(out_b, "out_b", (e,), dev, bf)
    lib = cuda.library()
    nbytes = lib.ff_token_attention_bf16_scratch_bytes(p, t, e)
    out = torch.empty_like(x)
    scratch = torch.empty(nbytes, device=dev, dtype=torch.uint8)
    err = lib.ff_token_attention_bf16(
        x.data_ptr(), in_proj_w.data_ptr(), *in_proj_w.stride(),
        in_proj_b.data_ptr(), out_w.data_ptr(), *out_w.stride(),
        out_b.data_ptr(), out.data_ptr(), scratch.data_ptr(), nbytes, p, t,
        e, num_heads, _q_scale(hd), cuda.stream(x))
    cuda.check(err, "token_attention (bf16)")
    cuda.launch_counts["token_attention.bf16"] += 1
    return out


def token_attention(x: torch.Tensor, in_proj_w: torch.Tensor,
                    in_proj_b: torch.Tensor, out_w: torch.Tensor,
                    out_b: torch.Tensor, num_heads: int) -> torch.Tensor:
    """x [P, T, E] contiguous; in_proj_w [E, 3E] (q | k | v columns),
    in_proj_b [3E]; out_w [E, E] ([in, out]), out_b [E]; the two weights
    of any strides (views of torch's [out, in] weights go as they are),
    the biases contiguous. Returns out_proj(MHA(x)) before the residual,
    [P, T, E]. fp32 throughout, or all bf16 (the bf16 kernel)."""
    p, t, e = x.shape
    if x.device.type == "cpu":
        return token_attention_reference(x, in_proj_w, in_proj_b, out_w,
                                         out_b, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"token_attention: unsupported device {x.device}")
    if x.dtype == torch.bfloat16:
        return _token_attention_bf16_kernel(x, in_proj_w, in_proj_b, out_w,
                                            out_b, num_heads)
    if not 1 <= t <= MAX_T or e % num_heads or e % 4 or e > MAX_E or p < 1:
        raise ValueError(f"token_attention: T={t} must be 1..16, E={e} at "
                         f"most 160 and a multiple of 4 and of heads="
                         f"{num_heads}, P={p} positive")
    dev = x.device
    cuda.require(x, "x", (p, t, e), dev)
    _weight(in_proj_w, "in_proj_w", (e, 3 * e), dev)
    _weight(out_w, "out_w", (e, e), dev)
    cuda.require(in_proj_b, "in_proj_b", (3 * e,), dev)
    cuda.require(out_b, "out_b", (e,), dev)
    plan = plan_token_attention(p, t, e, num_heads)
    out = torch.empty_like(x)
    scratch = torch.empty(plan.scratch_floats, device=dev)
    err = cuda.library().ff_token_attention(
        x.data_ptr(), in_proj_w.data_ptr(), *in_proj_w.stride(),
        in_proj_b.data_ptr(), out_w.data_ptr(), *out_w.stride(),
        out_b.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        plan.scratch_floats, p, t, e, num_heads, cuda.stream(x))
    cuda.check(err, "token_attention")
    cuda.launch_counts["token_attention"] += 1
    return out
