"""Weights in the order ``csrc/bf16_wgmma.cuh``'s GEMM reads them, laid out
once per module and cached, and the plans of the kernels built on it.

The GEMM (the bf16 qkv window attention's two projections, TPU #11, the
bf16 GRL qkv projection, #12, the bf16 NAFBlock's four products, #16, and
the bf16 fused FFN's two, #14) streams a weight from device memory in
stages of 32 of K by bulk copies, each stage one contiguous piece that
wgmma reads from shared memory as it lands: for each chunk of
``bn`` output columns, for each 16 of K, the chunk's 8-column groups, each
group's two 8-wide halves of K one core matrix (8 columns x 8 values, 128
bytes) apart. :func:`weight_layout` builds that order from a weight
[K, N] ([in, out], the JAX layout), K padded to 32 and N to whole chunks
with zeros; :func:`weight_layouts` caches it per weight tensor, so a call
launches no weight pass. :func:`chunk_cols` is the GEMM's choice of
``bn``; :func:`segment_layout` pads each column segment of a weight to a
chunk of its own (GRL's bf16 q | k | v projection, #12, one output a
chunk). The bf16 CAB's two 3x3 convs (#15) read their weights tap by tap
from :func:`conv_layout` (cached by :func:`conv_layouts`) and their A
operand from a staged halo through shifted descriptors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.utils.weak as weak

__all__ = ["K_STAGE", "chunk_cols", "weight_layout", "weight_layouts",
           "segment_cols", "segment_layout", "segment_layouts",
           "conv_layout", "conv_layouts", "clear_weight_layouts",
           "NafBf16Plan", "plan_nafblock_bf16", "QkvBf16Plan",
           "plan_qkv_bf16", "FfnBf16Plan", "plan_ffn_bf16", "ffn_up_cols",
           "ffn_down_cols", "CabBf16Plan", "plan_cab_bf16"]

K_STAGE = 32          # K a ring stage (two wgmma k16 steps)
CHUNKS = (96, 64)     # #11's chunk widths (wgmma m64nBNk16)
QKV_MAX_K = 640       # csrc/window_attention_qkv.cu: kQkvMaxK


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def chunk_cols(n: int) -> int:
    """The chunk width of #11's N-column products (``bw_cols``): 64 where
    it pads N less than 96, else 96. (The NAFBlock's products take 128,
    or 64 at C 64.)"""
    return 64 if _up(n, 64) < _up(n, 96) else 96


def weight_layout(w: torch.Tensor, bn: int, interleave: bool = False
                  ) -> torch.Tensor:
    """w [K, N] in the GEMM's order, [N_p / bn, K_p / 16, bn / 8, 2, 8, 8]
    (K_p = K padded to 32, N_p to bn): element [c, kk, g, h, i, e] is w[k,
    n] with k = 16 kk + 8 h + e and n = c bn + 8 g + i, zero past K or N.
    With ``interleave`` (N even) column n is first taken from w's column
    n / 2 + (n % 2) N / 2, so that a gate's two halves land side by side
    (columns 2j and 2j + 1 are j and N / 2 + j: the NAFBlock's
    SimpleGates)."""
    k, n = w.shape
    if interleave:
        w = torch.stack([w[:, :n // 2], w[:, n // 2:]], -1).reshape(k, n)
    kp, np_ = _up(k, K_STAGE), _up(n, bn)
    wt = w.new_zeros(np_, kp)
    wt[:n, :k] = w.t()
    return wt.view(np_ // bn, bn // 8, 8, kp // 16, 2, 8).permute(
        0, 3, 1, 4, 2, 5).contiguous()


def segment_cols(width: int) -> int:
    """The chunk width of a segment `width` columns wide (``grl_qkv_cols``):
    the narrowest instantiated wgmma width (48, 64, 96, 128) that holds
    it."""
    if width > 128:
        raise ValueError(f"segment of {width} columns: at most 128")
    return next(bn for bn in (48, 64, 96, 128) if bn >= width)


def segment_layout(w: torch.Tensor, segs: int) -> torch.Tensor:
    """w [K, segs x width] in the GEMM's order with each of its `segs`
    column segments padded to its own chunk of ``segment_cols(width)``
    columns: chunk s holds w[:, s width:(s + 1) width], then zeros, so one
    chunk's sums are exactly one output's (GRL's q | k | v halves, #12)."""
    k, n = w.shape
    width = n // segs
    bn = segment_cols(width)
    wp = w.new_zeros(k, segs * bn)
    wp.view(k, segs, bn)[:, :, :width] = w.reshape(k, segs, width)
    return weight_layout(wp, bn)


def segment_layouts(w: torch.Tensor, segs: int) -> torch.Tensor:
    """:func:`segment_layout` of w, cached as :func:`weight_layouts` is
    (GRL's MixedAttention hands the view ``wqkv.t()`` of its parameter)."""
    return _cached(w, ("segments", segs), lambda t: segment_layout(t, segs))


def conv_layout(w: torch.Tensor, bn: int) -> torch.Tensor:
    """A 3x3 conv's weight w [3, 3, Cin, Cout] (HWIO) in the order the bf16
    CAB's convs stream it, [Cout_p / bn, Cin_p / 16, 9, bn / 8, 2, 8, 8]
    (Cin_p = Cin padded to 16, Cout_p to bn): element [c, kk, tap, g, h, i,
    e] is w[tap // 3, tap % 3, k, n] with k = 16 kk + 8 h + e and n = c bn +
    8 g + i, zero past Cin or Cout. For each chunk of bn output channels
    and each 16 input channels, the nine taps' B operands lie side by side
    (bn x 32 bytes each, wgmma's K-major core matrices): conv1 streams a
    16-channel slice of all nine taps a stage, conv2 three taps (one dy)."""
    kh, kw, cin, cout = w.shape
    cinp, coutp = _up(cin, 16), _up(cout, bn)
    wt = w.new_zeros(kh * kw, coutp, cinp)
    wt[:, :cout, :cin] = w.reshape(kh * kw, cin, cout).transpose(1, 2)
    return wt.view(kh * kw, coutp // bn, bn // 8, 8, cinp // 16, 2, 8
                   ).permute(1, 4, 0, 2, 5, 3, 6).contiguous()


# the cached layouts: a table for each weight's root tensor (the one its
# views are cut from), dropped with it
_LAYOUTS = weak.WeakIdKeyDictionary()


def _root(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


def _cached(w: torch.Tensor, kind: tuple, build) -> torch.Tensor:
    """build(w.detach()), cached as :func:`weight_layouts` describes under
    `kind` (the layout's function and parameters)."""
    if w.is_inference():
        return build(w)
    root = _root(w)
    table = _LAYOUTS.get(root)
    if table is None:
        table = _LAYOUTS[root] = {}
    key = (w.storage_offset(), tuple(w.shape), w.stride(), kind)
    state = (w.data_ptr(), w.dtype, w.device, w._version)
    hit = table.get(key)
    if hit is not None and hit[1] == state:
        return hit[2]
    layout = build(w.detach())
    table[key] = (w.untyped_storage(), state, layout)
    return layout


def conv_layouts(w: torch.Tensor, bn: int) -> torch.Tensor:
    """:func:`conv_layout` of w, cached as :func:`weight_layouts` is (the
    CAB hands views of its conv weights, ``models/grl.py:CAB``)."""
    return _cached(w, ("conv", bn), lambda t: conv_layout(t, bn))


def weight_layouts(w: torch.Tensor, bn: int, interleave: bool = False
                   ) -> torch.Tensor:
    """:func:`weight_layout` of w, built on first use and reused while w
    stays as it was.

    Keyed as ``ops/selective_scan.py:chain_proj_operands`` keys its
    weights: the entries of one tensor live in a table keyed by its root
    (the tensor its views are cut from) and go with it; an entry is found
    by the view's offset, shape and stride and the layout's parameters, and
    taken only if w's address, dtype, device and version counter are as
    when it was built (an in-place update, ``load_state_dict`` included,
    bumps the counter; a dtype cast or ``.data`` swap moves the address).
    The entry holds w's storage, so no other tensor can take its memory
    while it lives. A write that bypasses the version counter (through
    ``.data``) is not seen: call :func:`clear_weight_layouts` after one.
    Callers hand views of their parameters (a view made under
    ``torch.inference_mode`` is still a normal tensor with a counter); a
    tensor made under inference mode has no counter and is laid out anew
    each call."""
    return _cached(w, ("gemm", bn, bool(interleave)),
                   lambda t: weight_layout(t, bn, interleave))


def clear_weight_layouts() -> None:
    """Drop every cached layout: the next call of each module lays its
    weights out anew. Needed only after a write that bypasses the
    weights' version counters (``p.data.copy_(...)``)."""
    _LAYOUTS.clear()


class QkvBf16Plan(NamedTuple):
    """How ``csrc/window_attention_qkv.cu`` runs its bf16 projections."""
    bn_qkv: int         # chunk width of x Wqkv (3C columns)
    bn_proj: int        # of attn Wproj (C columns)
    scratch_bytes: int  # q, k, v and the attention's output, bf16
    bytes_per_pixel: int  # device memory the three launches move a pixel


def plan_qkv_bf16(m: int, cin: int, c: int) -> QkvBf16Plan:
    """The bf16 call's chunks and scratch for `m` pixels of `cin`
    channels projected to q | k | v of `c` each."""
    if cin % 2 or c % 2 or max(_up(cin, K_STAGE), _up(c, K_STAGE)) > \
            QKV_MAX_K:
        raise ValueError(f"window_attention_qkv_nhwc (bf16): Cin={cin}, "
                         f"C={c} refused (even, at most {QKV_MAX_K})")
    piece = _up(2 * m * c, 256)
    # x in; q, k, v out and back; the attention's output out and back; out
    moved = 2 * cin + 2 * (6 * c + 2 * c) + 2 * c
    return QkvBf16Plan(chunk_cols(3 * c), chunk_cols(c), 4 * piece, moved)


class NafBf16Plan(NamedTuple):
    """How ``csrc/nafblock.cu`` runs a bf16 NAFBlock call."""
    fused: bool         # C <= 256: two fused launches; else nine
    out_tile: tuple     # the pool's tile (rows, columns): pass A's output
    tiles: int          # tiles an image (the pool partials' middle axis)
    bn1: int            # conv1's chunk width (interleaved)
    bn: int             # conv3's, conv4's (interleaved) and conv5's
    scratch_bytes: int
    bytes_per_pixel: int  # device memory a pixel, by the source's count
    conv1_rows: float   # conv1's rows per output pixel (a halo's, fused)


def plan_nafblock_bf16(h: int, w: int, c: int, batch: int = 1
                       ) -> NafBf16Plan:
    """The plan of a bf16 call on `batch` images of h x w pixels, `c`
    channels (``ff_nafblock_bf16_tiles``, ``naf_bf16_layout``). At C <=
    256 pass A is one launch over 8 x 16 halo tiles (6 x 14 out) and pass
    B one launch; above, LN1, GS and LN2 rows passes write A operands in
    the tiled order for conv1, conv3, conv4 and conv5 on the GEMM that
    streams both operands, u goes through device memory to a depthwise
    kernel over 8 x 8 tiles."""
    if c % 2 or c > 1024:
        raise ValueError(f"nafblock_fused (bf16): C={c} must be even and at "
                         "most 1024")
    m = batch * h * w
    fused = c <= 256
    tile = (6, 14) if fused else (8, 8)
    tiles = -(-h // tile[0]) * -(-w // tile[1])
    tiled = 2 * _up(m, 128) * _up(c, K_STAGE)  # an A in the tiled order
    scratch = _up(4 * m * c, 256)
    if not fused:  # y, two tiled A operands, u
        scratch += (_up(4 * m * c, 256) + 2 * _up(tiled, 256)
                    + _up(8 * m * c, 256))
    if fused:  # x in, g out (fp32); g and x in, out out
        moved = 2 * c + 4 * c + 4 * c + 2 * c + 2 * c
    else:  # and LN1, GS, T2 (bf16) and u, y (fp32) out and in, g2 too
        moved = (2 * c + 2 * 2 * c + 2 * 8 * c + 4 * c  # pass A
                 + 4 * c + 2 * c + 2 * c + 2 * c + 4 * c  # GS, conv3
                 + 4 * c + 2 * c + 2 * c + 2 * c  # T2, conv4
                 + 2 * c + 4 * c + 2 * c)  # conv5
    return NafBf16Plan(fused, tile, tiles, 128, 64 if c <= 64 else 128,
                       scratch, moved, 128 / 84 if fused else 1.0)


# csrc/fused_mlp.cu's bf16 launches: rows a block (two consumer
# warpgroups), the two launches' rings, the widest C (the down product's
# sums in registers)
FFN_ROWS, FFN_UP_ROWS = 128, 64
FFN_UP_STAGES, FFN_DOWN_STAGES = 4, 4
FFN_MAX_C = 320
BW_HEAD = 128          # the ring's barriers, at the head of shared memory
SMEM_LIMIT = 227 * 1024
SM_SMEM = 233472       # an SM's shared memory, 1 KB of it reserved a block


def ffn_up_cols(ch: int) -> int:
    """The up launch's hidden chunk (``ffn_up_cols``): the least padding
    of Ch among 128, 96 and 64, the wider on a tie."""
    return min((128, 96, 64), key=lambda n: _up(ch, n))


def ffn_down_cols(c: int) -> tuple:
    """The down launch's (BN2, NCH) (``ffn_down_cols``): NCH chunks of BN2
    columns spanning C with at most 160 sums a thread, the least padding,
    the wider BN2 on a tie."""
    opts = [(bn, -(-c // bn)) for bn in (128, 96, 64)
            if -(-c // bn) * bn // 2 <= 160]
    return min(opts, key=lambda o: o[0] * o[1])


class FfnBf16Plan(NamedTuple):
    """How ``csrc/fused_mlp.cu`` runs a bf16 call: two launches, 64-row
    blocks (two an SM) up, 128-row blocks down."""
    bn1: int            # the up launch's hidden chunk
    bn2: int            # the down launch's chunk width
    nch2: int           # ... and its chunks (all of C a block)
    kp1: int            # C padded to 32: the up product's K
    kp2: int            # Ch padded to 32: H's columns, the down's K
    scratch_bytes: int  # H in the tiled order, 128-row blocks
    up_smem: int
    down_smem: int
    blocks: int         # 128-row blocks (the down launch; the up's twice)


def plan_ffn_bf16(m: int, c: int, ch: int) -> FfnBf16Plan:
    """The plan of a bf16 call on `m` rows of `c` channels with `ch` hidden
    units (``ff_fused_mlp_bf16_scratch_bytes``, ``ff_fused_mlp_bf16_smem``
    compute the same)."""
    if c % 2 or c > FFN_MAX_C:
        raise ValueError(f"fused_mlp_block (bf16): C={c} must be even and "
                         f"at most {FFN_MAX_C}")
    bn1 = ffn_up_cols(ch)
    bn2, nch2 = ffn_down_cols(c)
    kp1, kp2 = _up(c, K_STAGE), _up(ch, K_STAGE)
    rows = _up(m, FFN_ROWS)
    up = (BW_HEAD + FFN_UP_STAGES * bn1 * 64 + FFN_UP_ROWS * kp1 * 2
          + 2 * FFN_UP_ROWS * bn1 * 2 + _up(ch, bn1) * 4 + FFN_UP_ROWS * 8
          + 2 * kp1 * 4)
    down = (BW_HEAD + FFN_DOWN_STAGES * (8192 + nch2 * bn2 * 64)
            + FFN_ROWS * c * 2 + 3 * nch2 * bn2 * 4 + 8)
    return FfnBf16Plan(bn1, bn2, nch2, kp1, kp2, rows * kp2 * 2, up, down,
                       rows // FFN_ROWS)


# csrc/cab.cu's bf16 convs: an m-tile is 64 consecutive pixels of an image
# row; conv1 takes 4 rows a block (3 at N 64: 96 sums a thread), conv2 6
# (two at a time); the rings' stages; conv2's output chunk; the widest C
# (the LN statistics' registers) and Cr (conv1's N)
CAB_SEG = 64
CAB_ROWS = (4, 6)
CAB_STAGES = (3, 4)
CAB_SLOTS = 3          # conv1's staged halo slices in flight
CAB_BN2 = 96
CAB_MAX_C, CAB_MAX_CR = 256, 64


class CabBf16Plan(NamedTuple):
    """How ``csrc/cab.cu`` runs a bf16 call: conv1, conv2, the squeeze in
    PyTorch, the apply pass."""
    bn1: int            # conv1's N: Cr padded to 48 or 64 (U's row, conv2's K)
    cinp1: int          # C padded to 16: conv1's K a tap
    nch2: int           # conv2's chunks of 96 output channels
    rows: tuple         # output rows a block, conv1 (4, 3 at N 64), conv2
    tiles1: int         # conv1's blocks an image
    tiles2: int         # conv2's (the partials' middle axis)
    halo: tuple         # halo pixels a block, conv1 and conv2
    reread: tuple       # halo pixels read per output pixel, conv1 and conv2
    smem: tuple         # bytes of shared memory a block, conv1 and conv2
    blocks_per_sm: tuple
    scratch_bytes: int  # U, [M][bn1] bf16


def plan_cab_bf16(h: int, w: int, c: int, cr: int, batch: int = 1
                  ) -> CabBf16Plan:
    """The plan of a bf16 call on `batch` images of h x w pixels, C
    channels, C/cr = `cr` in the middle (``ff_cab_bf16_tiles``,
    ``ff_cab_bf16_smem`` and ``ff_cab_bf16_scratch_bytes`` compute the
    same)."""
    if c % 2 or c > CAB_MAX_C or cr > CAB_MAX_CR:
        raise ValueError(f"cab_fused (bf16): C={c} must be even and at most "
                         f"{CAB_MAX_C}, C/cr={cr} at most {CAB_MAX_CR}")
    bn1 = 48 if cr <= 48 else 64
    rows = (CAB_ROWS[0] - (bn1 == 64), CAB_ROWS[1])
    cinp1, np2 = _up(c, 16), _up(c, CAB_BN2)
    halo = tuple((r + 2) * (CAB_SEG + 2) for r in rows)
    smem1 = (BW_HEAD + CAB_STAGES[0] * 9 * 16 * bn1 * 2
             + CAB_SLOTS * halo[0] * 32 + 2 * CAB_SLOTS * 8 + halo[0] * 8
             + 2 * cinp1 * 4 + bn1 * 4)
    smem2 = (BW_HEAD + CAB_STAGES[1] * 3 * 16 * CAB_BN2 * 2
             + halo[1] * bn1 * 2 + 2 * np2 * 4 + 4 * CAB_BN2 * 4)
    tiles = tuple(-(-h // r) * -(-w // CAB_SEG) for r in rows)
    return CabBf16Plan(
        bn1, cinp1, np2 // CAB_BN2, rows, *tiles, halo,
        tuple(p / (r * CAB_SEG) for p, r in zip(halo, rows)),
        (smem1, smem2), tuple(SM_SMEM // (s + 1024) for s in (smem1, smem2)),
        batch * h * w * bn1 * 2)

