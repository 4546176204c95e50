"""Weights in the order ``csrc/bf16_wgmma.cuh``'s GEMM reads them, laid out
once per module and cached.

The GEMM (the bf16 qkv window attention's two projections, TPU #11, and
the bf16 NAFBlock's four products, #16) streams a weight from device
memory in stages of 32 of K by bulk copies, each stage one contiguous
piece that wgmma reads from shared memory as it lands: for each chunk of
``bn`` output columns, for each 16 of K, the chunk's 8-column groups, each
group's two 8-wide halves of K one core matrix (8 columns x 8 values, 128
bytes) apart. :func:`weight_layout` builds that order from a weight
[K, N] ([in, out], the JAX layout), K padded to 32 and N to whole chunks
with zeros; :func:`weight_layouts` caches it per weight tensor, so a call
launches no weight pass. :func:`chunk_cols` is the GEMM's choice of
``bn``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.utils.weak as weak

__all__ = ["K_STAGE", "chunk_cols", "weight_layout", "weight_layouts",
           "clear_weight_layouts", "NafBf16Plan", "plan_nafblock_bf16",
           "QkvBf16Plan", "plan_qkv_bf16"]

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


# the cached layouts: a table for each weight's root tensor (the one its
# views are cut from), dropped with it
_LAYOUTS = weak.WeakIdKeyDictionary()


def _root(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


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
    if w.is_inference():
        return weight_layout(w, bn, interleave)
    root = _root(w)
    table = _LAYOUTS.get(root)
    if table is None:
        table = _LAYOUTS[root] = {}
    key = (w.storage_offset(), tuple(w.shape), w.stride(), bn,
           bool(interleave))
    state = (w.data_ptr(), w.dtype, w.device, w._version)
    hit = table.get(key)
    if hit is not None and hit[1] == state:
        return hit[2]
    layout = weight_layout(w.detach(), bn, interleave)
    table[key] = (w.untyped_storage(), state, layout)
    return layout


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
