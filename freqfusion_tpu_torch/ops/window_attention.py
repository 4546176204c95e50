"""Swin-style window machinery on NHWC tensors (plain PyTorch).

Counterpart of ``freqfusion_tpu/ops/window_attention.py``: window
partition/reverse, the relative-position index and the shifted-window
masks (numpy precomputes per static shape, moved to the device once), and
the plain batched window attention that the kernels are held against.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

__all__ = [
    "window_partition", "window_reverse", "relative_position_index",
    "shifted_window_mask", "multi_head_window_attention", "device_table",
    "table_as",
]


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, ws*ws, C] (row-major windows)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int
                   ) -> torch.Tensor:
    """[B*nW, ws*ws, C] -> [B, H, W, C]."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@functools.lru_cache(maxsize=64)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """[wh*ww, wh*ww] int index into a (2wh-1)(2ww-1) bias table (Swin)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=256)
def shifted_window_mask(h: int, w: int, window: int, shift: int,
                        fill: float = -100.0) -> Optional[np.ndarray]:
    """[nW, N, N] additive mask for shifted square windows (row-major
    window order); None when shift == 0."""
    if shift == 0:
        return None
    img_mask = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    mw = img_mask.reshape(h // window, window, w // window, window)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, window * window)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, fill, 0.0).astype(np.float32)


_DEVICE_TABLES: dict = {}
# casts of the device tables, keyed by the table's id and the dtype (and
# the layout): a table lives as long as the process and is never written,
# so its id stays its own
_TABLE_CASTS: dict = {}


def device_table(fn, *args, device) -> Optional[torch.Tensor]:
    """``fn(*args)`` (a cached numpy precompute) as a tensor on `device`,
    transferred once per (fn, args, device)."""
    key = (fn.__name__, args, str(device))
    if key not in _DEVICE_TABLES:
        arr = fn(*args)
        table = None if arr is None else torch.as_tensor(arr).to(device)
        _DEVICE_TABLES[key] = table
        if table is not None:
            _TABLE_CASTS[(id(table), table.dtype)] = table
    return _DEVICE_TABLES[key]


def table_as(t: Optional[torch.Tensor], dtype: torch.dtype,
             layout=None) -> Optional[torch.Tensor]:
    """t in `dtype` (the JAX wrappers cast the mask to the operands'
    dtype), then through `layout` where given (a function of the cast
    table: the order a kernel reads it in). A table that
    :func:`device_table` made is cast and laid out once and the result
    kept beside it; any other tensor is cast and laid out on each call."""
    if t is None or (t.dtype == dtype and layout is None):
        return t

    def make() -> torch.Tensor:
        c = t.to(dtype)
        return c if layout is None else layout(c)
    if _TABLE_CASTS.get((id(t), t.dtype)) is not t:
        return make()
    key = (id(t), dtype) if layout is None else (id(t), dtype, layout)
    if key not in _TABLE_CASTS:
        _TABLE_CASTS[key] = make()
    return _TABLE_CASTS[key]


def multi_head_window_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, num_heads: int,
                                bias: torch.Tensor,
                                mask: Optional[torch.Tensor],
                                scale: float) -> torch.Tensor:
    """q, k, v [B_, N, C] -> [B_, N, C]: softmax(q k^T * scale + bias +
    mask) v per head; bias [nH, N, N]; mask [nW, N, N] tiled over the
    batch (B_ = B * nW) or None."""
    b_, n, c = q.shape
    hd = c // num_heads

    def split(x):
        return x.reshape(b_, n, num_heads, hd).transpose(1, 2)

    attn = (split(q) * scale) @ split(k).transpose(-2, -1) + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(b_ // nw, nw, num_heads, n, n)
                + mask[None, :, None]).view(b_, num_heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    return (attn @ split(v)).transpose(1, 2).reshape(b_, n, c)
