"""Reflect padding of NCHW tensors with numpy's semantics for any pad.

Counterpart of ``freqfusion_tpu/ops/pad.py:pad_reflect``, which is
``jnp.pad(mode="reflect")``: a mirror without the edge pixel, repeated
for pads as long as or longer than the side (period 2 (n - 1)); a side of
1 repeats its pixel. ``F.pad(mode="reflect")`` raises once a pad reaches
the side, so it serves only the pads shorter than the side; the others
gather rows and columns through index vectors built with numpy, cached
per (side, pads) and moved to the device once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .window_attention import device_table

__all__ = ["pad_reflect"]


@functools.lru_cache(maxsize=256)
def _reflect_index(n: int, before: int, after: int) -> np.ndarray:
    """Source index of each of the before + n + after output positions of
    numpy's reflect padding of a side of n."""
    return np.pad(np.arange(n, dtype=np.int64), (before, after),
                  mode="reflect")


def pad_reflect(x: torch.Tensor, top: int, bottom: int, left: int,
                right: int) -> torch.Tensor:
    """Pad the last two axes of `x` ([..., H, W]) by top/bottom rows and
    left/right columns, mirrored as ``np.pad(mode="reflect")`` does."""
    h, w = x.shape[-2:]
    if max(top, bottom) < h and max(left, right) < w:
        if top or bottom or left or right:
            return F.pad(x, (left, right, top, bottom), mode="reflect")
        return x
    if top or bottom:
        rows = device_table(_reflect_index, h, top, bottom, device=x.device)
        x = x.index_select(-2, rows)
    if left or right:
        cols = device_table(_reflect_index, w, left, right, device=x.device)
        x = x.index_select(-1, cols)
    return x
