"""GRL attention tables, indices and masks as static numpy precomputes.

Counterpart of ``freqfusion_tpu/ops/grl_tables.py``: the reference GRL
registers 13 per-resolution buffers; here they are recomputed per static
shape and never stored in a state dict, so a strict ``load_state_dict``
of a reference checkpoint (with those buffers filtered out) works.
GRL-B: window 8, stripe [8, 8] with no stripe groups or shift, so only the
window-attention mask depends on the input size.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np

from .window_attention import shifted_window_mask

__all__ = ["relative_coords_table_all", "relative_position_index_simple",
           "window_shift_mask"]


@functools.lru_cache(maxsize=32)
def relative_coords_table_all(ws: Tuple[int, int], df: int = 1) -> np.ndarray:
    """Continuous log-scaled relative coordinate table, [1, th, tw, 2]."""
    aws = [w // df for w in ws]
    ts_p = [w1 - 1 - (w1 - w2) // 2 for w1, w2 in zip(ws, aws)]
    ts_n = [-(w2 - 1) - (w1 - w2) // 2 for w1, w2 in zip(ws, aws)]
    coord_h = np.arange(ts_n[0], ts_p[0] + 1, dtype=np.float64)
    coord_w = np.arange(ts_n[1], ts_p[1] + 1, dtype=np.float64)
    table = np.stack(np.meshgrid(coord_h, coord_w, indexing="ij"))
    table = table.transpose(1, 2, 0)[None]
    table[..., 0] /= ts_p[0]
    table[..., 1] /= ts_p[1]
    table *= 8
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8)
    return table.astype(np.float32)


def _meshgrid_coords(end: Sequence[int]) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(end[0]), np.arange(end[1]),
                                  indexing="ij"))
    return coords.reshape(2, -1)


@functools.lru_cache(maxsize=64)
def relative_position_index_simple(ws: Tuple[int, int], df: int = 1,
                                   window_to_anchor: bool = True
                                   ) -> np.ndarray:
    """Window <-> anchor relative position index, [N1, N2]."""
    aws = [w // df for w in ws]
    coords = _meshgrid_coords(ws)
    coords_anchor = _meshgrid_coords(aws)
    max_horizontal_diff = aws[1] + ws[1] - 1
    if window_to_anchor:
        offset = [w2 - 1 for w2 in aws]
        c1, c2 = coords, coords_anchor
    else:
        offset = [w1 - 1 for w1 in ws]
        c1, c2 = coords_anchor, coords
    diff = (c1[:, :, None] - c2[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    diff[:, :, 0] += offset[0]
    diff[:, :, 1] += offset[1]
    diff[:, :, 0] *= max_horizontal_diff
    return diff.sum(-1)


def window_shift_mask(h: int, w: int, window: int, shift: int
                      ) -> Optional[np.ndarray]:
    """Shifted-window attention mask; None when there is no shift."""
    return shifted_window_mask(h, w, window, shift)
