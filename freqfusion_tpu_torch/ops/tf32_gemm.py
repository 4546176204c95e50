"""The tile plan of ``csrc/tf32_gemm.cuh``'s generic 3xTF32 GEMM.

The NAFBlock's five products (``ops/nafblock.py``) and the qkv window
attention's two projections (``ops/attention.py``) run on it: A in the
GEMM's tiled layout (K padded to whole 16-column stages, rows in 128-row
blocks), the weight split into hi/lo fragment order and zero-padded to
whole blocks of 64 or 128 columns, whichever pads N less (128 on a tie),
and a four-stage ring of bulk copies (``gemm_cols`` and
``gemm_launch`` there). The stage width and the shared-memory budget
here are also those of the fused FFN's two products (``ops/mlp.py``),
which run on the header's ``Product``.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["GemmPlan", "plan_gemm", "ROWS", "COLS", "STAGES",
           "BLOCKS_PER_SM", "SMEM_LIMIT", "BK", "MAX_CHANNELS"]

BK = 16              # K columns a stage (two k8 steps of mma.sync)
SMEM_LIMIT = 232448  # bytes of shared memory a block can have on sm_90
ROWS = 128          # rows a block, and A's row padding
COLS = (64, 128)    # columns a block: 4 or 8 warps
STAGES = 4
BLOCKS_PER_SM = {64: 3, 128: 2}  # the kernels' __launch_bounds__
MAX_CHANNELS = 2048  # gemm_rows holds a row of A in a warp's registers


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _ring_bytes(rows: int, cols: int, stages: int) -> int:
    """Shared memory of a product's ring: per stage the A tile (rows x BK),
    the W tile's fragments (BK x cols, hi and lo) and an mbarrier."""
    return stages * (4 * (rows * BK + 2 * BK * cols) + 8)


class GemmPlan(NamedTuple):
    """How the GEMM runs one product of K into N columns over `rows`."""
    kp: int         # K padded to BK
    cols: int       # columns a block (of COLS)
    np: int         # N padded to cols: the split weight's columns
    smem: int       # bytes of shared memory a block takes
    blocks: int     # row blocks x column blocks
    split_floats: int  # the split weight: 2 kp np


def plan_gemm(rows: int, k: int, n: int) -> GemmPlan:
    """The padded extents of a product of `rows` rows (already a multiple
    of ROWS where A is padded per image), K `k`, N `n`."""
    cols = min(COLS[::-1], key=lambda c: _round_up(n, c))
    kp, np_ = _round_up(k, BK), _round_up(n, cols)
    return GemmPlan(kp, cols, np_, _ring_bytes(ROWS, cols, STAGES),
                    -(-rows // ROWS) * (np_ // cols), 2 * kp * np_)
