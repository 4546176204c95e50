"""The CUDA scan's planning and chunk-carry algebra, on the CPU.

``csrc/selective_scan.cu`` scans (sequence, chunk, 128-channel tile) items
in two passes around a compose of the chunk carries, with a persistent
grid that ``ops/selective_scan.py:plan_scan`` sizes. These tests hold the
plan (chunk length, grid, scratch shapes, every item scanned once) and,
in plain PyTorch, the algebra the kernel's three launches implement, which
the card tests (``tests/test_torch_kernels_cuda.py``) cannot see apart:
pass 1 from a zero state keeping the sum of delta and the end state, the
decay of a chunk in closed form exp(A * sum), the compose folded in runs
of chunks as the kernel's warps fold them, and pass 2 from each chunk's
initial state, against the plain ``selective_scan``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from freqfusion_tpu_torch.ops import selective_scan as ss

# the compose kernel's warps a block (csrc/selective_scan.cu kComposeWarps)
COMPOSE_RUNS = 8
# fp32 recurrences in another association order, max-abs
ALGEBRA_ATOL = 2e-5


def _block_items(plan, block):
    """The (sequence, chunk, tile) items block `block` scans, in the order
    csrc/selective_scan.cu's scan_pass_kernel walks them: item block,
    block + grid, ...; the tile varies fastest, then the chunk."""
    out = []
    for item in range(block, plan.items, plan.grid):
        zc, j = divmod(item, plan.tiles)
        out.append((*divmod(zc, plan.nchunk), j))
    return out


@pytest.mark.parametrize("slots", [528, 660, 792])
@pytest.mark.parametrize("seqs", [1, 4])
def test_plan_fills_one_wave_at_the_main_shape(slots, seqs):
    """The 336x512 bucket (L 172,032, D 360): the items fit the card's
    resident blocks at once, so no block scans a second item, and the
    busiest block scans within 2% of an even share of the steps."""
    plan = ss.plan_scan(172032, 360, seqs, slots)
    assert plan.tiles == 3
    assert plan.items <= slots and plan.grid == plan.items
    even = 172032 * plan.tiles * seqs / slots
    assert plan.chunk <= 1.02 * even
    assert plan.chunk % ss._SUB == 0
    assert (plan.nchunk - 1) * plan.chunk < 172032 <= plan.nchunk * plan.chunk


@pytest.mark.parametrize("length,d,seqs,slots", [
    (1, 1, 1, 660), (15, 24, 2, 7), (17, 360, 1, 660), (35, 129, 3, 5),
    (1073, 31, 2, 10), (2688, 24, 1, 5), (1000, 129, 8, 3),
    (172032, 360, 4, 528)])
def test_plan_covers_every_item_once(length, d, seqs, slots):
    """Every (sequence, chunk, tile) item is scanned by exactly one block,
    the blocks' shares differ by at most one item, and the chunks cut
    [0, L) into whole ring stages with a ragged last one."""
    plan = ss.plan_scan(length, d, seqs, slots)
    assert 1 <= plan.grid <= slots
    assert plan.tiles == -(-d // ss._TILE)
    assert plan.items == seqs * plan.nchunk * plan.tiles
    seen = [it for blk in range(plan.grid) for it in _block_items(plan, blk)]
    assert sorted(seen) == [(z, c, j) for z in range(seqs)
                            for c in range(plan.nchunk)
                            for j in range(plan.tiles)]
    shares = [len(_block_items(plan, blk)) for blk in range(plan.grid)]
    assert max(shares) - min(shares) <= 1
    assert plan.chunk >= ss._SUB and plan.chunk % ss._SUB == 0
    spans = [(c * plan.chunk, min(length, (c + 1) * plan.chunk))
             for c in range(plan.nchunk)]
    assert spans[0][0] == 0 and spans[-1][1] == length
    assert all(a < b for a, b in spans)


@pytest.mark.parametrize("n,dt_rank,width", [(16, 12, 44), (4, 1, 12),
                                             (1, 16, 24), (16, 16, 48)])
def test_dbl_width_pads_each_field(n, dt_rank, width):
    """x_dbl rows hold dt_low, B and C each padded to 4 floats: the main
    path's 12 + 16 + 16 needs no padding."""
    assert ss.dbl_width(n, dt_rank) == width


def test_scratch_shapes():
    """Pass 1's outputs: the sum of delta [seqs, nchunk, D] and the end
    states [seqs, nchunk, D, N]."""
    plan = ss.plan_scan(1073, 31, 2, 10)
    sdt, hc = ss._scratch(torch.empty(0), 2, plan, 31, 4)
    assert sdt.shape == (2, plan.nchunk, 31)
    assert hc.shape == (2, plan.nchunk, 31, 4)
    assert sdt.dtype == hc.dtype == torch.float32


def _chunked_scan(u, delta, A, B, C, D, bias, chunk, reverse):
    """The kernel's algebra in plain PyTorch over [b, L, d]: pass 1, the
    compose in runs, pass 2. fp32."""
    if reverse:
        u, delta, B, C = (x.flip(1) for x in (u, delta, B, C))
    b, length, d = u.shape
    dt = F.softplus(delta + bias)
    nchunk = -(-length // chunk)
    spans = [(c * chunk, min(length, (c + 1) * chunk)) for c in range(nchunk)]

    def walk(h, s0, s1, ys=None):
        for p in range(s0, s1):
            h = torch.exp(dt[:, p, :, None] * A) * h + \
                (dt[:, p] * u[:, p])[..., None] * B[:, p, None, :]
            if ys is not None:
                ys.append(torch.einsum("bn,bdn->bd", C[:, p], h)
                          + D * u[:, p])
        return h

    zero = u.new_zeros(b, d, A.shape[-1])
    # pass 1: each chunk from a zero state; its decay in closed form
    sdt = [dt[:, s0:s1].sum(1) for s0, s1 in spans]
    hend = [walk(zero, s0, s1) for s0, s1 in spans]
    # compose: runs of chunks folded alone, then carried across the runs,
    # then re-walked to give each chunk's initial state
    per = -(-nchunk // COMPOSE_RUNS)
    runs = [range(min(nchunk, w * per), min(nchunk, w * per + per))
            for w in range(COMPOSE_RUNS)]
    folds = []
    for run in runs:
        agg, tot = zero, torch.zeros_like(sdt[0])
        for c in run:
            agg = torch.exp(A * sdt[c][..., None]) * agg + hend[c]
            tot = tot + sdt[c]
        folds.append((torch.exp(A * tot[..., None]), agg))
    init = [None] * nchunk
    for w, run in enumerate(runs):
        carry = zero
        for p_w, h_w in folds[:w]:
            carry = p_w * carry + h_w
        for c in run:
            init[c] = carry
            carry = torch.exp(A * sdt[c][..., None]) * carry + hend[c]
    # pass 2: each chunk from its initial state
    ys = []
    for c, (s0, s1) in enumerate(spans):
        walk(init[c], s0, s1, ys)
    y = torch.stack(ys, 1)
    return y.flip(1) if reverse else y


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("length,chunk", [(37, 16), (100, 16), (35, 32),
                                         (1, 16), (250, 16)])
def test_chunk_carry_algebra_matches_the_plain_scan(length, chunk, reverse):
    """Pass 1 / compose / pass 2 as the kernel composes them, at ragged L
    (the last chunk short; 250 / 16 = 16 chunks fill the 8 runs with 2
    each, 100 / 16 = 7 leave the last run empty), forward and backward,
    against ``selective_scan`` (flipped for backward)."""
    rng = np.random.default_rng(length + 1000 * reverse)
    b, d, n = 2, 5, 4

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape))
                                .astype(np.float32))
    u, delta = t(b, length, d), t(b, length, d, scale=0.5)
    A = -torch.from_numpy(np.exp(rng.uniform(0, 2.7, (d, n)))
                          .astype(np.float32))
    B, C, D, bias = t(b, length, n), t(b, length, n), t(d), t(d, scale=0.2)
    got = _chunked_scan(u, delta, A, B, C, D, bias, chunk, reverse)
    want = ss._seq_scan(u, delta, A, B, C, D, bias, reverse)
    torch.testing.assert_close(got, want, rtol=0, atol=ALGEBRA_ATOL)
