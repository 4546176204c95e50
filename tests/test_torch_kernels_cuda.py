"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test is marked ``cuda`` and skips where there is no GPU. This
file imports no JAX, so it runs on a machine without it:

    python -m pytest -o addopts="" --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from freqfusion_tpu_torch.ops import cuda, wgmma
from freqfusion_tpu_torch.ops.cab import cab_fused, cab_fused_reference
from freqfusion_tpu_torch.ops.edge import (
    edge_fuse_fused, edge_fuse_fused_reference, edge_refine_fused,
    edge_refine_fused_reference)
from freqfusion_tpu_torch.ops.hier import (hier_stage3_fused,
                                           hier_stage3_fused_reference)
from freqfusion_tpu_torch.ops.lka import (lka_block_fused,
                                          lka_block_fused_reference)
from freqfusion_tpu_torch.ops.dwconv import dwconv3x3, dwconv3x3_reference
from freqfusion_tpu_torch.ops.mlp import (fused_mlp_block,
                                          fused_mlp_block_reference)
from freqfusion_tpu_torch.ops.nafblock import (nafblock_fused,
                                               nafblock_fused_reference)
from freqfusion_tpu_torch.ops.attention import (
    grl_mixed_attention_nhwc, grl_mixed_attention_nhwc_reference,
    grl_mixed_attention_qkv_nhwc, grl_mixed_attention_qkv_nhwc_reference,
    plan_grl_attention_bf16, plan_grl_qkv_projections, window_attention,
    window_attention_nhwc,
    window_attention_nhwc_reference,
    window_attention_qkv_nhwc, window_attention_qkv_nhwc_reference,
    window_attention_reference)
from freqfusion_tpu_torch.ops.layernorm import (fused_layernorm,
                                                fused_layernorm_reference)
from freqfusion_tpu_torch.ops import selective_scan as ss
from freqfusion_tpu_torch.ops.selective_scan import (
    selective_scan_bidir, selective_scan_bidir_reference, selective_scan_chain,
    selective_scan_chain_proj, selective_scan_chain_proj_reference,
    selective_scan_chain_reference, selective_scan_dirs,
    selective_scan_dirs_reference, selective_scan_flat,
    selective_scan_flat_reference, selective_scan_spatial,
    selective_scan_spatial_reference)
from freqfusion_tpu_torch.ops.token_attention import (
    token_attention, token_attention_reference)
from freqfusion_tpu_torch.ops.window_attention import (
    shifted_window_mask, window_partition)

from test_torch_harness import cuda_or_skip

# fp32 attention: accumulation order only (max-abs)
ATTN_TOL = 1e-4
# scan: long fp32 recurrences, relative to max |y|
SCAN_REL_TOL = 1e-3
# fused FFN, CAB, NAFBlock, dwconv, the three in-kernel projection kernels
# and the four fusion-eval kernels: fp32 sums of up to 9 x 976 terms in
# another order, relative to max(1, max |out|)
FUSED_REL_TOL = 1e-4
# fp32 LayerNorm: rsqrtf (2 ulp) and the row sums in another order
LN_TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a, dev):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,ws", [(180, 6, 16), (212, 4, 16),
                                        (244, 2, 16), (276, 6, 16),
                                        (308, 4, 16), (60, 3, 12),
                                        (16, 1, 8), (32, 2, 7)])
def test_window_attention_kernel(c, heads, ws):
    """DRCT-L's five block widths (head dims 30, 53, 122, 46, 77) at
    window 16, with and without the shift mask; window 12 (N = 144, a
    partial query and key tile), window 8 (one tile, hd 16) and window 7
    (N = 49, not a multiple of 4: scalar bias and mask reads)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c)
    h, w = 2 * ws, 3 * ws
    n = ws * ws
    q, k, v = (_t(rng.normal(size=(2, h, w, c)), dev) for _ in range(3))
    bias = _t(0.5 * rng.normal(size=(heads, n, n)), dev)
    for shift in (0, ws // 2):
        mask = shifted_window_mask(h, w, ws, shift)
        m = None if mask is None else _t(mask, dev)
        cuda.reset_launch_counts()
        got = window_attention_nhwc(q, k, v, bias, m, heads, ws)
        want = window_attention_nhwc_reference(q, k, v, bias, m, heads, ws)
        torch.cuda.synchronize()
        assert cuda.launch_counts["window_attention_nhwc"] == 1
        assert (got - want).abs().max().item() <= ATTN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", [(244, 2), (180, 6)])
def test_window_attention_precision_guard(c, heads):
    """Head dims 122 and 30 with q and k scaled so that logits reach +-30:
    the kernel's 3xTF32 products hold ATTN_TOL; one TF32 product a step
    (hi * hi alone) misses it by ~60x (tests/
    test_torch_window_attention_plan.py models both)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + 7)
    h, w, ws = 32, 48, 16
    q, k = (_t(2.6 * rng.normal(size=(1, h, w, c)), dev) for _ in range(2))
    v = _t(rng.normal(size=(1, h, w, c)), dev)
    bias = _t(0.5 * rng.normal(size=(heads, ws * ws, ws * ws)), dev)
    hd = c // heads
    qh, kh = (window_partition(t, ws).reshape(-1, ws * ws, heads, hd)
              .transpose(1, 2) for t in (q, k))
    logits = (qh @ kh.transpose(-2, -1)).abs().max().item() * hd ** -0.5
    assert logits >= 30
    for shift in (0, ws // 2):
        mask = shifted_window_mask(h, w, ws, shift)
        m = None if mask is None else _t(mask, dev)
        got = window_attention_nhwc(q, k, v, bias, m, heads, ws)
        want = window_attention_nhwc_reference(q, k, v, bias, m, heads, ws)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= ATTN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,ws", [(42, 3, 8), (42, 3, 7), (30, 2, 8)])
def test_window_attention_unaligned_rows_kernel(c, heads, ws):
    """#1 where C * 4 is not a multiple of 16 (C 42, 30): rows cannot be
    read in 16-byte pieces, so the kernel takes its 4-byte copies; window
    7 leaves a ragged last key tile."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + ws)
    h, w, n = 2 * ws, 3 * ws, ws * ws
    q, k, v = (_t(rng.normal(size=(2, h, w, c)), dev) for _ in range(3))
    bias = _t(0.5 * rng.normal(size=(heads, n, n)), dev)
    for shift in (0, ws // 2):
        mask = shifted_window_mask(h, w, ws, shift)
        m = None if mask is None else _t(mask, dev)
        cuda.reset_launch_counts()
        got = window_attention_nhwc(q, k, v, bias, m, heads, ws)
        want = window_attention_nhwc_reference(q, k, v, bias, m, heads, ws)
        torch.cuda.synchronize()
        assert cuda.launch_counts["window_attention_nhwc"] == 1
        assert (got - want).abs().max().item() <= ATTN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,ws", [(180, 6, 16), (60, 3, 7),
                                        (42, 3, 12)])
def test_window_attention_reruns_bit_equal(c, heads, ws):
    """#1 run twice on the same inputs gives the same bits (no atomics,
    a fixed order of every sum), on both copy routes, shifted."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + 2 * ws)
    h, w, n = 2 * ws, 2 * ws, ws * ws
    q, k, v = (_t(rng.normal(size=(1, h, w, c)), dev) for _ in range(3))
    bias = _t(0.5 * rng.normal(size=(heads, n, n)), dev)
    m = _t(shifted_window_mask(h, w, ws, ws // 2), dev)
    first = window_attention_nhwc(q, k, v, bias, m, heads, ws)
    again = window_attention_nhwc(q, k, v, bias, m, heads, ws)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
def test_grl_mixed_attention_kernel(shift):
    dev = cuda_or_skip()
    rng = np.random.default_rng(2)
    halves = [_t(rng.normal(size=(2, 32, 48, 90)), dev) for _ in range(6)]
    anchor = _t(rng.normal(size=(2, 16, 24, 90)), dev)
    scales = [_t(rng.uniform(1, 30, (3, 1, 1)), dev) for _ in range(3)]
    biases = [_t(rng.uniform(0, 16, s), dev)
              for s in ((3, 64, 64), (3, 16, 64), (3, 64, 16))]
    mask = shifted_window_mask(32, 48, 8, shift)
    args = (*halves, anchor, *scales, *biases,
            None if mask is None else _t(mask, dev), 3, 3, 8)
    got = grl_mixed_attention_nhwc(*args)
    want = grl_mixed_attention_nhwc_reference(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= ATTN_TOL


def _grl_args(rng, dev, b, c2, heads_w, heads_s, shift, scale_range=(1, 30),
              h=16, w=24):
    """Halves, anchor, scales, biases and mask of a GRL mixed attention
    call on [b, h, w, c2] (8x8 tiles, 4x4 anchors)."""
    halves = [_t(rng.normal(size=(b, h, w, c2)), dev) for _ in range(6)]
    anchor = _t(rng.normal(size=(b, h // 2, w // 2, c2)), dev)
    scales = [_t(rng.uniform(*scale_range, (n, 1, 1)), dev)
              for n in (heads_w, heads_s, heads_s)]
    biases = [_t(rng.uniform(0, 16, (n, r, c)), dev)
              for n, r, c in ((heads_w, 64, 64), (heads_s, 16, 64),
                              (heads_s, 64, 16))]
    mask = shifted_window_mask(h, w, 8, 4) if shift else None
    return (*halves, anchor, *scales, *biases,
            None if mask is None else _t(mask, dev), heads_w, heads_s, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("c2,heads_w,heads_s", [
    (42, 2, 3), (42, 6, 6), (90, 2, 3), (90, 6, 6), (180, 3, 3),
    (180, 2, 6)])
@pytest.mark.parametrize("shift", [False, True])
def test_grl_mixed_attention_shapes_kernel(c2, heads_w, heads_s, shift):
    """#2 at batch 2 over head counts 2/3/6 and C/2 42 (rows of 168
    bytes), 90 and 180 (head dims 7 to 90: boxes 16 to 96, one m-tile a
    warp at box 96), with and without the shift mask; one launch a call."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c2 + 10 * heads_w + heads_s + shift)
    args = _grl_args(rng, dev, 2, c2, heads_w, heads_s, shift)
    cuda.reset_launch_counts()
    got = grl_mixed_attention_nhwc(*args)
    assert dict(cuda.launch_counts) == {"grl_mixed_attention_nhwc": 1}
    want = grl_mixed_attention_nhwc_reference(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= ATTN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True])
def test_grl_mixed_attention_precision_guard(shift):
    """GRL-B's heads (3 + 3 of 30) with scales up to 100, so logits reach
    +-100 + bias 16: the kernel's 3xTF32 products hold ATTN_TOL, while one
    TF32 product a step (hi * hi alone) misses it by ~150x
    (tests/test_torch_grl_attention_plan.py models both)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(31 + shift)
    args = _grl_args(rng, dev, 2, 90, 3, 3, shift, (30, 100), 32, 48)
    for scale in args[7:10]:
        scale[0] = 100.0
    got = grl_mixed_attention_nhwc(*args)
    want = grl_mixed_attention_nhwc_reference(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= ATTN_TOL


@pytest.mark.cuda
def test_grl_mixed_attention_reruns_bit_equal():
    """#2 and #12 run twice on the same inputs give the same bits (no
    atomics, a fixed order of every sum), shifted."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(8)
    args = _grl_args(rng, dev, 2, 90, 3, 3, True)
    first = grl_mixed_attention_nhwc(*args)
    again = grl_mixed_attention_nhwc(*args)
    x = _t(rng.normal(size=(2, 16, 24, 180)), dev)
    qargs = (x, torch.roll(x, (-4, -4), (1, 2)).contiguous(), args[6],
             _t(rng.normal(size=(180, 540)) / np.sqrt(180), dev),
             _t(0.1 * rng.normal(size=540), dev), *args[7:])
    qfirst = grl_mixed_attention_qkv_nhwc(*qargs)
    qagain = grl_mixed_attention_qkv_nhwc(*qargs)
    torch.cuda.synchronize()
    for a, b in zip(first + qfirst, again + qagain):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_grl_mixed_attention_refuses_unaligned():
    """The bulk copies need 16-byte aligned operands: a contiguous half
    that starts one float into its storage is refused, not misread."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(9)
    args = list(_grl_args(rng, dev, 1, 90, 3, 3, False))
    args[0] = torch.empty(1 + args[0].numel(), device=dev)[1:].view_as(
        args[0]).copy_(args[0])
    with pytest.raises(ValueError, match="16-byte aligned"):
        grl_mixed_attention_nhwc(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_kernels(reverse):
    """Both entries at D 360, N 16, dt_rank 12; L = 24 * 40 spans several
    256-step chunks, so the carry composition is exercised both ways."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(7)
    b, t, r, d, n = 2, 40, 24, 360, 16
    u, xc = (_t(rng.normal(size=(b, t, r, d)), dev) for _ in range(2))
    dt = _t(0.3 * rng.normal(size=(b, t, r, d)), dev)
    A = _t(-np.exp(rng.uniform(0, 2.7, (d, n))), dev)
    B, C = (_t(rng.normal(size=(b, t, r, n)), dev) for _ in range(2))
    D = _t(rng.normal(size=d), dev)
    bias = _t(0.1 * rng.normal(size=d), dev)
    got = selective_scan_chain(u, dt, A, B, C, D, bias, reverse)
    want = selective_scan_chain_reference(u, dt, A, B, C, D, bias, reverse)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= SCAN_REL_TOL * want.abs().max()

    xpw = _t(0.05 * rng.normal(size=(44, d)), dev)
    dtw = _t(0.3 * rng.normal(size=(d, 12)), dev)
    got = selective_scan_chain_proj(xc, xpw, dtw, A, D, bias, reverse)
    want = selective_scan_chain_proj_reference(xc, xpw, dtw, A, D, bias,
                                               reverse)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= SCAN_REL_TOL * want.abs().max()


def _scan_inputs(rng, lead, d, n, dev, group=()):
    """u, dt, A, B, C, D, bias on the card: u and dt [*lead, d], B and C
    [*lead, n], A [*group, d, n], D and bias [*group, d]."""
    return (_t(rng.normal(size=lead + (d,)), dev),
            _t(0.3 * rng.normal(size=lead + (d,)), dev),
            _t(-np.exp(rng.uniform(0, 2.7, group + (d, n))), dev),
            _t(rng.normal(size=lead + (n,)), dev),
            _t(rng.normal(size=lead + (n,)), dev),
            _t(rng.normal(size=group + (d,)), dev),
            _t(0.1 * rng.normal(size=group + (d,)), dev))


def _scan_close(got, want, name):
    torch.cuda.synchronize()
    assert cuda.launch_counts[name] == 1
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert (g - w).abs().max() <= SCAN_REL_TOL * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(360, 16), (24, 4)])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_chain_and_spatial_kernels(d, n, reverse):
    """#5 over [B, T, R, D] and #9 over [B, R, T, D], batch 2, L = 37 * 29
    = 1073: four whole 256-step chunks and a ragged one, each direction;
    D 24 leaves most of a 128-channel block idle."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(17 + reverse)
    args = _scan_inputs(rng, (2, 37, 29), d, n, dev)
    cuda.reset_launch_counts()
    _scan_close(selective_scan_chain(*args, reverse),
                selective_scan_chain_reference(*args, reverse),
                "selective_scan_chain")
    cuda.reset_launch_counts()
    _scan_close(selective_scan_spatial(*args, reverse=reverse),
                selective_scan_spatial_reference(*args, reverse=reverse),
                "selective_scan_spatial")


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(360, 16), (24, 4)])
def test_scan_flat_dirs_bidir_kernels(d, n):
    """#6 over [B, L, D], #7 over four directions with their own A, D and
    bias, and #8 (two u tensors, directions 2 and 3 backward): batch 2,
    L = 1000, a ragged last chunk."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(23)
    args = _scan_inputs(rng, (2, 1000), d, n, dev)
    cuda.reset_launch_counts()
    _scan_close(selective_scan_flat(*args),
                selective_scan_flat_reference(*args), "selective_scan_flat")
    u, *rest = _scan_inputs(rng, (4, 2, 1000), d, n, dev, (4,))
    cuda.reset_launch_counts()
    _scan_close(selective_scan_dirs(u, *rest),
                selective_scan_dirs_reference(u, *rest),
                "selective_scan_dirs")
    args = (u[:2].contiguous(), *rest)
    cuda.reset_launch_counts()
    _scan_close(selective_scan_bidir(*args),
                selective_scan_bidir_reference(*args), "selective_scan_bidir")


def _check_contracts(rng, dev, b, t, r, d, n, dtr=12):
    """The six scan entries (TPU contracts #3-#9) against their plain
    versions over b sequences of L = t * r positions: chain_proj, chain and
    spatial on [b, t, r] each direction, flat on [b, L], four directions,
    and bidir (G = 4 groups from Gu = 2 u tensors, rev_mask 0b1100)."""
    l = t * r
    xpw = _t(0.05 * rng.normal(size=(dtr + 2 * n, d)), dev)
    dtw = _t(0.3 * rng.normal(size=(d, dtr)), dev)
    for rev in (False, True):
        xc = _t(rng.normal(size=(b, t, r, d)), dev)
        _, _, A, _, _, D, bias = _scan_inputs(rng, (b, t, r), d, n, dev)
        cuda.reset_launch_counts()
        _scan_close(selective_scan_chain_proj(xc, xpw, dtw, A, D, bias, rev),
                    selective_scan_chain_proj_reference(xc, xpw, dtw, A, D,
                                                        bias, rev),
                    "selective_scan")
        args = _scan_inputs(rng, (b, t, r), d, n, dev)
        cuda.reset_launch_counts()
        _scan_close(selective_scan_chain(*args, rev),
                    selective_scan_chain_reference(*args, rev),
                    "selective_scan_chain")
        cuda.reset_launch_counts()
        _scan_close(selective_scan_spatial(*args, reverse=rev),
                    selective_scan_spatial_reference(*args, reverse=rev),
                    "selective_scan_spatial")
    args = _scan_inputs(rng, (b, l), d, n, dev)
    cuda.reset_launch_counts()
    _scan_close(selective_scan_flat(*args),
                selective_scan_flat_reference(*args), "selective_scan_flat")
    u, *rest = _scan_inputs(rng, (4, b, l), d, n, dev, (4,))
    cuda.reset_launch_counts()
    _scan_close(selective_scan_dirs(u, *rest),
                selective_scan_dirs_reference(u, *rest), "selective_scan_dirs")
    args = (u[:2].contiguous(), *rest)
    cuda.reset_launch_counts()
    _scan_close(selective_scan_bidir(*args),
                selective_scan_bidir_reference(*args), "selective_scan_bidir")


@pytest.mark.cuda
@pytest.mark.parametrize("t,r", [(1, 1), (5, 3), (17, 1), (7, 5)])
def test_scan_lengths_kernel(t, r):
    """L = 1, one ring stage less one step (15), one planned chunk plus one
    (17: at these sizes a chunk is one 16-step stage) and two chunks plus
    three (35), at D 360, N 16, dt_rank 12."""
    dev = cuda_or_skip()
    _check_contracts(np.random.default_rng(t * r), dev, 2, t, r, 360, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 24, 31, 129, 360])
def test_scan_widths_kernel(d):
    """D 1, 31 and 129 (a 1-channel second tile) take the 4-byte copies,
    24 and 360 the 16-byte ones (D % 4 == 0); L = 37 * 29."""
    dev = cuda_or_skip()
    _check_contracts(np.random.default_rng(d), dev, 2, 37, 29, d, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("dtr", [1, 12, 16])
def test_scan_state_and_rank_kernel(n, dtr):
    """N and dt_rank around the compiled (16, 12): the generic
    instantiations, 4-byte B/C copies at N 1, padded x_dbl rows."""
    dev = cuda_or_skip()
    _check_contracts(np.random.default_rng(17 * n + dtr), dev, 1, 23, 19, 24,
                     n, dtr)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_chain_t336_kernel(reverse, monkeypatch):
    """The chain layout with T = 336 (SS2D's rows at the 336x512 bucket) and
    chunks of 544 steps that straddle chains (a card of 5 resident blocks,
    set in the plan), for #3 and #5: ring stages walk across t = 335 -> 0,
    backward too."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(336 + reverse)
    t, r, d, n = 336, 8, 24, 16
    for proj in (True, False):
        monkeypatch.setitem(ss._slots, (0, proj, n, 12 if proj else 0), 5)
    assert ss.plan_scan(t * r, d, 1, 5).chunk == 544
    xc = _t(rng.normal(size=(1, t, r, d)), dev)
    xpw = _t(0.05 * rng.normal(size=(44, d)), dev)
    dtw = _t(0.3 * rng.normal(size=(d, 12)), dev)
    _, _, A, _, _, D, bias = _scan_inputs(rng, (1, t, r), d, n, dev)
    cuda.reset_launch_counts()
    _scan_close(selective_scan_chain_proj(xc, xpw, dtw, A, D, bias, reverse),
                selective_scan_chain_proj_reference(xc, xpw, dtw, A, D, bias,
                                                    reverse),
                "selective_scan")
    args = _scan_inputs(rng, (1, t, r), d, n, dev)
    cuda.reset_launch_counts()
    _scan_close(selective_scan_chain(*args, reverse),
                selective_scan_chain_reference(*args, reverse),
                "selective_scan_chain")


@pytest.mark.cuda
def test_scan_persistent_walk_kernel(monkeypatch):
    """A grid of 3 blocks each walking many items (sequence, chunk, tile),
    the ring refilled from item to item: all contracts at D 129 (two tiles)
    and N 4."""
    dev = cuda_or_skip()
    for key in ((0, True, 4, 12), (0, False, 4, 0)):
        monkeypatch.setitem(ss._slots, key, 3)
    _check_contracts(np.random.default_rng(3), dev, 2, 37, 29, 129, 4)


@pytest.mark.cuda
def test_scan_unaligned_and_repeatable_kernel():
    """Bases off 16 bytes take the 4-byte copies at D % 4 == 0 and N 16;
    two runs of #3 and of #8 give bit-equal y (no atomics, a fixed
    order)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(5)
    args = _scan_inputs(rng, (2, 37, 29), 24, 16, dev)

    def shifted(x):
        return torch.empty(x.numel() + 1, device=dev)[1:].view(
            x.shape).copy_(x)
    moved = tuple(shifted(x) if x.dim() > 2 else x for x in args)
    cuda.reset_launch_counts()
    _scan_close(selective_scan_chain(*moved, True),
                selective_scan_chain_reference(*args, True),
                "selective_scan_chain")
    xc = _t(rng.normal(size=(1, 64, 48, 360)), dev)
    xpw = _t(0.05 * rng.normal(size=(44, 360)), dev)
    dtw = _t(0.3 * rng.normal(size=(360, 12)), dev)
    _, _, A, _, _, D, bias = _scan_inputs(rng, (1,), 360, 16, dev)
    first = selective_scan_chain_proj(xc, xpw, dtw, A, D, bias)
    assert torch.equal(first, selective_scan_chain_proj(xc, xpw, dtw, A, D,
                                                        bias))
    u, *rest = _scan_inputs(rng, (4, 1, 3000), 360, 16, dev, (4,))
    first = selective_scan_bidir(u[:2].contiguous(), *rest)
    again = selective_scan_bidir(u[:2].contiguous(), *rest)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def _fused_close(got, want):
    torch.cuda.synchronize()
    tol = FUSED_REL_TOL * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.fixture
def fp32_plain():
    """The plain versions' convolutions in full fp32 (cuDNN defaults to
    TF32)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    yield
    cudnn.allow_tf32, matmul.allow_tf32 = old


def _tf32(t):
    """t rounded to TF32 as the kernels' hi part: to nearest, ties away
    from zero, on the float32's bits."""
    return ((t.float().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def _mlp_args(rng, c, ch, prenorm, hw, dev, x_scale=1.0, w1_scale=1.0):
    x = _t(x_scale * rng.normal(size=(1, *hw, c)), dev)
    w1 = _t(w1_scale * rng.normal(size=(c, ch)) / np.sqrt(c), dev)
    w2 = _t(rng.normal(size=(ch, c)) / np.sqrt(ch), dev)
    b1, b2, lb = (_t(0.1 * rng.normal(size=n), dev) for n in (ch, c, c))
    ls = _t(1 + 0.1 * rng.normal(size=c), dev)
    return (x, w1, b1, w2, b2, ls, lb, prenorm, 0.75)


@pytest.mark.cuda
@pytest.mark.parametrize("c,ch", [(180, 720), (212, 848), (244, 976),
                                  (276, 276), (308, 308), (180, 360),
                                  (20, 76)])
@pytest.mark.parametrize("prenorm", [True, False])
@pytest.mark.parametrize("hw", [(13, 18), (37, 61)])
def test_fused_mlp_kernel(c, ch, prenorm, hw, fp32_plain):
    """The six path shapes (DRCT-L's five FFN widths, GRL-B's) and a narrow
    one, each pre- and post-norm, res_scale 0.75, at row counts that are
    not multiples of the 128- or 64-row tiles (234 and 2257 rows)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + ch + prenorm)
    args = _mlp_args(rng, c, ch, prenorm, hw, dev)
    cuda.reset_launch_counts()
    got = fused_mlp_block(*args)
    assert cuda.launch_counts["fused_mlp_block"] == 1
    _fused_close(got, fused_mlp_block_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("c,ch,prenorm", [(244, 976, True), (180, 360, False)])
def test_fused_mlp_precision_guard(c, ch, prenorm, fp32_plain):
    """A large hidden (W1 3x its fan-in scale: the GELU passes large,
    mostly positive values, so the second product cancels; a larger x would
    only widen the tolerance through the residual): the kernel's 3xTF32
    holds FUSED_REL_TOL, while the same FFN with one TF32 product (operands
    rounded to TF32, summed in float64) misses it, by ~3x on the CPU's
    model of these inputs."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + 11)
    args = _mlp_args(rng, c, ch, prenorm, (40, 64), dev, 1.0, 3.0)
    x, w1, b1, w2, b2, ls, lb = args[:7]
    want = fused_mlp_block_reference(*args)
    tol = FUSED_REL_TOL * max(1.0, want.abs().max().item())
    err = (fused_mlp_block(*args) - want).abs().max().item()
    d = torch.float64
    t = (torch.nn.functional.layer_norm(x, (c,), ls, lb, 1e-5) if prenorm
         else x)
    hid = torch.nn.functional.gelu(_tf32(t).to(d) @ _tf32(w1).to(d)
                                   + b1.to(d))
    y = _tf32(hid).to(d) @ _tf32(w2).to(d) + b2.to(d)
    if not prenorm:
        y = torch.nn.functional.layer_norm(y, (c,), ls.to(d), lb.to(d), 1e-5)
    one = (x.to(d) + 0.75 * y - want.to(d)).abs().max().item()
    assert err <= tol
    assert one > tol


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,ch,h,w", [(172032, 180, 720, 336, 512),
                                        (172032, 212, 848, 100, 140),
                                        (172032, 244, 976, 8, 12),
                                        (2257, 276, 276, 37, 61),
                                        (2257, 308, 308, 5, 3),
                                        (234, 180, 360, 13, 18)])
def test_plans_match_the_kernels(m, c, ch, h, w):
    """The wrappers size the kernels' scratch from their plans
    (ops/mlp.py:plan_fused_mlp, ops/cab.py:plan_cab); the C entries compute
    the same sizes and the same partial tiles."""
    from freqfusion_tpu_torch.ops.cab import plan_cab
    from freqfusion_tpu_torch.ops.mlp import plan_fused_mlp

    cuda_or_skip()
    lib = cuda.library()
    assert lib.ff_fused_mlp_scratch_floats(m, c, ch) == \
        plan_fused_mlp(m, c, ch).scratch_floats
    for cr in (45, 60):
        plan = plan_cab(h, w, 180, cr)
        assert lib.ff_cab_scratch_floats(180, cr) == plan.scratch_floats
        assert lib.ff_cab_tiles(h, w, 180) == plan.tiles


def _cab_tree(rng, c, cr, sq, dev, scale=1.0):
    def conv(shape):
        return {"kernel": _t(scale * rng.normal(size=shape) / np.sqrt(np.prod(
                    shape[:-1])), dev),
                "bias": _t(0.1 * rng.normal(size=shape[-1]), dev)}
    return {"cab_0": conv((3, 3, c, cr)), "cab_2": conv((3, 3, cr, c)),
            "ca_1": conv((1, 1, c, c // sq)), "ca_3": conv((1, 1, c // sq, c))}


def _cab_norms(rng, dev, with_ln):
    if not with_ln:
        return None, None
    ln = {"scale": _t(1 + 0.1 * rng.normal(size=180), dev),
          "bias": _t(0.1 * rng.normal(size=180), dev)}
    return ln, _t(1 + 0.2 * rng.normal(size=180), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("cr,sq", [(45, 18), (60, 30)])
@pytest.mark.parametrize("with_ln", [False, True])
@pytest.mark.parametrize("hw", [(13, 18), (37, 61), (5, 3)])
def test_cab_kernel(cr, sq, with_ln, hw, fp32_plain):
    """GRL's CAB width (C 180 -> 45, squeeze 18) and MambaIR's (C 180 ->
    60, squeeze 30), each without and with the ln_2 LayerNorm and skip
    scale, batch 2, at sizes that are not multiples of the 16 x 16 tile
    and one smaller than it."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(cr + with_ln + hw[0])
    w = _cab_tree(rng, 180, cr, sq, dev)
    x = _t(rng.normal(size=(2, *hw, 180)), dev)
    ln, skip = _cab_norms(rng, dev, with_ln)
    cuda.reset_launch_counts()
    got = cab_fused(x, w, ln, skip)
    assert cuda.launch_counts["cab_fused"] == 1
    _fused_close(got, cab_fused_reference(x, w, ln, skip))


@pytest.mark.cuda
@pytest.mark.parametrize("cr,sq", [(45, 18), (60, 30)])
def test_cab_precision_guard(cr, sq, fp32_plain):
    """Large inputs (x 4 + N(0, 1), weights 2x their fan-in scale): the
    kernel's 3xTF32 convolutions hold FUSED_REL_TOL, while the same CAB with
    one TF32 product (both convolutions' operands rounded to TF32, summed
    in float64) misses it, by 12-18x on the CPU's model of these inputs."""
    from freqfusion_tpu_torch.ops.cab import _conv3x3, _squeeze

    dev = cuda_or_skip()
    rng = np.random.default_rng(cr + 5)
    w = _cab_tree(rng, 180, cr, sq, dev, 2.0)
    x = _t(4 + rng.normal(size=(1, 48, 64, 180)), dev)
    want = cab_fused_reference(x, w)
    tol = FUSED_REL_TOL * max(1.0, want.abs().max().item())
    err = (cab_fused(x, w) - want).abs().max().item()
    d = torch.float64

    def rounded(p):
        return {"kernel": _tf32(p["kernel"]).to(d), "bias": p["bias"].to(d)}
    u = torch.nn.functional.gelu(_conv3x3(_tf32(x).to(d), rounded(w["cab_0"])))
    y = _conv3x3(_tf32(u).to(d), rounded(w["cab_2"]))
    wd = {k: {n: t.to(d) for n, t in v.items()} for k, v in w.items()}
    one = (y * _squeeze(y.mean((1, 2)), wd)[:, None, None, :]
           - want.to(d)).abs().max().item()
    assert err <= tol
    assert one > tol


def _naf_tree(rng, c, dev):
    def conv(cin, cout):
        return {"kernel": _t(rng.normal(size=(1, 1, cin, cout)) / np.sqrt(cin),
                             dev),
                "bias": _t(0.1 * rng.normal(size=cout), dev)}

    def norm():
        return {"scale": _t(1 + 0.1 * rng.normal(size=c), dev),
                "bias": _t(0.1 * rng.normal(size=c), dev)}
    return {"norm1": norm(), "conv1": conv(c, 2 * c),
            "conv2": {"kernel": _t(0.3 * rng.normal(size=(3, 3, 1, 2 * c)),
                                   dev),
                      "bias": _t(0.1 * rng.normal(size=2 * c), dev)},
            "sca": conv(c, c), "conv3": conv(c, c),
            "beta": _t(0.5 * rng.normal(size=c), dev), "norm2": norm(),
            "conv4": conv(c, 2 * c), "conv5": conv(c, c),
            "gamma": _t(0.5 * rng.normal(size=c), dev)}


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 128, 256, 512, 1024, 36])
@pytest.mark.parametrize("hw", [(13, 18), (112, 144), (17, 23)])
def test_nafblock_kernel(c, hw, fp32_plain):
    """NAFNet-SIDD-64's five widths and C 36 (K padded to 48, the gate's
    virtual columns to 96) at ragged sizes (odd H and W in 17 x 23), two
    images: each image's rows padded to 128 and its own scaled W3."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c)
    w = _naf_tree(rng, c, dev)
    x = _t(rng.uniform(size=(2, *hw, c)), dev)
    cuda.reset_launch_counts()
    got = nafblock_fused(x, w)
    assert cuda.launch_counts["nafblock_fused"] == 1
    _fused_close(got, nafblock_fused_reference(x, w))


def _naf_one_product(x, w):
    """The NAFBlock with each 1x1 product's operands rounded to TF32 (one
    TF32 product), the rest in float64."""
    f, d, c = torch.nn.functional, torch.float64, x.shape[-1]

    def mm(a, n):
        return (_tf32(a.float()).to(d) @ _tf32(w[n]["kernel"][0, 0]).to(d)
                + w[n]["bias"].to(d))

    def ln(v, n):
        return f.layer_norm(v, (c,), w[n]["scale"].to(d), w[n]["bias"].to(d),
                            1e-6)
    u = mm(ln(x.to(d), "norm1"), "conv1")
    u = f.conv2d(u.permute(0, 3, 1, 2),
                 w["conv2"]["kernel"].permute(3, 2, 0, 1).to(d),
                 w["conv2"]["bias"].to(d), padding=1,
                 groups=2 * c).permute(0, 2, 3, 1)
    g = u[..., :c] * u[..., c:]
    s = (g.mean((1, 2)) @ w["sca"]["kernel"][0, 0].to(d)
         + w["sca"]["bias"].to(d))
    y = x.to(d) + mm(g * s[:, None, None, :], "conv3") * w["beta"].to(d)
    u2 = mm(ln(y, "norm2"), "conv4")
    return y + mm(u2[..., :c] * u2[..., c:], "conv5") * w["gamma"].to(d)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 256, 1024])
def test_nafblock_precision_guard(c, fp32_plain):
    """The card tests' NAFBlock (fan-in scaled weights, x uniform in [0,
    1)): the kernel's 3xTF32 products hold FUSED_REL_TOL, while the same
    block with one TF32 product (the five products' operands rounded to
    TF32, summed in float64) misses it, by 4.4-4.7x on the CPU's model of
    these inputs."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c)
    w = _naf_tree(rng, c, dev)
    x = _t(rng.uniform(size=(2, 12, 16, c)), dev)
    want = nafblock_fused_reference(x, w)
    tol = FUSED_REL_TOL * max(1.0, want.abs().max().item())
    err = (nafblock_fused(x, w) - want).abs().max().item()
    one = (_naf_one_product(x, w) - want.double()).abs().max().item()
    assert err <= tol
    assert one > tol


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,b", [((336, 512), 256, 1), ((17, 23), 36, 2),
                                    ((84, 128), 1024, 1), ((5, 3), 64, 3)])
def test_nafblock_plan_matches_the_kernel(hw, c, b):
    """ops/nafblock.py:plan_nafblock sizes the scratch the C entries check
    against their own plan; and #11's: ops/attention.py:
    plan_qkv_projections against its entry."""
    from freqfusion_tpu_torch.ops.attention import plan_qkv_projections
    from freqfusion_tpu_torch.ops.nafblock import plan_nafblock

    cuda_or_skip()
    lib = cuda.library()
    m = hw[0] * hw[1]
    assert lib.ff_nafblock_scratch_floats(m, c, b) == \
        plan_nafblock(m, c, b).scratch_floats
    assert lib.ff_window_attention_qkv_scratch_floats(b * m, c, c) == \
        plan_qkv_projections(b * m, c, c).scratch_floats


@pytest.mark.cuda
@pytest.mark.parametrize("c", [360, 128, 6])
@pytest.mark.parametrize("hw", [(13, 18), (112, 144), (1, 2)])
def test_dwconv_kernel(c, hw, fp32_plain):
    """SS2D's D 360 and NAFNet's first 2C 128 (float4 route), and C 6
    (scalar route), at ragged sizes and a 1 x 2 image."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c)
    x = _t(rng.normal(size=(2, *hw, c)), dev)
    k = _t(rng.normal(size=(3, 3, 1, c)), dev)
    b = _t(rng.normal(size=c), dev)
    cuda.reset_launch_counts()
    got = dwconv3x3(x, k, b)
    assert cuda.launch_counts["dwconv3x3"] == 1
    _fused_close(got, dwconv3x3_reference(x, k, b))


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,ws", [(180, 6, 16), (212, 4, 16),
                                        (244, 2, 16), (276, 6, 16),
                                        (308, 4, 16), (106, 2, 8),
                                        (60, 6, 8)])
def test_window_attention_qkv_kernel(c, heads, ws, fp32_plain):
    """DRCT-L's five widths at window 16 and two small ones (head dims 53
    and 10) at window 8, with and without the shift mask: 1 x 2 x 3
    windows, so the GEMMs' 128-row tiles end ragged."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + ws)
    h, w, n = 2 * ws, 3 * ws, ws * ws
    x = _t(rng.normal(size=(1, h, w, c)), dev)
    wqkv = _t(rng.normal(size=(c, 3 * c)) / np.sqrt(c), dev)
    wproj = _t(rng.normal(size=(c, c)) / np.sqrt(c), dev)
    bqkv, bproj = (_t(0.1 * rng.normal(size=k), dev) for k in (3 * c, c))
    bias = _t(0.5 * rng.normal(size=(heads, n, n)), dev)
    for shift in (0, ws // 2):
        mask = shifted_window_mask(h, w, ws, shift)
        args = (x, wqkv, bqkv, wproj, bproj, bias,
                None if mask is None else _t(mask, dev), heads, ws)
        cuda.reset_launch_counts()
        got = window_attention_qkv_nhwc(*args)
        assert dict(cuda.launch_counts) == {"window_attention_qkv_nhwc": 1}
        _fused_close(got, window_attention_qkv_nhwc_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", [(180, 6), (244, 2)])
@pytest.mark.parametrize("shift", [0, 8])
def test_window_attention_qkv_precision_guard(c, heads, shift, fp32_plain):
    """DRCT-L widths at window 16, the card tests' inputs: the kernel's
    3xTF32 projections hold FUSED_REL_TOL, while the same #11 with the two
    projections' operands rounded to TF32 (one TF32 product; the attention
    in float64) misses it, by 4.3-6.3x on the CPU's model of these
    inputs."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + 16)
    ws, d = 16, torch.float64
    h, w, n = 2 * ws, 3 * ws, ws * ws
    x = _t(rng.normal(size=(1, h, w, c)), dev)
    wqkv = _t(rng.normal(size=(c, 3 * c)) / np.sqrt(c), dev)
    wproj = _t(rng.normal(size=(c, c)) / np.sqrt(c), dev)
    bqkv, bproj = (_t(0.1 * rng.normal(size=k), dev) for k in (3 * c, c))
    bias = _t(0.5 * rng.normal(size=(heads, n, n)), dev)
    mask = shifted_window_mask(h, w, ws, shift)
    mask = None if mask is None else _t(mask, dev)
    args = (x, wqkv, bqkv, wproj, bproj, bias, mask, heads, ws)
    want = window_attention_qkv_nhwc_reference(*args)
    tol = FUSED_REL_TOL * max(1.0, want.abs().max().item())
    err = (window_attention_qkv_nhwc(*args) - want).abs().max().item()
    qkv = _tf32(x).to(d) @ _tf32(wqkv).to(d) + bqkv.to(d)
    att = window_attention_nhwc_reference(
        qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias.to(d),
        None if mask is None else mask.to(d), heads, ws)
    one = (_tf32(att).to(d) @ _tf32(wproj).to(d) + bproj.to(d)
           - want.to(d)).abs().max().item()
    assert err <= tol
    assert one > tol


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,ws", [(60, 3, 7), (96, 4, 12),
                                        (42, 3, 7)])
def test_window_attention_qkv_ragged_kernel(c, heads, ws, fp32_plain):
    """#11 with its attention stage at ragged windows: N 49 and 144 leave a
    partial last key tile and a partial query tile; C 42 gives rows of
    3 C = 126 floats, so the stage takes its 4-byte copies."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + ws + 1)
    h, w, n = 2 * ws, 2 * ws, ws * ws
    x = _t(rng.normal(size=(1, h, w, c)), dev)
    wqkv = _t(rng.normal(size=(c, 3 * c)) / np.sqrt(c), dev)
    wproj = _t(rng.normal(size=(c, c)) / np.sqrt(c), dev)
    bqkv, bproj = (_t(0.1 * rng.normal(size=k), dev) for k in (3 * c, c))
    bias = _t(0.5 * rng.normal(size=(heads, n, n)), dev)
    for shift in (0, ws // 2):
        mask = shifted_window_mask(h, w, ws, shift)
        args = (x, wqkv, bqkv, wproj, bproj, bias,
                None if mask is None else _t(mask, dev), heads, ws)
        cuda.reset_launch_counts()
        got = window_attention_qkv_nhwc(*args)
        assert dict(cuda.launch_counts) == {"window_attention_qkv_nhwc": 1}
        _fused_close(got, window_attention_qkv_nhwc_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
def test_grl_mixed_attention_qkv_kernel(shift, fp32_plain):
    """GRL-B's geometry (C 180, 3 + 3 heads of 30, window 8, 4 x 4
    anchors), batch 2; shifted blocks with x rolled by (-4, -4)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(20 + shift)
    x = _t(rng.normal(size=(2, 32, 48, 180)), dev)
    x_rolled = (torch.roll(x, (-shift, -shift), (1, 2)).contiguous()
                if shift else None)
    mask = shifted_window_mask(32, 48, 8, shift)
    args = (x, x_rolled, _t(rng.normal(size=(2, 16, 24, 90)), dev),
            _t(rng.normal(size=(180, 540)) / np.sqrt(180), dev),
            _t(0.1 * rng.normal(size=540), dev),
            *(_t(rng.uniform(1, 30, (3, 1, 1)), dev) for _ in range(3)),
            *(_t(rng.uniform(0, 16, s), dev)
              for s in ((3, 64, 64), (3, 16, 64), (3, 64, 16))),
            None if mask is None else _t(mask, dev), 3, 3, 8)
    cuda.reset_launch_counts()
    got = grl_mixed_attention_qkv_nhwc(*args)
    assert dict(cuda.launch_counts) == {"grl_mixed_attention_qkv_nhwc": 1}
    for g, w in zip(got, grl_mixed_attention_qkv_nhwc_reference(*args)):
        _fused_close(g, w)


def _grl_qkv_args(rng, dev, b, c2, heads_w, heads_s, shift, cin=None,
                  scale_range=(1, 30)):
    """x, x_rolled (or None), the anchor, wqkv [Cin, 6 C2], bqkv and the
    attention's tables of a #12 call on [b, 16, 24, Cin] (Cin 2 C2)."""
    cin = cin or 2 * c2
    x = _t(rng.normal(size=(b, 16, 24, cin)), dev)
    att = _grl_args(rng, dev, b, c2, heads_w, heads_s, shift, scale_range)
    return (x, torch.roll(x, (-4, -4), (1, 2)).contiguous() if shift
            else None, att[6],
            _t(rng.normal(size=(cin, 6 * c2)) / np.sqrt(cin), dev),
            _t(0.1 * rng.normal(size=6 * c2), dev), *att[7:])


@pytest.mark.cuda
@pytest.mark.parametrize("c2,heads_w,heads_s", [
    (42, 2, 3), (42, 6, 6), (90, 2, 3), (90, 6, 3), (180, 2, 6),
    (180, 6, 6)])
@pytest.mark.parametrize("shift", [False, True])
def test_grl_mixed_attention_qkv_shapes_kernel(c2, heads_w, heads_s, shift,
                                               fp32_plain):
    """#12 at batch 2 over head counts 2/3/6 and C/2 42, 90, 180 (Cin 84,
    180, 360: K padded to 96, 192, 368; 3 C/2 to 128, 320, 576 columns),
    shifted (x_rolled) and not; one launch a call."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(2 * c2 + heads_w + heads_s + shift)
    args = _grl_qkv_args(rng, dev, 2, c2, heads_w, heads_s, shift)
    cuda.reset_launch_counts()
    got = grl_mixed_attention_qkv_nhwc(*args)
    assert dict(cuda.launch_counts) == {"grl_mixed_attention_qkv_nhwc": 1}
    for g, w in zip(got, grl_mixed_attention_qkv_nhwc_reference(*args)):
        _fused_close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True])
def test_grl_mixed_attention_qkv_precision_guard(shift, fp32_plain):
    """GRL-B's geometry (C 180, 3 + 3 heads) with scales up to 100: the
    kernel's 3xTF32 projections and attention hold FUSED_REL_TOL, while the
    same #12 with the projection's operands rounded to TF32 (one TF32
    product; the attention in float64) misses it."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(40 + shift)
    d = torch.float64
    args = _grl_qkv_args(rng, dev, 2, 90, 3, 3, shift,
                         scale_range=(30, 100))
    x, xr, anchor, wqkv, bqkv = args[:5]
    want = grl_mixed_attention_qkv_nhwc_reference(*args)
    got = grl_mixed_attention_qkv_nhwc(*args)
    xw = x if xr is None else xr
    one_w = _tf32(xw).to(d) @ _tf32(wqkv).to(d) + bqkv.to(d)
    one_s = _tf32(x).to(d) @ _tf32(wqkv).to(d) + bqkv.to(d)
    tables = [a.to(d) if torch.is_tensor(a) else a for a in args[5:]]
    one = grl_mixed_attention_nhwc_reference(
        one_w[..., :90], one_w[..., 90:180], one_w[..., 180:270],
        one_s[..., 270:360], one_s[..., 360:450], one_s[..., 450:],
        anchor.to(d), *tables)
    torch.cuda.synchronize()
    misses = []
    for g, w, o in zip(got, want, one):
        tol = FUSED_REL_TOL * max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= tol
        misses.append((o - w.to(d)).abs().max().item() > tol)
    assert any(misses)


@pytest.mark.cuda
@pytest.mark.parametrize("m,cin,c2", [(336 * 512, 180, 90), (768, 84, 42),
                                      (64, 360, 180)])
def test_grl_qkv_plan_matches_the_kernel(m, cin, c2):
    """ops/attention.py:plan_grl_qkv_projections sizes #12's scratch as
    csrc/grl_attention_qkv.cu's grl_qkv_plan lays it out."""
    cuda_or_skip()
    plan = plan_grl_qkv_projections(m, cin, c2)
    assert cuda.library().ff_grl_qkv_scratch_floats(m, cin, c2) == (
        plan.scratch_floats)


def _token_args(rng, p, t, e, nh, dev, views, offset=0.0):
    """x [p, t, e] (offset + N(0, 1)) and fan-in scaled weights on the
    card; with `views`, the weights as the gated module hands them: the
    transposed views of torch-layout [3E, E] and [E, E] tensors."""
    win = rng.normal(size=(e, 3 * e)) / np.sqrt(e)
    wout = rng.normal(size=(e, e)) / np.sqrt(e)
    if views:
        win_t, wout_t = _t(win.T, dev), _t(wout.T, dev)
        win, wout = win_t.t(), wout_t.t()
    else:
        win, wout = _t(win, dev), _t(wout, dev)
    return [_t(offset + rng.normal(size=(p, t, e)), dev), win,
            _t(0.1 * rng.normal(size=3 * e), dev), wout,
            _t(0.1 * rng.normal(size=e), dev), nh]


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,nh", [(9, 64, 4), (4, 128, 8)])
@pytest.mark.parametrize("p", [14000, 5, 336 * 512])
@pytest.mark.parametrize("views", [False, True])
def test_token_attention_kernel(t, e, nh, p, views, fp32_plain):
    """Both fusion-net geometries at P = 100 x 140 (not a multiple of the
    14 or 32 pixels a tile holds), at P = 5 (one partial tile) and at the
    path's P = 336 x 512; the weights contiguous [in, out] and as the
    module's transposed views (strides (1, E))."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(t + p)
    args = _token_args(rng, p, t, e, nh, dev, views)
    cuda.reset_launch_counts()
    got = token_attention(*args)
    assert dict(cuda.launch_counts) == {"token_attention": 1}
    _fused_close(got, token_attention_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,nh", [(16, 160, 1), (16, 160, 2), (9, 160, 10),
                                    (3, 12, 4), (2, 72, 6), (6, 120, 10),
                                    (1, 4, 1)])
def test_token_attention_other_geometries_kernel(t, e, nh, fp32_plain):
    """Off the path: heads wider than 16 (a group each; one team of 32
    rows at E 160 in one head, two at E 160 in two), heads of 16 or less
    two a group at E > 64 (E 160: teams of 32 rows; E 120 in ten heads of
    12: a zero head pads the last group), E 12 and E 4 (K padded to 8), P
    = 1001."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(t + e + nh)
    args = _token_args(rng, 1001, t, e, nh, dev, True)
    _fused_close(token_attention(*args), token_attention_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,nh", [(9, 64, 4), (4, 128, 8)])
def test_token_attention_precision_guard(t, e, nh, fp32_plain):
    """x 2 + N(0, 1) and out_b centred (minus the mean over rows of the
    output it would give: a moderate output of larger terms): the kernel's
    3xTF32 projections hold FUSED_REL_TOL, while the same attention with
    both projections' operands rounded to TF32 (one TF32 product; the
    attention in float64) misses it, by ~13x on the CPU's model of these
    inputs (tests/test_torch_token_attention_plan.py)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(t + 13)
    args = _token_args(rng, 2000, t, e, nh, dev, True, offset=2.0)
    args[4] = args[4] - token_attention_reference(*args).reshape(
        -1, e).mean(0)
    x, win, bin_, wout, bout = args[:5]
    want = token_attention_reference(*args)
    tol = FUSED_REL_TOL * max(1.0, want.abs().max().item())
    err = (token_attention(*args) - want).abs().max().item()
    d, hd = torch.float64, e // nh
    q, k, v = (_tf32(x).to(d) @ _tf32(win).to(d) + bin_.to(d)).reshape(
        -1, t, 3, nh, hd).unbind(2)
    att = torch.einsum("pqhd,pkhd->phqk", q, k) / hd ** 0.5
    o = torch.einsum("phqk,pkhd->pqhd", att.softmax(-1), v).reshape(-1, t, e)
    one = (_tf32(o).to(d) @ _tf32(wout).to(d) + bout.to(d)
           - want.to(d)).abs().max().item()
    assert err <= tol
    assert one > tol


@pytest.mark.cuda
@pytest.mark.parametrize("p,t,e,nh", [(336 * 512, 9, 64, 4),
                                      (336 * 512, 4, 128, 8), (5, 16, 160, 1),
                                      (7, 3, 12, 4)])
def test_token_attention_plan_matches_the_kernel(p, t, e, nh):
    """ops/token_attention.py:plan_token_attention sizes the scratch as
    csrc/token_attention.cu's ta_plan lays it out."""
    from freqfusion_tpu_torch.ops.token_attention import plan_token_attention

    cuda_or_skip()
    assert cuda.library().ff_token_attention_scratch_floats(p, t, e, nh) == (
        plan_token_attention(p, t, e, nh).scratch_floats)


def _tree(rng, spec, dev):
    """Weights on the card from {name: shape | subtree}: kernels
    [kh, kw, cin, cout] fan-in scaled, BN variances positive, BN scales
    near 1, the rest 0.1-scaled normal draws."""
    out = {}
    for k, v in spec.items():
        if isinstance(v, dict):
            out[k] = _tree(rng, v, dev)
        elif k == "var":
            out[k] = _t(rng.uniform(0.5, 1.5, v), dev)
        elif k == "kernel":
            out[k] = _t(rng.normal(size=v) / np.sqrt(np.prod(v[:-1])), dev)
        elif k == "scale" and v:
            out[k] = _t(1 + 0.1 * rng.normal(size=v), dev)
        else:
            out[k] = _t(0.1 * rng.normal(size=v) if v else rng.uniform(0.1, 1),
                        dev)
    return out


def _conv(k, cin, cout, bias=True):
    return ({"kernel": (k, k, cin, cout), "bias": (cout,)} if bias
            else {"kernel": (k, k, cin, cout)})


def _image(rng, b, hw, c, nchw, dev, uniform=False):
    """[B, H, W, C] on the card, NHWC-contiguous or an NCHW view."""
    shape = (b, c, *hw) if nchw else (b, *hw, c)
    a = rng.uniform(size=shape) if uniform else rng.normal(size=shape)
    t = _t(a, dev)
    return t.permute(0, 2, 3, 1) if nchw else t


# H and W not multiples of the tiles (32 x 32 for the LKA's depthwise pass,
# 16 x 16/32 for the convs), one image smaller than a tile, and 112 x 144,
# the HR/4 level of a 100 x 140 request after padding
BORDER_SHAPES = [(13, 18), (45, 70), (112, 144)]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("hw", BORDER_SHAPES)
def test_lka_kernel(c, hw, fp32_plain):
    """The fusion net's LKABlock at phase 3's C 64 and phase 4's C 128,
    batch 2."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + hw[0])
    p = _lka_tree(rng, c, dev)
    x = _image(rng, 2, hw, c, False, dev)
    cuda.reset_launch_counts()
    got = lka_block_fused(x, p)
    assert dict(cuda.launch_counts) == {"lka_block_fused": 1}
    _fused_close(got, lka_block_fused_reference(x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("nchw", [False, True])
@pytest.mark.parametrize("hw", BORDER_SHAPES)
def test_hier_kernel(nchw, hw, fp32_plain):
    """Stage 3 + to_rgb (76 in, base_channels 64), batch 2, s3_in NHWC and
    as an NCHW view."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(hw[0] + nchw)
    p = _hier_tree(rng, dev)
    x = _image(rng, 2, hw, 76, nchw, dev, uniform=True)
    cuda.reset_launch_counts()
    got = hier_stage3_fused(x, p)
    assert dict(cuda.launch_counts) == {"hier_stage3_fused": 1}
    assert (got.permute(0, 3, 1, 2) if nchw else got).is_contiguous()
    _fused_close(got, hier_stage3_fused_reference(x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("c,ch", [(60, 120), (100, 200), (128, 192)])
def test_lka_kernel_padded_widths(c, ch, fp32_plain):
    """Widths the mix pads (C 60 to 64, C 100 to 128) and a hidden
    narrower than 2C, batch 2 at a border shape."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + ch)
    p = _lka_tree(rng, c, dev)
    p["ffn_0"] = _tree(rng, {"k": _conv(1, c, ch)}, dev)["k"]
    p["ffn_2"] = _tree(rng, {"k": _conv(1, ch, c)}, dev)["k"]
    x = _image(rng, 2, (45, 70), c, False, dev)
    got = lka_block_fused(x, p)
    _fused_close(got, lka_block_fused_reference(x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,nchw", [(35, False), (35, True), (64, False)])
def test_hier_kernel_other_inputs(cin, nchw, fp32_plain):
    """s3_in of other widths: 35 (padded to 40; 4-byte copies from NHWC
    too) and 64, batch 2 at a border shape."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(cin + nchw)
    p = _hier_tree(rng, dev)
    p["stage3_conv_0"] = _tree(rng, {"k": _conv(3, cin, 64)}, dev)["k"]
    x = _image(rng, 2, (45, 70), cin, nchw, dev, uniform=True)
    got = hier_stage3_fused(x, p)
    assert (got.permute(0, 3, 1, 2) if nchw else got).is_contiguous()
    _fused_close(got, hier_stage3_fused_reference(x, p))


def _hier_tree(rng, dev, scale=1.0):
    p = _tree(rng, {"stage3_conv_0": _conv(3, 76, 64),
                    "stage3_conv_2": _conv(3, 64, 32),
                    "stage3_gate": {"gate_0": _conv(1, 32, 8),
                                    "gate_2": _conv(1, 8, 1)},
                    "stage3_res": {"block_0": _conv(3, 32, 32, False),
                                   "block_2": _conv(3, 32, 32, False),
                                   "scale": ()},
                    "rw23": (), "to_rgb_0": _conv(3, 32, 16),
                    "to_rgb_2": _conv(3, 16, 3)}, dev)
    for q in (p["stage3_conv_0"], p["stage3_conv_2"], p["to_rgb_0"],
              p["to_rgb_2"], p["stage3_res"]["block_0"],
              p["stage3_res"]["block_2"]):
        q["kernel"].mul_(scale)
    return p


def _hier_one_product(s3, p):
    """Stage 3 + to_rgb with each conv as one TF32 product: its input and
    kernel rounded to TF32, summed in float64."""
    from freqfusion_tpu_torch.ops.hier import conv3x3, dense1x1

    d = torch.float64
    gelu = torch.nn.functional.gelu

    def conv(x, q):
        return conv3x3(_tf32(x).to(d), {"kernel": _tf32(q["kernel"]).to(d),
                                        "bias": None if "bias" not in q
                                        else q["bias"].to(d)})

    def dense(x, q):
        return dense1x1(x, {k: v.to(d) for k, v in q.items()})
    a = gelu(conv(gelu(conv(s3, p["stage3_conv_0"])), p["stage3_conv_2"]))
    g = p["stage3_gate"]
    f = a * torch.sigmoid(dense(gelu(dense(a, g["gate_0"])), g["gate_2"]))
    r = p["stage3_res"]
    f3 = (f + r["scale"].to(d) * conv(gelu(conv(f, r["block_0"])),
                                      r["block_2"])
          + p["rw23"].to(d) * s3[..., :32].to(d))
    return torch.sigmoid(conv(gelu(conv(f3, p["to_rgb_0"])), p["to_rgb_2"]))


@pytest.mark.cuda
def test_hier_precision_guard(fp32_plain):
    """Large inputs (s3_in 8 + N(0, 1) as the fusion net's NCHW view): the
    kernel's 3xTF32 convs hold FUSED_REL_TOL, while the same chain with one
    TF32 product a conv misses it, by ~13x on the CPU's model of such
    inputs (tests/test_torch_fusion_eval_plan.py). With the kernels at 2x
    their fan-in scale the plain version's own fp32 sums come within a
    fifth of the tolerance and the card's 3xTF32 past it."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(23)
    p = _hier_tree(rng, dev)
    s3 = _t(8 + rng.normal(size=(1, 76, 48, 64)), dev).permute(0, 2, 3, 1)
    want = hier_stage3_fused_reference(s3, p)
    tol = FUSED_REL_TOL * max(1.0, want.abs().max().item())
    err = (hier_stage3_fused(s3, p) - want).abs().max().item()
    one = (_hier_one_product(s3, p) - want.double()).abs().max().item()
    assert err <= tol
    assert one > tol


def _edge_refine_tree(rng, dev):
    return _tree(rng, {"proj": _conv(1, 3, 32), "conv1": _conv(3, 3, 32),
                       "conv2": _conv(3, 32, 32), "conv3": _conv(3, 32, 32),
                       "attn_0": _conv(1, 32, 8), "attn_2": _conv(3, 8, 1)},
                 dev)


def _one_product_conv(x, q):
    """A 3x3 conv as one TF32 product: its input and kernel rounded to
    TF32, summed in float64."""
    from freqfusion_tpu_torch.ops.hier import conv3x3

    d = torch.float64
    return conv3x3(_tf32(x).to(d), {"kernel": _tf32(q["kernel"]).to(d),
                                    "bias": q["bias"].to(d)})


def _edge_refine_one_product(lap, p):
    """The EdgeRefineBlock with one TF32 product a conv (the projection's
    too: the kernel runs it inside conv3), the squeeze in float64."""
    from freqfusion_tpu_torch.ops.hier import dense1x1

    d, gelu = torch.float64, torch.nn.functional.gelu
    h = gelu(_one_product_conv(gelu(_one_product_conv(lap, p["conv1"])),
                               p["conv2"]))
    proj = {"kernel": _tf32(p["proj"]["kernel"]).to(d),
            "bias": p["proj"]["bias"].to(d)}
    t = _one_product_conv(h, p["conv3"]) + dense1x1(_tf32(lap).to(d), proj)
    sq = gelu(dense1x1(t, {k: v.to(d) for k, v in p["attn_0"].items()}))
    return t * torch.sigmoid(_one_product_conv(sq, p["attn_2"]))


@pytest.mark.cuda
def test_edge_refine_precision_guard(fp32_plain):
    """Large inputs (lap 8 + N(0, 1) as the fusion net's NCHW view): the
    kernel's 3xTF32 convs hold FUSED_REL_TOL, while the same block with one
    TF32 product a conv misses it, by ~8x on the CPU's model of such inputs
    (tests/test_torch_edge_plan.py)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(29)
    p = _edge_refine_tree(rng, dev)
    lap = _t(8 + rng.normal(size=(1, 3, 48, 64)), dev).permute(0, 2, 3, 1)
    want = edge_refine_fused_reference(lap, p)
    tol = FUSED_REL_TOL * max(1.0, want.abs().max().item())
    err = (edge_refine_fused(lap, p) - want).abs().max().item()
    one = (_edge_refine_one_product(lap, p) - want.double()).abs().max()
    assert err <= tol
    assert one.item() > tol


def _edge_fuse_one_product(sr, feats, lw, strength, p):
    """The edge fuse with one TF32 product a conv (fusion_0's kernel rows
    scaled by the level weights in fp32, as the kernel's split does);
    returns the output and the value before the clip."""
    d, gelu = torch.float64, torch.nn.functional.gelu
    f = feats[0].shape[-1]
    w0 = {"kernel": p["fusion_0"]["kernel"] * lw.repeat_interleave(f)[:, None],
          "bias": p["fusion_0"]["bias"]}
    e1 = gelu(_one_product_conv(torch.cat(feats, -1), w0))
    edge = _one_product_conv(e1, p["fusion_2"])
    g = gelu(_one_product_conv(torch.cat([sr.to(d), edge], -1),
                               p["edge_gate_0"]))
    gate = torch.sigmoid(_one_product_conv(g, p["edge_gate_2"]))
    pre = sr.to(d) + gate * strength.to(d) * edge
    return pre.clamp(0.0, 1.0), pre


@pytest.mark.cuda
def test_edge_fuse_precision_guard(fp32_plain):
    """Levels 8 + N(0, 1), sr 0.5 + 0.1 N(0, 1) and strength 1, as the
    fusion net's NCHW views; fusion_2's bias minus the mean of its conv
    over the image (an edge of large terms that cancel) and the gate held
    near 0.2 (edge_gate_2's kernel at a tenth, its bias log(0.25)), so
    that under 10% of the outputs clip (under 1% on the CPU's model): the
    kernel's 3xTF32 convs hold FUSED_REL_TOL through the clipped output,
    while one TF32 product a conv misses it, by ~5x on the CPU's model
    (tests/test_torch_edge_plan.py)."""
    from freqfusion_tpu_torch.ops.hier import conv3x3

    dev = cuda_or_skip()
    rng = np.random.default_rng(31)
    p = _tree(rng, {"fusion_0": _conv(3, 96, 32), "fusion_2": _conv(3, 32, 3),
                    "edge_gate_0": _conv(3, 6, 16),
                    "edge_gate_2": _conv(3, 16, 1)}, dev)
    hw = (48, 64)
    sr = _t(np.clip(0.5 + 0.1 * rng.normal(size=(1, 3, *hw)), 0, 1),
            dev).permute(0, 2, 3, 1)
    feats = [_t(8 + rng.normal(size=(1, 32, *hw)), dev).permute(0, 2, 3, 1)
             for _ in range(3)]
    lw = torch.softmax(_t(rng.normal(size=3), dev), 0)
    strength = _t(1.0, dev)
    p["edge_gate_2"]["kernel"].mul_(0.1)
    p["edge_gate_2"]["bias"].fill_(float(np.log(0.25)))
    allf = torch.cat([t * lw[i] for i, t in enumerate(feats)], -1)
    e = conv3x3(torch.nn.functional.gelu(conv3x3(allf, p["fusion_0"])),
                {"kernel": p["fusion_2"]["kernel"]})
    p["fusion_2"]["bias"] = -e.mean((0, 1, 2))
    want = edge_fuse_fused_reference(sr, *feats, lw, strength, p)
    tol = FUSED_REL_TOL * max(1.0, want.abs().max().item())
    err = (edge_fuse_fused(sr, *feats, lw, strength, p)
           - want).abs().max().item()
    one, pre = _edge_fuse_one_product(sr, feats, lw, strength, p)
    assert ((pre < 0) | (pre > 1)).double().mean().item() < 0.1
    assert err <= tol
    assert (one - want.double()).abs().max().item() > tol


def _lka_tree(rng, c, dev, scale=1.0):
    bn = {"scale": (c,), "bias": (c,), "mean": (c,), "var": (c,)}
    p = _tree(rng, {"norm1": bn, "norm2": bn,
                    "lka": {"local_conv": {"kernel": (5, 5, 1, c)},
                            "h_conv": {"kernel": (1, 21, 1, c)},
                            "v_conv": {"kernel": (21, 1, 1, c)},
                            "pw_conv": {"kernel": (1, 1, c, c)}, "bn": bn},
                    "ffn_0": _conv(1, c, 2 * c), "ffn_2": _conv(1, 2 * c, c),
                    "scale1": (), "scale2": ()}, dev)
    for q in (p["lka"]["pw_conv"], p["ffn_0"], p["ffn_2"]):
        q["kernel"].mul_(scale)
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 128])
def test_lka_precision_guard(c, fp32_plain):
    """Large inputs (x 8 + N(0, 1), the three products' kernels 4x their
    fan-in scale): the kernel's 3xTF32 products hold FUSED_REL_TOL, while
    the same block with one TF32 product each (operands rounded to TF32,
    summed in float64, on the folded weights) misses it, by ~6x on the
    CPU's model of such inputs (tests/test_torch_fusion_eval_plan.py)."""
    from freqfusion_tpu_torch.ops.lka import _dw, fold_lka

    dev = cuda_or_skip()
    rng = np.random.default_rng(c + 9)
    p = _lka_tree(rng, c, dev, 4.0)
    x = _t(8 + rng.normal(size=(1, 48, 64, c)), dev)
    want = lka_block_fused_reference(x, p)
    tol = FUSED_REL_TOL * max(1.0, want.abs().max().item())
    err = (lka_block_fused(x, p) - want).abs().max().item()
    d, gelu = torch.float64, torch.nn.functional.gelu
    fold = fold_lka(p)
    t = x * fold["s1"] + fold["b1"]
    a = t
    for k in ("local_conv", "h_conv", "v_conv"):
        a = _dw(a, p["lka"][k]["kernel"])

    def mm(u, w):
        return _tf32(u).to(d) @ _tf32(w).to(d)
    x1 = x.to(d) + p["scale1"].to(d) * t.to(d) * torch.sigmoid(
        mm(a, fold["pw"]) + fold["bbn"].to(d))
    hid = gelu(mm(x1.float(), fold["f0"]) + fold["c0"].to(d))
    f = mm(hid.float(), p["ffn_2"]["kernel"][0, 0])
    one = x1 + p["scale2"].to(d) * (f + p["ffn_2"]["bias"].to(d))
    assert err <= tol
    assert (one - want.to(d)).abs().max().item() > tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,ch", [(1, 336, 512, 64, 128),
                                        (1, 336, 512, 128, 256),
                                        (2, 13, 18, 60, 120)])
def test_fusion_eval_plans_match_the_kernels(b, h, w, c, ch):
    """ops/hier.py:plan_hier and ops/lka.py:plan_lka size the scratch as
    csrc/hier.cu's hier_plan and csrc/lka.cu lay it out, fp32 and bf16
    (the bf16 hier convs' extents and shared memory: plan_hier_bf16 and
    ff_hier_bf16_plan)."""
    from freqfusion_tpu_torch.ops.hier import plan_hier, plan_hier_bf16
    from freqfusion_tpu_torch.ops.lka import plan_lka

    cuda_or_skip()
    lib = cuda.library()
    assert lib.ff_hier_scratch_floats(76, 64) == plan_hier(
        4 * h, 4 * w, 76).scratch_floats
    assert lib.ff_lka_scratch_floats(b * h * w, c, ch) == plan_lka(
        b, h, w, c, ch).scratch_floats
    out = (ctypes.c_int * 5)()
    for i, conv in enumerate(plan_hier_bf16(4 * h, 4 * w, 76).convs):
        assert lib.ff_hier_bf16_plan(i, out) == 0
        assert list(out) == [conv.cinp, conv.n, conv.rows, conv.halo,
                             conv.smem]
    assert lib.ff_hier_bf16_plan(6, out) == -1
    assert lib.ff_lka_bf16_scratch_floats(b * h * w, c, ch) == plan_lka(
        b, h, w, c, ch, bf16=True).scratch_floats


@pytest.mark.cuda
@pytest.mark.parametrize("cin,f", [(3, 32), (5, 20)])
def test_edge_plans_match_the_kernels(cin, f):
    """ops/edge.py:plan_edge sizes the scratch as csrc/edge.cu's edge_plan
    lays it out, for refine (a level of cin channels) and fuse (levels of
    f channels), fp32 and bf16."""
    from freqfusion_tpu_torch.ops.edge import plan_edge

    cuda_or_skip()
    lib = cuda.library()
    assert lib.ff_edge_scratch_floats(cin, 32, 0) == plan_edge(
        8, 8, cin).scratch_floats
    assert lib.ff_edge_scratch_floats(3, f, 1) == plan_edge(
        8, 8, 3, f, fuse=True).scratch_floats
    assert lib.ff_edge_bf16_scratch_floats(cin, 32, 0) == plan_edge(
        8, 8, cin, bf16=True).scratch_floats
    assert lib.ff_edge_bf16_scratch_floats(3, f, 1) == plan_edge(
        8, 8, 3, f, fuse=True, bf16=True).scratch_floats


@pytest.mark.cuda
@pytest.mark.parametrize("nchw", [False, True])
@pytest.mark.parametrize("hw", BORDER_SHAPES)
def test_edge_refine_kernel(nchw, hw, fp32_plain):
    """One EdgeRefineBlock (3 -> 32), batch 2, NHWC and NCHW views."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(hw[0] + nchw + 7)
    p = _tree(rng, {"proj": _conv(1, 3, 32), "conv1": _conv(3, 3, 32),
                    "conv2": _conv(3, 32, 32), "conv3": _conv(3, 32, 32),
                    "attn_0": _conv(1, 32, 8), "attn_2": _conv(3, 8, 1)}, dev)
    lap = _image(rng, 2, hw, 3, nchw, dev)
    cuda.reset_launch_counts()
    got = edge_refine_fused(lap, p)
    assert dict(cuda.launch_counts) == {"edge_refine_fused": 1}
    _fused_close(got, edge_refine_fused_reference(lap, p))


@pytest.mark.cuda
@pytest.mark.parametrize("nchw", [False, True])
@pytest.mark.parametrize("hw", BORDER_SHAPES)
def test_edge_fuse_kernel(nchw, hw, fp32_plain):
    """Weighted concat (3 x 32), fusion, gate and clip, batch 2, NHWC and
    NCHW views."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(hw[0] + nchw + 11)
    p = _tree(rng, {"fusion_0": _conv(3, 96, 32), "fusion_2": _conv(3, 32, 3),
                    "edge_gate_0": _conv(3, 6, 16),
                    "edge_gate_2": _conv(3, 16, 1)}, dev)
    sr = _image(rng, 2, hw, 3, nchw, dev, uniform=True)
    feats = [_image(rng, 2, hw, 32, nchw, dev) for _ in range(3)]
    lw = torch.softmax(_t(rng.normal(size=3), dev), 0)
    strength = _t(rng.uniform(0.5, 2), dev)
    cuda.reset_launch_counts()
    got = edge_fuse_fused(sr, *feats, lw, strength, p)
    assert dict(cuda.launch_counts) == {"edge_fuse_fused": 1}
    _fused_close(got, edge_fuse_fused_reference(sr, *feats, lw, strength, p))


@pytest.mark.cuda
def test_edge_kernels_take_module_views(fp32_plain):
    """The modules hand their kernels as views of PyTorch's OIHW weights,
    not copies: both kernels read them through their strides, batch 2 at a
    border shape, in the NCHW views the fusion net hands them."""
    from freqfusion_tpu_torch.models.fusion.edge import (
        EdgeRefineBlock, LaplacianPyramidRefinement)

    dev = cuda_or_skip()
    torch.manual_seed(0)
    rm = EdgeRefineBlock(3, 32).to(dev).requires_grad_(False)
    em = LaplacianPyramidRefinement(3, 32, 0.15).to(dev).requires_grad_(False)
    tree, fuse_tree = rm.fused_params(), em.fuse_params()
    assert not tree["conv2"]["kernel"].is_contiguous()
    assert not fuse_tree["fusion_0"]["kernel"].is_contiguous()
    rng = np.random.default_rng(37)
    lap = _image(rng, 2, (45, 70), 3, True, dev)
    _fused_close(edge_refine_fused(lap, tree),
                 edge_refine_fused_reference(lap, tree))
    sr = _image(rng, 2, (45, 70), 3, True, dev, uniform=True)
    feats = [_image(rng, 2, (45, 70), 32, True, dev) for _ in range(3)]
    args = (sr, *feats, torch.softmax(em.level_weights, 0), em.edge_strength,
            fuse_tree)
    _fused_close(edge_fuse_fused(*args), edge_fuse_fused_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", [(180, 6), (212, 4), (244, 2), (276, 6),
                                     (308, 4)])
def test_window_attention_window_major_kernel(c, heads):
    """TPU kernel #10 at DRCT-L's five widths (N 256, two images of six
    windows), with and without the shift mask: against its plain version
    (ATTN_TOL), and bit-equal to #1 on the same windows in NHWC form (one
    kernel body, the same arithmetic in the same order)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + 1)
    h, w, ws = 32, 48, 16
    q, k, v = (_t(rng.normal(size=(2, h, w, c)), dev) for _ in range(3))
    qw, kw, vw = (window_partition(t, ws).contiguous() for t in (q, k, v))
    bias = _t(0.5 * rng.normal(size=(heads, ws * ws, ws * ws)), dev)
    for shift in (0, ws // 2):
        mask = shifted_window_mask(h, w, ws, shift)
        m = None if mask is None else _t(mask, dev)
        cuda.reset_launch_counts()
        got = window_attention(qw, kw, vw, bias, m, heads)
        want = window_attention_reference(qw, kw, vw, bias, m, heads)
        nhwc = window_partition(
            window_attention_nhwc(q, k, v, bias, m, heads, ws), ws)
        torch.cuda.synchronize()
        assert cuda.launch_counts["window_attention"] == 1
        assert (got - want).abs().max().item() <= ATTN_TOL
        assert torch.equal(got, nhwc)


@pytest.mark.cuda
@pytest.mark.parametrize("b_,n,nw,heads,hd", [(12, 49, 3, 3, 20),
                                              (4, 96, 2, 2, 7),
                                              (3, 1, 1, 1, 256)])
def test_window_attention_window_major_shapes(b_, n, nw, heads, hd):
    """#10 where #1 cannot go: N 49 (scalar bias and mask reads), N 96
    (not a square, a partial tile, odd head dim), one token with hd 256."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(n)
    c = heads * hd
    q, k, v = (_t(rng.normal(size=(b_, n, c)), dev) for _ in range(3))
    bias = _t(rng.normal(size=(heads, n, n)), dev)
    mask = _t(np.where(rng.random((nw, n, n)) < 0.2, -100.0, 0.0), dev)
    for m in (None, mask):
        got = window_attention(q, k, v, bias, m, heads)
        want = window_attention_reference(q, k, v, bias, m, heads)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= ATTN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 131), (2, 333, 180), (3, 50, 360)])
def test_layernorm_kernel(shape, dtype):
    """TPU kernel #22: C 131 takes the scalar loop, 180 and 360 the
    vector one. fp32 within LN_TOL of the plain version; bf16 within one
    bf16 ulp of it (both round the fp32 result once)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(shape[-1])
    x = _t(rng.normal(size=shape), dev).to(dtype)
    wt, b = (_t(rng.normal(size=shape[-1]), dev) for _ in range(2))
    want = fused_layernorm_reference(x, wt, b).float()

    def check(got):
        assert got.dtype == dtype and got.shape == x.shape
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **LN_TOL)
        else:
            ulp = torch.exp2(torch.floor(torch.log2(
                want.abs().clamp_min(2.0 ** -126))) - 7)
            assert bool(((got.float() - want).abs() <= ulp).all())

    cuda.reset_launch_counts()
    check(fused_layernorm(x, wt, b))
    torch.cuda.synchronize()
    assert cuda.launch_counts["fused_layernorm"] == 1
    # a misaligned base takes the scalar loop
    xs = torch.empty(x.numel() + 1, device=dev, dtype=dtype)[1:]
    check(fused_layernorm(xs.view(shape).copy_(x), wt, b))


# bf16 kernels against their bf16 plain versions (the same rounding
# points): fp32 sums in another order, so an output may land on the
# neighbouring bf16 value; max-abs within two bf16 ulps of the output's
# largest magnitude
BF16_ULPS = 2


def _bf16_close(got, want, name):
    torch.cuda.synchronize()
    assert cuda.launch_counts[name] == 1
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        top = w.float().abs().max().item()
        tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)
        assert (g.float() - w.float()).abs().max().item() <= tol


def _b(a, dev):
    return _t(a, dev).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,ws,shift", [(244, 2, 16, 8),
                                              (60, 6, 8, 0)])
def test_window_attention_bf16_kernel(c, heads, ws, shift):
    """DRCT-L's widest head (hd 122, shifted) and a small one (hd 10):
    bf16 q, k, v and bias, fp32 mask, as the bf16 module hands them."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c)
    h, w, n = 2 * ws, 3 * ws, ws * ws
    q, k, v = (_b(rng.normal(size=(2, h, w, c)), dev) for _ in range(3))
    bias = _b(0.5 * rng.normal(size=(heads, n, n)), dev)
    mask = shifted_window_mask(h, w, ws, shift)
    args = (q, k, v, bias, None if mask is None else _t(mask, dev), heads, ws)
    cuda.reset_launch_counts()
    got = window_attention_nhwc(*args)
    _bf16_close(got, window_attention_nhwc_reference(*args),
                "window_attention_nhwc.bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("c2,heads,shift", [(90, 3, True), (24, 3, False)])
def test_grl_mixed_attention_bf16_kernel(c2, heads, shift):
    """GRL-B's halves (hd 30, shifted) and hd 8: bf16 halves and anchor,
    fp32 scales, biases and mask, as the bf16 module hands them."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c2)
    args = list(_grl_args(rng, dev, 2, c2, heads, heads, shift))
    args[:7] = [a.to(torch.bfloat16) for a in args[:7]]
    cuda.reset_launch_counts()
    got = grl_mixed_attention_nhwc(*args)
    _bf16_close(got, grl_mixed_attention_nhwc_reference(*args),
                "grl_mixed_attention_nhwc.bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("t,r,d,n,dtr,reverse", [(40, 24, 360, 16, 12, True),
                                                 (9, 5, 20, 4, 2, False),
                                                 (13, 7, 60, 8, 4, True),
                                                 (21, 11, 200, 16, 13, False),
                                                 (5, 37, 200, 8, 5, True)])
def test_scan_chain_proj_bf16_kernel(t, r, d, n, dtr, reverse):
    """MambaIR's widths over several chunks, backward, and a narrow
    generic shape (D % 8 != 0: value-by-value staging), forward: bf16 xc
    and weights, fp32 A, bf16 D and dt bias, as SS2D hands them. Then
    ragged shapes for the wgmma projection and the bf16 passes: D 60 (K
    padded to 64, one column chunk) and 200 (two chunks), T not a
    multiple of 16 (chains wrap inside a stage), N 8 (the generic
    passes), each direction."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(d)
    xc = _b(rng.normal(size=(2, t, r, d)), dev)
    xpw = _b(rng.uniform(-1, 1, (dtr + 2 * n, d)) / np.sqrt(d), dev)
    dtw = _b(rng.uniform(-1, 1, (d, dtr)) / np.sqrt(dtr), dev)
    A = _t(-np.tile(np.arange(1, n + 1), (d, 1)), dev)
    D = _b(1 + 0.1 * rng.normal(size=d), dev)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), d))
    bias = _b(dt + np.log(-np.expm1(-dt)), dev)
    args = (xc, xpw, dtw, A, D, bias, reverse)
    cuda.reset_launch_counts()
    got = selective_scan_chain_proj(*args)
    _bf16_close(got, selective_scan_chain_proj_reference(*args),
                "selective_scan.bf16")


@pytest.mark.cuda
def test_scan_chain_proj_bf16_launches_only_its_kernels():
    """A bf16 #3/#4 call after the first launches the wgmma projection,
    pass 1, the compose and pass 2, and nothing else: its operands (the
    composed weight in the kernel's order, D and the bias in fp32) are
    built once, not on every call."""
    from torch.profiler import ProfilerActivity, profile

    dev = cuda_or_skip()
    rng = np.random.default_rng(3)
    d, n, dtr = 64, 16, 4
    xc = _b(rng.normal(size=(1, 16, 8, d)), dev)
    xpw = _b(rng.uniform(-1, 1, (dtr + 2 * n, d)) / np.sqrt(d), dev)
    dtw = _b(rng.uniform(-1, 1, (d, dtr)) / np.sqrt(dtr), dev)
    A = _t(-np.tile(np.arange(1, n + 1), (d, 1)), dev)
    D, bias = _b(np.ones(d), dev), _b(np.full(d, -3.0), dev)
    args = (xc, xpw, dtw, A, D, bias, False)
    selective_scan_chain_proj(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        selective_scan_chain_proj(*args)
        torch.cuda.synchronize()
    names = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            names.append(e.key)
    assert len(names) == 4, names
    assert sum("scan_project_wgmma_kernel" in k for k in names) == 1, names
    assert sum("scan_pass16_kernel" in k for k in names) == 2, names
    assert sum("scan_compose_kernel" in k for k in names) == 1, names


def _scan_bf16_inputs(rng, lead, d, n, dev, bf16_dt: bool, group=()):
    """_scan_inputs with u in bf16 and, where `bf16_dt`, dt, B and C too;
    A, D and the bias fp32 (the bias bf16, as SS2D's routes hand it)."""
    u, dt, A, B, C, D, bias = _scan_inputs(rng, lead, d, n, dev, group)
    cast = (lambda x: x.to(torch.bfloat16)) if bf16_dt else (lambda x: x)
    return (u.to(torch.bfloat16), cast(dt), A, cast(B), cast(C), D,
            bias.to(torch.bfloat16))


def _scan_fp32_close(got, want, name):
    """fp32 y of a bf16 scan kernel against its plain version: the scan
    tolerance, relative to max |y|."""
    torch.cuda.synchronize()
    assert dict(cuda.launch_counts) == {name: 1}
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert (g - w).abs().max() <= SCAN_REL_TOL * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("t,r,d,n,reverse", [(40, 24, 360, 16, True),
                                             (40, 24, 360, 16, False),
                                             (9, 5, 20, 4, False),
                                             (37, 29, 24, 8, True),
                                             (13, 7, 60, 8, True),
                                             (21, 11, 200, 16, False),
                                             (5, 37, 200, 8, True)])
def test_scan_chain_bf16_kernel(t, r, d, n, reverse):
    """#5 in bf16 (chainv5's operands: u, dt, B, C bf16, y bf16 through
    out_dtype) at MambaIR's widths over several chunks, each direction; a
    narrow generic shape (D % 8 and N % 8 != 0: value-by-value staging);
    D 24, N 8 backward (bulk copies, the generic N); D 60 (value by value)
    and 200 with T not a multiple of 16 (chains wrap inside a stage), N 8
    and 16, each direction."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(d + n)
    args = _scan_bf16_inputs(rng, (2, t, r), d, n, dev, True)
    cuda.reset_launch_counts()
    got = selective_scan_chain(*args, reverse, torch.bfloat16)
    _bf16_close(got, selective_scan_chain_reference(*args, reverse,
                                                    torch.bfloat16),
                "selective_scan_chain.bf16")
    assert dict(cuda.launch_counts) == {"selective_scan_chain.bf16": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("t,r,d,n,reverse", [(29, 37, 360, 16, False),
                                             (29, 37, 360, 16, True),
                                             (9, 5, 20, 4, True)])
def test_scan_spatial_bf16_kernel(t, r, d, n, reverse):
    """#9 in bf16 (the spatial route's operands: u, dt, B, C bf16, y fp32)
    over [B, R, T, D], each direction, and a narrow generic shape."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(d + n + 1)
    args = _scan_bf16_inputs(rng, (2, r, t), d, n, dev, True)
    cuda.reset_launch_counts()
    got = selective_scan_spatial(*args, reverse=reverse)
    _scan_fp32_close(got, selective_scan_spatial_reference(
        *args, reverse=reverse), "selective_scan_spatial.bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("l,d,n", [(1000, 360, 16), (333, 20, 4)])
def test_scan_bidir_bf16_kernel(l, d, n):
    """#8 in bf16 (the bidir route's operands: u [2, B, L, D] bf16, dt, B
    and C fp32, y fp32): four directions from two u tensors, the last two
    backward; a ragged last chunk, and a narrow generic shape."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(l)
    u, *rest = _scan_bf16_inputs(rng, (4, 2, l), d, n, dev, False, (4,))
    args = (u[:2].contiguous(), *rest)
    cuda.reset_launch_counts()
    got = selective_scan_bidir(*args)
    _scan_fp32_close(got, selective_scan_bidir_reference(*args),
                     "selective_scan_bidir.bf16")


@pytest.mark.cuda
def test_scan_bf16_refuses_other_mixes():
    """A bf16 u takes the three routes' operand mixes only: fp32 dt with a
    bf16 y, and a bf16 y from an fp32 u, are refused, not cast."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(0)
    args = _scan_bf16_inputs(rng, (1, 8, 8), 16, 4, dev, False)
    with pytest.raises(ValueError, match="selective_scan_chain: a bfloat16 "
                                         "u takes"):
        selective_scan_chain(*args, False, torch.bfloat16)
    fp32 = (args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="needs a bfloat16 u"):
        selective_scan_spatial(*fp32, out_dtype=torch.bfloat16)


def _bf16_tree(tree):
    return {k: _bf16_tree(v) if isinstance(v, dict) else
            v.to(torch.bfloat16) for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("c,ch,prenorm", [(180, 720, True), (308, 308, True),
                                          (180, 360, False), (20, 76, False)])
def test_fused_mlp_bf16_kernel(c, ch, prenorm, fp32_plain):
    """DRCT-L's first and last FFN widths (pre-norm), GRL-B's (post-norm)
    and a narrow one, at 2257 rows: every operand bf16, as the bf16
    module hands them."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + ch)
    args = [a.to(torch.bfloat16) if torch.is_tensor(a) else a
            for a in _mlp_args(rng, c, ch, prenorm, (37, 61), dev)]
    cuda.reset_launch_counts()
    got = fused_mlp_block(*args)
    _bf16_close(got, fused_mlp_block_reference(*args), "fused_mlp_block.bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("cr,sq,with_ln", [(45, 18, False), (60, 30, True)])
@pytest.mark.parametrize("hw", [(37, 61), (5, 3)])
def test_cab_bf16_kernel(cr, sq, with_ln, hw, fp32_plain):
    """GRL's CAB (Cr 45: 90-byte rows, padded to 48 channels) and
    MambaIR's with the ln_2 LayerNorm and skip scale, batch 2, at a ragged
    size and one smaller than a 3 x 3 window's reach; every tensor of the
    tree bf16."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(cr + hw[0])
    w = _bf16_tree(_cab_tree(rng, 180, cr, sq, dev))
    x = _b(rng.normal(size=(2, *hw, 180)), dev)
    ln, skip = _cab_norms(rng, dev, with_ln)
    ln = None if ln is None else _bf16_tree(ln)
    skip = None if skip is None else skip.to(torch.bfloat16)
    cuda.reset_launch_counts()
    got = cab_fused(x, w, ln, skip)
    _bf16_close(got, cab_fused_reference(x, w, ln, skip), "cab_fused.bf16")


# the wgmma #14 and #15 at their path's shapes: the 336x512 bucket, the
# 100x140 one (ragged row blocks and 64-pixel segments), 5x7 and 1x20
# (one block, halos mostly outside), and batch 2
WGMMA_SHAPES = [(1, 336, 512), (1, 100, 140), (1, 5, 7), (1, 1, 20),
                (2, 100, 140)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,ch,prenorm", [(180, 720, True), (212, 848, True),
                                          (244, 976, True), (276, 276, True),
                                          (308, 308, True),
                                          (180, 360, False)])
@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_fused_mlp_bf16_wgmma(c, ch, prenorm, shape, fp32_plain):
    """DRCT-L's five FFN widths (pre-norm: every down instantiation on the
    path) and GRL-B's (post-norm, LN in the down launch's epilogue), with
    the weights as the models hand them (views of fc.weight.t())."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + ch + shape[1])
    fc1, fc2 = (_b(rng.normal(size=s) / np.sqrt(s[1]), dev)
                for s in ((ch, c), (c, ch)))
    x = _b(rng.normal(size=(*shape, c)), dev)
    b1, b2, lb = (_b(0.1 * rng.normal(size=n), dev) for n in (ch, c, c))
    ls = _b(1 + 0.1 * rng.normal(size=c), dev)
    args = (x, fc1.t(), b1, fc2.t(), b2, ls, lb, prenorm, 0.75)
    cuda.reset_launch_counts()
    got = fused_mlp_block(*args)
    _bf16_close(got, fused_mlp_block_reference(*args), "fused_mlp_block.bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("cr,sq,with_ln", [(45, 18, False), (60, 30, True)])
@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_cab_bf16_wgmma(cr, sq, with_ln, shape, fp32_plain):
    """GRL-B's CAB (conv1 on wgmma n48) and MambaIR's (ln_2 and the skip,
    n64), the conv kernels as the models hand them (HWIO views)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(cr + shape[1])
    w = _bf16_tree(_cab_tree(rng, 180, cr, sq, dev))
    for k in ("cab_0", "cab_2"):  # an NCHW parameter seen as HWIO
        w[k]["kernel"] = w[k]["kernel"].permute(3, 2, 0, 1).contiguous(
            ).permute(2, 3, 1, 0)
        assert not w[k]["kernel"].is_contiguous()
    x = _b(rng.normal(size=(*shape, 180)), dev)
    ln, skip = _cab_norms(rng, dev, with_ln)
    ln = None if ln is None else _bf16_tree(ln)
    skip = None if skip is None else skip.to(torch.bfloat16)
    cuda.reset_launch_counts()
    got = cab_fused(x, w, ln, skip)
    _bf16_close(got, cab_fused_reference(x, w, ln, skip), "cab_fused.bf16")


@pytest.mark.cuda
def test_ffn_cab_bf16_plans_match_the_kernels():
    """ops/wgmma.py:plan_ffn_bf16 and plan_cab_bf16 against the C entries
    (csrc/fused_mlp.cu, csrc/cab.cu): scratch, shared memory, tiles."""
    cuda_or_skip()
    lib = cuda.library()
    for m, c, ch in ((172032, 180, 720), (172032, 244, 976),
                     (14000, 308, 308), (35, 180, 360), (20, 20, 76)):
        p = wgmma.plan_ffn_bf16(m, c, ch)
        assert lib.ff_fused_mlp_bf16_scratch_bytes(m, c, ch) == \
            p.scratch_bytes
        assert lib.ff_fused_mlp_bf16_smem(c, ch, 0) == p.up_smem
        assert lib.ff_fused_mlp_bf16_smem(c, ch, 1) == p.down_smem
    for b, h, w, cr in ((1, 336, 512, 45), (1, 336, 512, 60),
                        (2, 100, 140, 60), (1, 5, 7, 45), (1, 1, 20, 60)):
        p = wgmma.plan_cab_bf16(h, w, 180, cr, b)
        assert lib.ff_cab_bf16_tiles(h, w) == p.tiles2
        assert lib.ff_cab_bf16_smem(180, cr, 0) == p.smem[0]
        assert lib.ff_cab_bf16_smem(180, cr, 1) == p.smem[1]
        assert lib.ff_cab_bf16_scratch_bytes(b * h * w, 180, cr) == \
            p.scratch_bytes
    assert lib.ff_fused_mlp_bf16_scratch_bytes(64, 322, 900) == -1
    assert lib.ff_cab_bf16_scratch_bytes(64, 180, 65) == -1


def _kernel_names(fn, reps=5):
    """The distinct device kernels `reps` calls of fn launch
    (torch.profiler, which may miss a launch at its window's edge, and
    whose first window in a process may come back empty: up to three
    windows are taken)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = set()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            if us > 0:
                # csrc/'s kernels: at most once a call
                assert e.count <= reps or "anonymous namespace" not in \
                    e.key, (e.key, e.count)
                names.add(e.key)
        if names:
            return names
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("prenorm", [True, False])
def test_fused_mlp_bf16_launches_two_kernels(prenorm):
    """Once the layouts exist, a bf16 #14 call under torch.inference_mode
    launches the up and the down wgmma kernels, once each, and nothing
    else: no weight pad, no rows pass, no library call."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(5)
    fc1 = torch.nn.Linear(180, 360).to(dev, torch.bfloat16)
    fc2 = torch.nn.Linear(360, 180).to(dev, torch.bfloat16)
    x = _b(rng.normal(size=(1, 40, 56, 180)), dev)
    ln = torch.nn.LayerNorm(180).to(dev, torch.bfloat16)
    with torch.inference_mode():
        names = _kernel_names(lambda: fused_mlp_block(
            x, fc1.weight.t(), fc1.bias, fc2.weight.t(), fc2.bias, ln.weight,
            ln.bias, prenorm))
    assert len(names) == 2, names
    assert sum("ffn_up_wgmma_kernel" in k for k in names) == 1, names
    assert sum("ffn_down_wgmma_kernel" in k for k in names) == 1, names


@pytest.mark.cuda
def test_cab_bf16_launches_its_kernels():
    """Once the layouts exist, a bf16 #15 call launches conv1, conv2 and
    the apply pass of csrc/cab.cu, once each (the squeeze MLP's few
    PyTorch ops beside them), no weight pad or rows pass."""
    from freqfusion_tpu_torch.models.grl import CAB

    dev = cuda_or_skip()
    m = CAB(180, 4, 18).to(dev, torch.bfloat16)
    x = _b(np.random.default_rng(6).normal(size=(1, 24, 80, 180)), dev)
    with torch.inference_mode():
        names = _kernel_names(lambda: cab_fused(x, m.fused_weights()))
    ours = sorted(re.search(r"cab_\w+_kernel", k).group(0) for k in names
                  if re.search(r"cab_\w+_kernel", k))
    assert ours == ["cab_apply_bf16_kernel", "cab_conv1_kernel",
                    "cab_conv2_kernel"], names
    assert not any("bg_" in k for k in names), names


@pytest.mark.cuda
def test_ffn_cab_bf16_relay_changed_weights():
    """The cached layouts (ops/wgmma.py) under torch.inference_mode: built
    once per module across calls; an in-place update is seen; a write
    through .data is seen after clear_weight_layouts."""
    from freqfusion_tpu_torch.models.grl import CAB

    dev = cuda_or_skip()
    rng = np.random.default_rng(7)
    fc1 = torch.nn.Linear(180, 360).to(dev, torch.bfloat16)
    fc2 = torch.nn.Linear(360, 180).to(dev, torch.bfloat16)
    ln = torch.nn.LayerNorm(180).to(dev, torch.bfloat16)
    cab = CAB(180, 3, 30).to(dev, torch.bfloat16)
    x = _b(rng.normal(size=(1, 20, 36, 180)), dev)

    def ffn():
        return fused_mlp_block(x, fc1.weight.t(), fc1.bias, fc2.weight.t(),
                               fc2.bias, ln.weight, ln.bias, True)

    def check(fn, ref, name):
        cuda.reset_launch_counts()
        with torch.inference_mode():
            got = fn()
        _bf16_close(got, ref(), name)

    def ffn_ref():
        return fused_mlp_block_reference(
            x, fc1.weight.t(), fc1.bias, fc2.weight.t(), fc2.bias,
            ln.weight, ln.bias, True)

    def cab_run():
        return cab_fused(x, cab.fused_weights(), skip_scale=ln.weight)

    def cab_ref():
        return cab_fused_reference(x, cab.fused_weights(),
                                   skip_scale=ln.weight)
    with torch.inference_mode():
        ffn(), cab_run()
        w1 = wgmma.weight_layouts(fc1.weight.t(), 128)
        k1 = wgmma.conv_layouts(cab.cab[0].weight.permute(2, 3, 1, 0), 64)
        ffn(), cab_run()
        assert wgmma.weight_layouts(fc1.weight.t(), 128) is w1
        assert wgmma.conv_layouts(cab.cab[0].weight.permute(2, 3, 1, 0),
                                  64) is k1
    with torch.no_grad():
        fc2.weight.mul_(-1.5)
        cab.cab[2].weight.mul_(-1.5)
    check(ffn, ffn_ref, "fused_mlp_block.bf16")
    check(cab_run, cab_ref, "cab_fused.bf16")
    fc1.weight.data.copy_(_b(rng.normal(size=(360, 180)) / 13, dev))
    cab.cab[0].weight.data.copy_(_b(rng.normal(size=(60, 180, 3, 3)) / 40,
                                    dev))
    wgmma.clear_weight_layouts()
    check(ffn, ffn_ref, "fused_mlp_block.bf16")
    check(cab_run, cab_ref, "cab_fused.bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 256, 1024, 36, 128, 512])
def test_nafblock_bf16_kernel(c, fp32_plain):
    """Every NAFNet-SIDD-64 width (64-1024: pass B in one launch up to C
    256, three above; pass A's halo tile 8 x 16 up to C 256, 8 x 8 above)
    and C 36 (K padded to 64, conv4's interleaved columns to 128) on two
    ragged 17 x 23 images (odd sides: the last tiles' halos cross the
    image's edge; 782 pixels an image, no multiple of a tile or of 64
    rows); every tensor of the tree bf16."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c)
    w = _bf16_tree(_naf_tree(rng, c, dev))
    x = _b(rng.uniform(size=(2, 17, 23, c)), dev)
    cuda.reset_launch_counts()
    got = nafblock_fused(x, w)
    assert dict(cuda.launch_counts) == {"nafblock_fused.bf16": 1}
    _bf16_close(got, nafblock_fused_reference(x, w), "nafblock_fused.bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("c,hw", [(64, (9, 31)), (512, (7, 13))])
def test_nafblock_bf16_relays_changed_weights(c, hw):
    """The cached wgmma layouts (ops/wgmma.py): reused while the weights
    stay; an in-place update (version counter) lays conv3's out anew; a
    write through .data is seen after clear_weight_layouts."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + 1)
    w = _bf16_tree(_naf_tree(rng, c, dev))
    x = _b(rng.uniform(size=(1, *hw, c)), dev)
    nafblock_fused(x, w)
    w1 = wgmma.weight_layouts(w["conv1"]["kernel"][0, 0], 128, True)
    nafblock_fused(x, w)
    assert wgmma.weight_layouts(w["conv1"]["kernel"][0, 0], 128,
                                True) is w1
    w["conv3"]["kernel"].mul_(-1.5)
    cuda.reset_launch_counts()
    _bf16_close(nafblock_fused(x, w), nafblock_fused_reference(x, w),
                "nafblock_fused.bf16")
    w["conv5"]["kernel"].data.copy_(_b(rng.normal(
        size=(1, 1, c, c)) / np.sqrt(c), dev))
    wgmma.clear_weight_layouts()
    cuda.reset_launch_counts()
    _bf16_close(nafblock_fused(x, w), nafblock_fused_reference(x, w),
                "nafblock_fused.bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [360, 6])
@pytest.mark.parametrize("hw", [(13, 18), (1, 2)])
def test_dwconv_bf16_kernel(c, hw, fp32_plain):
    """SS2D's D 360 (four channels a thread) and C 6 (one), at a ragged
    size and a 1 x 2 image: bf16 x, taps and bias."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c)
    x = _b(rng.normal(size=(2, *hw, c)), dev)
    k = _b(rng.normal(size=(3, 3, 1, c)), dev)
    b = _b(rng.normal(size=c), dev)
    cuda.reset_launch_counts()
    got = dwconv3x3(x, k, b)
    _bf16_close(got, dwconv3x3_reference(x, k, b), "dwconv3x3.bf16")


def _tree_bf16(p):
    return {k: _tree_bf16(v) if isinstance(v, dict) else v.to(torch.bfloat16)
            for k, v in p.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("hw", BORDER_SHAPES)
def test_lka_bf16_kernel(c, hw):
    """The LKABlock's bf16 version (bf16 x and parameters, as fusion_dtype
    casts them) against its bf16 plain version, batch 2."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + hw[0] + 3)
    p = _tree_bf16(_lka_tree(rng, c, dev))
    x = _image(rng, 2, hw, c, False, dev).to(torch.bfloat16)
    cuda.reset_launch_counts()
    got = lka_block_fused(x, p)
    _bf16_close(got, lka_block_fused_reference(x, p), "lka_block_fused.bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("nchw", [False, True])
@pytest.mark.parametrize("hw", BORDER_SHAPES)
def test_hier_bf16_kernel(nchw, hw):
    """Stage 3 + to_rgb in bf16, batch 2, s3_in NHWC and as an NCHW view."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(hw[0] + nchw + 5)
    p = _tree_bf16(_hier_tree(rng, dev))
    x = _image(rng, 2, hw, 76, nchw, dev, uniform=True).to(torch.bfloat16)
    cuda.reset_launch_counts()
    got = hier_stage3_fused(x, p)
    assert (got.permute(0, 3, 1, 2) if nchw else got).is_contiguous()
    _bf16_close(got, hier_stage3_fused_reference(x, p),
                "hier_stage3_fused.bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("nchw", [False, True])
@pytest.mark.parametrize("hw", BORDER_SHAPES)
def test_edge_bf16_kernels(nchw, hw):
    """The edge refine and fuse in bf16, batch 2, NHWC and NCHW views."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(hw[0] + nchw + 13)
    p = _tree_bf16(_edge_refine_tree(rng, dev))
    lap = _image(rng, 2, hw, 3, nchw, dev).to(torch.bfloat16)
    cuda.reset_launch_counts()
    _bf16_close(edge_refine_fused(lap, p), edge_refine_fused_reference(lap, p),
                "edge_refine_fused.bf16")
    q = _tree_bf16(_tree(rng, {"fusion_0": _conv(3, 96, 32),
                               "fusion_2": _conv(3, 32, 3),
                               "edge_gate_0": _conv(3, 6, 16),
                               "edge_gate_2": _conv(3, 16, 1)}, dev))
    bf = torch.bfloat16
    sr = _image(rng, 2, hw, 3, nchw, dev, uniform=True).to(bf)
    feats = [_image(rng, 2, hw, 32, nchw, dev).to(bf) for _ in range(3)]
    lw = torch.softmax(_t(rng.normal(size=3), dev), 0).to(bf)
    strength = _t(rng.uniform(0.5, 2), dev).to(bf)
    _bf16_close(edge_fuse_fused(sr, *feats, lw, strength, q),
                edge_fuse_fused_reference(sr, *feats, lw, strength, q),
                "edge_fuse_fused.bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,ws", [(180, 6, 16), (244, 2, 16),
                                        (60, 6, 8), (212, 4, 16),
                                        (276, 6, 16), (308, 4, 16)])
@pytest.mark.parametrize("shift", [False, True])
def test_window_attention_qkv_bf16_kernel(c, heads, ws, shift):
    """Every DRCT-L width (C 180-308: rows of 360-616 bytes, 8- but not
    16-byte multiples; chunks of 96 or 128 columns), its widest head (hd
    122) and a small one (hd 10) at window 8, 1 x 2 x 3 windows (the
    GEMM's 64-row blocks end ragged at window 8): bf16 x, weights, biases
    and bias table, fp32 mask, as the bf16 module hands them."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + ws + shift)
    h, w, n = 2 * ws, 3 * ws, ws * ws
    mask = shifted_window_mask(h, w, ws, ws // 2 if shift else 0)
    args = (_b(rng.normal(size=(1, h, w, c)), dev),
            _b(rng.normal(size=(c, 3 * c)) / np.sqrt(c), dev),
            _b(0.1 * rng.normal(size=3 * c), dev),
            _b(rng.normal(size=(c, c)) / np.sqrt(c), dev),
            _b(0.1 * rng.normal(size=c), dev),
            _b(0.5 * rng.normal(size=(heads, n, n)), dev),
            None if mask is None else _t(mask, dev), heads, ws)
    cuda.reset_launch_counts()
    got = window_attention_qkv_nhwc(*args)
    assert dict(cuda.launch_counts) == {"window_attention_qkv_nhwc.bf16": 1}
    _bf16_close(got, window_attention_qkv_nhwc_reference(*args),
                "window_attention_qkv_nhwc.bf16")


@pytest.mark.cuda
def test_bf16_modules_reuse_layouts_under_inference_mode(monkeypatch):
    """The gated NAFBlock and DRCT WindowAttention in bf16, served as
    io.main serves them (torch.inference_mode): their weights are laid
    out on the first call only (four for the NAFBlock, two for the
    attention), then found; laid out anew after clear_weight_layouts, the
    outputs are the same bits."""
    from freqfusion_tpu_torch.models.drct import WindowAttention
    from freqfusion_tpu_torch.models.nafnet import NAFBlock

    dev = cuda_or_skip()
    torch.manual_seed(0)
    bf = torch.bfloat16
    blk = NAFBlock(64).to(dev).to(bf)
    for p in blk.parameters():
        torch.nn.init.normal_(p, std=0.05)
    att = WindowAttention(180, 16, 6).to(dev).to(bf)
    x = torch.randn(1, 64, 17, 23, device=dev).to(bf)
    xa = torch.randn(1, 32, 48, 180, device=dev).to(bf)
    mask = _t(shifted_window_mask(32, 48, 16, 8), dev)
    monkeypatch.setenv("FREQFUSION_NAFBLOCK", "1")
    monkeypatch.setenv("FREQFUSION_ATTN_QKV", "1")
    wgmma.clear_weight_layouts()

    def entries():
        return sum(len(t) for t in wgmma._LAYOUTS.values())
    with torch.inference_mode():
        blk(x), att(xa, mask)
        assert entries() == 6
        cuda.reset_launch_counts()
        got = [blk(x), att(xa, mask)]
        assert entries() == 6
        assert dict(cuda.launch_counts) == {
            "nafblock_fused.bf16": 1, "window_attention_qkv_nhwc.bf16": 1}
        wgmma.clear_weight_layouts()
        want = [blk(x), att(xa, mask)]
        assert entries() == 6
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_window_attention_qkv_bf16_batch_and_changed_weights():
    """Batch 2 at C 212; the cached layouts reused, laid out anew after an
    in-place update of wqkv and, after clear_weight_layouts, after a write
    to wproj through .data."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(212)
    c, heads, ws = 212, 4, 16
    mask = _t(shifted_window_mask(ws, 2 * ws, ws, ws // 2), dev)
    x = _b(rng.normal(size=(2, ws, 2 * ws, c)), dev)
    wqkv = _b(rng.normal(size=(c, 3 * c)) / np.sqrt(c), dev)
    wproj = _b(rng.normal(size=(c, c)) / np.sqrt(c), dev)
    args = (x, wqkv, _b(0.1 * rng.normal(size=3 * c), dev), wproj,
            _b(0.1 * rng.normal(size=c), dev),
            _b(0.5 * rng.normal(size=(heads, ws * ws, ws * ws)), dev), mask,
            heads, ws)

    def check():
        cuda.reset_launch_counts()
        _bf16_close(window_attention_qkv_nhwc(*args),
                    window_attention_qkv_nhwc_reference(*args),
                    "window_attention_qkv_nhwc.bf16")
    check()
    wq = wgmma.weight_layouts(wqkv, wgmma.chunk_cols(3 * c))
    check()
    assert wgmma.weight_layouts(wqkv, wgmma.chunk_cols(3 * c)) is wq
    wqkv.mul_(-1)
    check()
    wproj.data.copy_(_b(rng.normal(size=(c, c)) / np.sqrt(c), dev))
    wgmma.clear_weight_layouts()
    check()


@pytest.mark.cuda
@pytest.mark.parametrize("c2,heads,shift", [(90, 3, False), (90, 3, True),
                                            (24, 3, True)])
def test_grl_mixed_attention_qkv_bf16_kernel(c2, heads, shift):
    """GRL-B's geometry (C 180, 3 + 3 heads of 30, window 8, 4 x 4
    anchors), shifted with x_rolled and the mask and not, and C 48: bf16
    x, x_rolled, anchor, wqkv and bqkv, fp32 scales, biases and mask, as
    the bf16 module hands them."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c2 + shift)
    args = list(_grl_qkv_args(rng, dev, 2, c2, heads, heads, shift))
    args[:5] = [None if a is None else a.to(torch.bfloat16)
                for a in args[:5]]
    cuda.reset_launch_counts()
    got = grl_mixed_attention_qkv_nhwc(*args)
    assert dict(cuda.launch_counts) == {
        "grl_mixed_attention_qkv_nhwc.bf16": 1}
    _bf16_close(got, grl_mixed_attention_qkv_nhwc_reference(*args),
                "grl_mixed_attention_qkv_nhwc.bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,nh", [(9, 64, 4), (4, 128, 8)])
@pytest.mark.parametrize("p", [14000, 5])
def test_token_attention_bf16_kernel(t, e, nh, p):
    """Both fusion-net geometries at P = 100 x 140 and P = 5, the weights
    as the gated module hands them (transposed views of torch-layout
    tensors): every operand bf16."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(t + p + 1)
    args = _token_args(rng, p, t, e, nh, dev, True)
    # the weights as the cast module's views: its [out, in] tensors cast,
    # then transposed (strides (1, E))
    args[:5] = [a.t().contiguous().to(torch.bfloat16).t() if i % 2 else
                a.to(torch.bfloat16) for i, a in enumerate(args[:5])]
    assert args[1].stride() == (1, e) and args[3].stride() == (1, e)
    cuda.reset_launch_counts()
    got = token_attention(*args)
    assert dict(cuda.launch_counts) == {"token_attention.bf16": 1}
    _bf16_close(got, token_attention_reference(*args), "token_attention.bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["window_attention",
                                    "selective_scan_flat"])
def test_fp32_only_kernels_refuse_bf16(kernel):
    """A kernel with no bf16 version raises on a bf16 tensor, naming
    itself; nothing is cast around it."""
    dev = cuda_or_skip()
    x = torch.zeros(1, 8, 8, 16, device=dev, dtype=torch.bfloat16)
    calls = {
        "window_attention": lambda: window_attention(
            x.view(1, 64, 16), x.view(1, 64, 16), x.view(1, 64, 16),
            torch.zeros(1, 64, 64, device=dev), None, 1),
        "selective_scan_flat": lambda: selective_scan_flat(
            x.view(1, 64, 16), x.view(1, 64, 16),
            torch.zeros(16, 4, device=dev), x.view(1, 64, 16)[..., :4],
            x.view(1, 64, 16)[..., :4], torch.zeros(16, device=dev),
            torch.zeros(16, device=dev)),
    }
    with pytest.raises(ValueError, match=f"{kernel}: .*bf16 version is not "
                                         "ported"):
        calls[kernel]()


def _bf16_rerun_equal(fn):
    """Two runs of a bf16 kernel give the same bits (no atomics)."""
    first, again = fn(), fn()
    torch.cuda.synchronize()
    for a, b in zip(first if isinstance(first, tuple) else (first,),
                    again if isinstance(again, tuple) else (again,)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", [(180, 6), (212, 4), (244, 2), (276, 6),
                                     (308, 4)])
@pytest.mark.parametrize("shift", [0, 8])
def test_window_attention_bf16_drct_widths(c, heads, shift):
    """The one-pass wgmma #1 at DRCT-L's five widths (head dims 30, 53,
    122, 46, 77: slices at 2- and 4-byte offsets, head boxes 32-128, one
    and two warpgroups a block) on the 336x512 bucket, shifted and not,
    against its plain version; reruns bit-equal."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + shift)
    h, w = 336, 512
    q, k, v = (_b(rng.normal(size=(1, h, w, c)), dev) for _ in range(3))
    bias = _b(0.5 * rng.normal(size=(heads, 256, 256)), dev)
    mask = shifted_window_mask(h, w, 16, shift)
    args = (q, k, v, bias, None if mask is None else _t(mask, dev), heads, 16)
    cuda.reset_launch_counts()
    got = window_attention_nhwc(*args)
    _bf16_close(got, window_attention_nhwc_reference(*args),
                "window_attention_nhwc.bf16")
    _bf16_rerun_equal(lambda: window_attention_nhwc(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,ws", [(20, 2, 4), (60, 2, 8), (92, 2, 8),
                                        (106, 2, 16), (154, 2, 12),
                                        (180, 2, 8), (212, 2, 4),
                                        (244, 2, 16)])
@pytest.mark.parametrize("shift", [False, True])
def test_window_attention_bf16_head_boxes(c, heads, ws, shift):
    """#1 bf16 at batch 2 and every head box from 16 to 128 (head dims 10,
    30, 46, 53, 77, 90, 106, 122; N 16, 64, 144, 256: one or two 128-key
    halves, partial query tiles), shifted and not."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c + ws + shift)
    h, w, n = 2 * ws, 3 * ws, ws * ws
    q, k, v = (_b(rng.normal(size=(2, h, w, c)), dev) for _ in range(3))
    bias = _b(0.5 * rng.normal(size=(heads, n, n)), dev)
    mask = shifted_window_mask(h, w, ws, ws // 2) if shift else None
    args = (q, k, v, bias, None if mask is None else _t(mask, dev), heads, ws)
    cuda.reset_launch_counts()
    _bf16_close(window_attention_nhwc(*args),
                window_attention_nhwc_reference(*args),
                "window_attention_nhwc.bf16")
    _bf16_rerun_equal(lambda: window_attention_nhwc(*args))


@pytest.mark.cuda
def test_window_attention_bf16_plan_matches_the_kernel():
    """ops/attention.py:plan_window_attention_bf16's shared memory is the
    kernel's (ff_window_attention_bf16_smem) at every head box and N, and
    the blocks an SM it assumes are the runtime's occupancy of the
    kernel (ff_window_attention_bf16_occupancy: its registers and shared
    memory)."""
    from freqfusion_tpu_torch.ops.attention import plan_window_attention_bf16

    cuda_or_skip()
    lib = cuda.library()
    for n in (16, 64, 144, 256):
        for hd in (10, 30, 46, 53, 77, 90, 106, 122, 128):
            plan = plan_window_attention_bf16(n, hd)
            assert lib.ff_window_attention_bf16_smem(n, hd) == plan.smem
            assert (lib.ff_window_attention_bf16_occupancy(n, hd)
                    == plan.blocks_per_sm), (n, hd)
    assert lib.ff_window_attention_bf16_smem(256, 129) == -1


def _odd_mask(rng, nw, n, dev):
    """A mask of values that bf16 does not hold exactly (up to 40 in
    magnitude: a rounding of up to 0.125 in a logit)."""
    m = rng.uniform(-40, 40, (nw, n, n)).astype(np.float32)
    assert (torch.from_numpy(m).to(torch.bfloat16).float().numpy() != m).any()
    return _t(m, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["#1", "#11", "#2", "#12"])
def test_bf16_attention_rounds_the_mask(kernel):
    """The four bf16 attention kernels take the mask as the JAX wrappers
    cast it, rounded to bf16 (pallas_attention.py:279, :773, :612, :882),
    as their plain versions do: with a mask that bf16 does not hold
    exactly, each matches its plain version (a kernel that adds the fp32
    mask unrounded misses)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(23)
    bf = torch.bfloat16
    if kernel in ("#1", "#11"):
        c, heads, ws = 60, 3, 8
        h, w, n = 16, 24, 64
        mask = _odd_mask(rng, (h // ws) * (w // ws), n, dev)
        bias = _b(0.5 * rng.normal(size=(heads, n, n)), dev)
        if kernel == "#1":
            q, k, v = (_b(rng.normal(size=(1, h, w, c)), dev)
                       for _ in range(3))
            args = (q, k, v, bias, mask, heads, ws)
            fn, ref = window_attention_nhwc, window_attention_nhwc_reference
            name = "window_attention_nhwc.bf16"
        else:
            args = (_b(rng.normal(size=(1, h, w, c)), dev),
                    _b(rng.normal(size=(c, 3 * c)) / np.sqrt(c), dev),
                    _b(0.1 * rng.normal(size=3 * c), dev),
                    _b(rng.normal(size=(c, c)) / np.sqrt(c), dev),
                    _b(0.1 * rng.normal(size=c), dev), bias, mask, heads, ws)
            fn = window_attention_qkv_nhwc
            ref = window_attention_qkv_nhwc_reference
            name = "window_attention_qkv_nhwc.bf16"
    elif kernel == "#2":
        args = list(_grl_args(rng, dev, 1, 24, 3, 3, True))
        args[:7] = [a.to(bf) for a in args[:7]]
        args[13] = _odd_mask(rng, 6, 64, dev)
        fn, ref = grl_mixed_attention_nhwc, grl_mixed_attention_nhwc_reference
        name = "grl_mixed_attention_nhwc.bf16"
    else:
        args = list(_grl_qkv_args(rng, dev, 1, 24, 3, 3, True))
        args[:5] = [a.to(bf) for a in args[:5]]
        args[11] = _odd_mask(rng, 6, 64, dev)
        fn = grl_mixed_attention_qkv_nhwc
        ref = grl_mixed_attention_qkv_nhwc_reference
        name = "grl_mixed_attention_qkv_nhwc.bf16"
    cuda.reset_launch_counts()
    _bf16_close(fn(*args), ref(*args), name)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,shift", [(180, 6, 8), (308, 4, 0)])
def test_window_attention_qkv_bf16_phase2_shapes(c, heads, shift):
    """#11 bf16 (its attention stage the one-pass #1) at phase 2's shapes:
    336x512, C 180 shifted, C 308 not."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c)
    h, w = 336, 512
    mask = shifted_window_mask(h, w, 16, shift)
    args = (_b(rng.normal(size=(1, h, w, c)), dev),
            _b(rng.normal(size=(c, 3 * c)) / np.sqrt(c), dev),
            _b(0.1 * rng.normal(size=3 * c), dev),
            _b(rng.normal(size=(c, c)) / np.sqrt(c), dev),
            _b(0.1 * rng.normal(size=c), dev),
            _b(0.5 * rng.normal(size=(heads, 256, 256)), dev),
            None if mask is None else _t(mask, dev), heads, 16)
    cuda.reset_launch_counts()
    _bf16_close(window_attention_qkv_nhwc(*args),
                window_attention_qkv_nhwc_reference(*args),
                "window_attention_qkv_nhwc.bf16")
    _bf16_rerun_equal(lambda: window_attention_qkv_nhwc(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shift,h,w", [(False, 336, 512), (True, 336, 512),
                                       (True, 8, 8), (False, 8, 40)])
def test_grl_mixed_attention_qkv_bf16_wgmma(shift, h, w):
    """#12 bf16 (the wgmma projection, each output by bulk stores, and #2's
    body) at GRL-B's phase-2 shapes (C 180, 3 + 3 heads of 30, 336x512)
    and at one and five 64-row blocks (M is a multiple of 64 at window 8);
    reruns bit-equal."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(h + w + shift)
    bf = torch.bfloat16
    x = _b(rng.normal(size=(1, h, w, 180)), dev)
    anchor = _b(rng.normal(size=(1, h // 2, w // 2, 90)), dev)
    scales = [_t(rng.uniform(10, 11, (3, 1, 1)), dev) for _ in range(3)]
    biases = [_t(rng.uniform(0, 16, s), dev)
              for s in ((3, 64, 64), (3, 16, 64), (3, 64, 16))]
    mask = shifted_window_mask(h, w, 8, 4) if shift else None
    args = (x, torch.roll(x, (-4, -4), (1, 2)).contiguous() if shift
            else None, anchor,
            _b(rng.normal(size=(180, 540)) / np.sqrt(180), dev),
            _b(0.1 * rng.normal(size=540), dev), *scales, *biases,
            None if mask is None else _t(mask, dev), 3, 3, 8)
    assert args[0].dtype == bf
    cuda.reset_launch_counts()
    _bf16_close(grl_mixed_attention_qkv_nhwc(*args),
                grl_mixed_attention_qkv_nhwc_reference(*args),
                "grl_mixed_attention_qkv_nhwc.bf16")
    _bf16_rerun_equal(lambda: grl_mixed_attention_qkv_nhwc(*args))


@pytest.mark.cuda
def test_grl_qkv_bf16_lays_its_weight_out_once(monkeypatch):
    """GRL's bf16 MixedAttention with FREQFUSION_GRL_QKV served as io.main
    serves it (torch.inference_mode): wqkv laid out on the first call only
    (the module hands the view wqkv.t()), found on the next; an in-place
    update is seen, and so is a write through .data after
    clear_weight_layouts; each call against the gate-off module."""
    from freqfusion_tpu_torch.models.grl import MixedAttention

    dev = cuda_or_skip()
    torch.manual_seed(0)
    bf = torch.bfloat16
    att = MixedAttention(180, 3, 3, 8, True, (8, 8), 2).to(dev).to(bf)
    x = torch.randn(1, 16, 24, 180, device=dev).to(bf)
    weight = att.qkv.body.weight
    wgmma.clear_weight_layouts()

    def entries():
        return sum(len(t) for t in wgmma._LAYOUTS.values())

    def check():
        monkeypatch.setenv("FREQFUSION_GRL_QKV", "1")
        cuda.reset_launch_counts()
        got = att(x)
        assert cuda.launch_counts["grl_mixed_attention_qkv_nhwc.bf16"] == 1
        monkeypatch.setenv("FREQFUSION_GRL_QKV", "0")
        want = att(x)
        torch.cuda.synchronize()
        top = want.float().abs().max().item()
        tol = 4 * BF16_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)
        assert (got.float() - want.float()).abs().max().item() <= tol
        return got
    with torch.inference_mode():
        first = check()
        assert entries() == 1
        assert torch.equal(check(), first)
        assert entries() == 1
    with torch.no_grad():
        weight.mul_(-1)
    with torch.inference_mode():
        assert not torch.equal(check(), first)
    weight.data.copy_(torch.randn(540, 180, device=dev).to(bf) / 14)
    wgmma.clear_weight_layouts()
    with torch.inference_mode():
        check()
        assert entries() == 1


def _grl_bf16_args(rng, dev, b, c2, heads_w, heads_s, shift, h, w):
    """A bf16 #2 call: bf16 halves and anchor, fp32 scales, biases and mask
    (as the bf16 module hands them)."""
    args = list(_grl_args(rng, dev, b, c2, heads_w, heads_s, shift,
                          h=h, w=w))
    args[:7] = [a.to(torch.bfloat16) for a in args[:7]]
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("c2,heads_w,heads_s", [
    (90, 3, 3), (42, 6, 6), (42, 2, 3), (90, 2, 3), (120, 2, 2),
    (180, 3, 3), (180, 2, 6), (45, 3, 3), (45, 1, 5)])
@pytest.mark.parametrize("shift", [False, True])
def test_grl_mixed_attention_bf16_persistent(c2, heads_w, heads_s, shift):
    """#2 bf16's persistent blocks at batch 2 over 2 x 8 x 25 = 400 tiles
    (no multiple of either half's 66 blocks: the rings wrap unevenly):
    GRL-B's halves (C/2 90, 3 + 3 heads of 30), head boxes 16 (hd 7), 32,
    48 and 64 (8 warps) and 96 (hd 90), more units than warps (6 heads:
    their terms read a tile), odd C/2 45 (2-byte fragment loads; anchor
    rows 8 bytes off 16, assembled by warp 0's lanes); shifted with the
    mask and not. One launch a call, reruns bit-equal."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(c2 + 7 * heads_w + heads_s + shift)
    args = _grl_bf16_args(rng, dev, 2, c2, heads_w, heads_s, shift, 64, 200)
    cuda.reset_launch_counts()
    got = grl_mixed_attention_nhwc(*args)
    assert dict(cuda.launch_counts) == {"grl_mixed_attention_nhwc.bf16": 1}
    _bf16_close(got, grl_mixed_attention_nhwc_reference(*args),
                "grl_mixed_attention_nhwc.bf16")
    _bf16_rerun_equal(lambda: grl_mixed_attention_nhwc(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True])
def test_grl_mixed_attention_bf16_phase2_shapes(shift):
    """#2 bf16 at GRL-B's phase-2 shapes (336x512, 2,688 tiles a half);
    reruns bit-equal."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(41 + shift)
    args = _grl_bf16_args(rng, dev, 1, 90, 3, 3, shift, 336, 512)
    cuda.reset_launch_counts()
    _bf16_close(grl_mixed_attention_nhwc(*args),
                grl_mixed_attention_nhwc_reference(*args),
                "grl_mixed_attention_nhwc.bf16")
    _bf16_rerun_equal(lambda: grl_mixed_attention_nhwc(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("c2,heads_w,heads_s,masked", [
    (90, 3, 3, True), (90, 3, 3, False), (42, 6, 6, True), (45, 1, 5, False),
    (180, 2, 6, True), (120, 2, 2, False), (254, 2, 3, True),
    (400, 5, 5, False)])
def test_grl_attention_bf16_plan_matches_the_kernel(c2, heads_w, heads_s,
                                                    masked):
    """ops/attention.py:plan_grl_attention_bf16 computes #2 bf16's head
    box, warps, ring depth, stage and shared memory as
    ff_grl_attention_bf16_plan does, and refuses what it refuses (a head
    dim past 96; C/2 where two stages do not fit)."""
    cuda_or_skip()
    lib = cuda.library()
    out = (ctypes.c_int * 5)()
    rc = lib.ff_grl_attention_bf16_plan(c2, heads_w, heads_s, int(masked),
                                        out)
    try:
        plan = plan_grl_attention_bf16(1, 8, 8, c2, heads_w, heads_s, masked)
    except ValueError:
        assert rc == -1
        return
    assert rc == 0
    assert list(out) == [plan.hdp, plan.warps, plan.stages,
                         plan.stage_bytes, plan.smem]


@pytest.mark.cuda
def test_grl_mixed_attention_qkv_bf16_persistent():
    """#12 bf16 over #2 bf16's persistent body at batch 2, shifted, on
    400 tiles a half; reruns bit-equal."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(43)
    args = list(_grl_qkv_args(rng, dev, 2, 90, 3, 3, True))
    h, w = 64, 200
    x = _b(rng.normal(size=(2, h, w, 180)), dev)
    args = (x, torch.roll(x, (-4, -4), (1, 2)).contiguous(),
            _b(rng.normal(size=(2, h // 2, w // 2, 90)), dev),
            _b(rng.normal(size=(180, 540)) / np.sqrt(180), dev),
            _b(0.1 * rng.normal(size=540), dev), *args[5:11],
            _t(shifted_window_mask(h, w, 8, 4), dev), *args[12:])
    cuda.reset_launch_counts()
    _bf16_close(grl_mixed_attention_qkv_nhwc(*args),
                grl_mixed_attention_qkv_nhwc_reference(*args),
                "grl_mixed_attention_qkv_nhwc.bf16")
    _bf16_rerun_equal(lambda: grl_mixed_attention_qkv_nhwc(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("nchw", [False, True])
@pytest.mark.parametrize("b,hw", [(2, (70, 330)), (1, (9, 200)),
                                  (2, (64, 128))])
def test_hier_bf16_kernel_persistent(nchw, b, hw):
    """Stage 3 + to_rgb in bf16 at widths that are no multiple of 64 (330,
    200) and one that is (128), heights no multiple of 4 or 8 (70, 9):
    more tiles than blocks (the persistent loops and the halo ring wrap);
    s3_in NHWC and as an NCHW view; reruns bit-equal."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(hw[1] + nchw)
    p = _tree_bf16(_hier_tree(rng, dev))
    x = _image(rng, b, hw, 76, nchw, dev, uniform=True).to(torch.bfloat16)
    cuda.reset_launch_counts()
    got = hier_stage3_fused(x, p)
    assert (got.permute(0, 3, 1, 2) if nchw else got).is_contiguous()
    _bf16_close(got, hier_stage3_fused_reference(x, p),
                "hier_stage3_fused.bf16")
    _bf16_rerun_equal(lambda: hier_stage3_fused(x, p))


@pytest.mark.cuda
def test_hier_fp32_takes_the_module_views(fp32_plain):
    """The fp32 stage 3 handed the module's stage3_params (the six 3x3
    kernels as views of the parameters, which the fp32 route copies
    contiguous for its kernels and must hold until they are queued)
    matches its plain version."""
    from freqfusion_tpu_torch.models.fusion.hierarchical import (
        HierarchicalMultiResolutionFusion)

    dev = cuda_or_skip()
    torch.manual_seed(0)
    hm = HierarchicalMultiResolutionFusion(4, 64).to(dev).eval()
    s3 = torch.rand(1, 76, 40, 136, device=dev).permute(0, 2, 3, 1)
    with torch.inference_mode():
        tree = hm.stage3_params()
        cuda.reset_launch_counts()
        got = hier_stage3_fused(s3, tree)
        want = hier_stage3_fused_reference(s3, tree)
    torch.cuda.synchronize()
    assert cuda.launch_counts["hier_stage3_fused"] == 1
    tol = FUSED_REL_TOL * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_hier_bf16_lays_its_weights_out_once():
    """The bf16 hierarchical fusion's stage 3 as the pipeline runs it
    (torch.inference_mode, the module's stage3_params handing views of
    its six 3x3 kernels): the six layouts are built on the first call only
    and found on the next; an in-place update of a kernel is seen."""
    from freqfusion_tpu_torch.models.fusion.hierarchical import (
        HierarchicalMultiResolutionFusion)

    dev = cuda_or_skip()
    torch.manual_seed(0)
    bf = torch.bfloat16
    hm = HierarchicalMultiResolutionFusion(4, 64).to(dev).to(bf).eval()
    s3 = torch.rand(1, 76, 24, 72, device=dev).to(bf).permute(0, 2, 3, 1)
    wgmma.clear_weight_layouts()

    def entries():
        return sum(len(t) for t in wgmma._LAYOUTS.values())

    def check():
        cuda.reset_launch_counts()
        tree = hm.stage3_params()
        got = hier_stage3_fused(s3, tree)
        _bf16_close(got, hier_stage3_fused_reference(s3, tree),
                    "hier_stage3_fused.bf16")
        return got
    with torch.inference_mode():
        first = check()
        assert entries() == 6
        assert torch.equal(check(), first)
        assert entries() == 6
    with torch.no_grad():
        hm.stage3_conv[0].weight.mul_(-1)
    with torch.inference_mode():
        assert not torch.equal(check(), first)
