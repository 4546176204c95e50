"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test is marked ``cuda`` and skips where there is no GPU. This
file imports no JAX, so it runs on a machine without it:

    python -m pytest -o addopts="" --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from freqfusion_tpu_torch.ops import cuda
from freqfusion_tpu_torch.ops.attention import (
    grl_mixed_attention_nhwc, grl_mixed_attention_nhwc_reference,
    window_attention_nhwc, window_attention_nhwc_reference)
from freqfusion_tpu_torch.ops.selective_scan import (
    selective_scan_chain, selective_scan_chain_proj,
    selective_scan_chain_proj_reference, selective_scan_chain_reference)
from freqfusion_tpu_torch.ops.window_attention import shifted_window_mask

from test_torch_harness import cuda_or_skip

# fp32 attention: accumulation order only (max-abs)
ATTN_TOL = 1e-4
# scan: long fp32 recurrences, relative to max |y|
SCAN_REL_TOL = 1e-3


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
