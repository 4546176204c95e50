"""The port's kernel functions against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; here that plain
version is held to the Pallas kernel in interpret mode (as
test_pallas_attention.py, test_grl_pallas_path.py and test_pallas_scan.py
run it) within 2e-5 max-abs. test_torch_kernels_cuda.py holds the CUDA
kernels to these plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from freqfusion_tpu.ops.pallas_attention import (
    fused_grl_mixed_attention_nhwc, fused_window_attention_nhwc)
from freqfusion_tpu.ops.selective_scan import (
    selective_scan as jax_selective_scan, selective_scan_pallas_chain,
    selective_scan_pallas_chain_proj)
from freqfusion_tpu.ops.window_attention import (
    relative_position_index as jax_rpi, shifted_window_mask as jax_mask)
from freqfusion_tpu.ops.grl_tables import (
    relative_coords_table_all as jax_table,
    relative_position_index_simple as jax_rpi_simple)
from freqfusion_tpu_torch.ops import cuda as port_cuda
from freqfusion_tpu_torch.ops.attention import (
    grl_mixed_attention_nhwc, window_attention_nhwc)
from freqfusion_tpu_torch.ops.grl_tables import (
    relative_coords_table_all, relative_position_index_simple)
from freqfusion_tpu_torch.ops.selective_scan import (
    selective_scan, selective_scan_chain, selective_scan_chain_proj)
from freqfusion_tpu_torch.ops.window_attention import (
    relative_position_index, shifted_window_mask)

from test_torch_harness import KERNEL_ATOL

T = torch.from_numpy
J = jnp.asarray


def _window_inputs(rng, h, w, c, nh, ws, shift):
    q, k, v = (rng.normal(size=(1, h, w, c)).astype(np.float32)
               for _ in range(3))
    n = ws * ws
    bias = (0.5 * rng.normal(size=(nh, n, n))).astype(np.float32)
    mask = jax_mask(h, w, ws, ws // 2) if shift else None
    return q, k, v, bias, mask


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("c,heads", [(60, 2), (106, 2), (122, 1)])
def test_window_attention_plain_matches_pallas(c, heads, shift):
    """Head dims 30, 53 and 122 (DRCT-L's dense blocks), with and
    without the shifted-window mask."""
    rng = np.random.default_rng(c + shift)
    q, k, v, bias, mask = _window_inputs(rng, 16, 32, c, heads, 8, shift)
    want = fused_window_attention_nhwc(
        J(q), J(k), J(v), J(bias), None if mask is None else J(mask),
        num_heads=heads, window_size=8, interpret=True)
    got = window_attention_nhwc(T(q), T(k), T(v), T(bias),
                                None if mask is None else T(mask), heads, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


def _grl_inputs(rng, h, w, c2, nh, ws, shift):
    halves = [rng.normal(size=(1, h, w, c2)).astype(np.float32)
              for _ in range(6)]
    anchor = rng.normal(size=(1, h // 2, w // 2, c2)).astype(np.float32)
    n, na = ws * ws, (ws // 2) ** 2
    scales = [rng.uniform(1, 30, (nh, 1, 1)).astype(np.float32)
              for _ in range(3)]
    biases = [rng.uniform(0, 16, s).astype(np.float32)
              for s in ((nh, n, n), (nh, na, n), (nh, n, na))]
    mask = jax_mask(h, w, ws, ws // 2) if shift else None
    return halves + [anchor] + scales + biases, mask


@pytest.mark.parametrize("shift", [False, True])
def test_grl_mixed_attention_plain_matches_pallas(shift):
    """GRL-B geometry: 3 + 3 heads of hd 30, 8x8 tiles, 4x4 anchors."""
    rng = np.random.default_rng(11 + shift)
    args, mask = _grl_inputs(rng, 16, 24, 90, 3, 8, shift)
    want = fused_grl_mixed_attention_nhwc(
        *map(J, args), None if mask is None else J(mask), num_heads_w=3,
        num_heads_s=3, window_size=8, interpret=True)
    got = grl_mixed_attention_nhwc(*map(T, args),
                                   None if mask is None else T(mask), 3, 3, 8)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0,
                                   atol=KERNEL_ATOL)


def _scan_inputs(rng, b, t, r, d, n):
    u = rng.normal(size=(b, t, r, d)).astype(np.float32)
    dt = (0.3 * rng.normal(size=(b, t, r, d))).astype(np.float32)
    A = -np.exp(rng.uniform(0, 2.7, (d, n))).astype(np.float32)
    B = rng.normal(size=(b, t, r, n)).astype(np.float32)
    C = rng.normal(size=(b, t, r, n)).astype(np.float32)
    D = rng.normal(size=(d,)).astype(np.float32)
    bias = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    return u, dt, A, B, C, D, bias


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_chain_plain_matches_pallas(reverse):
    """Chain contract; T = 162 spans two of the Pallas kernel's time
    chunks, the shape of the reverse-direction bug the JAX chain kernels
    once shipped."""
    rng = np.random.default_rng(41 + reverse)
    args = _scan_inputs(rng, 1, 162, 8, 128, 4)
    want = selective_scan_pallas_chain(*map(J, args), reverse=reverse,
                                       use_exp2=False, interpret=True)
    got = selective_scan_chain(*map(T, args), reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_chain_proj_plain_matches_pallas(reverse):
    """chain_proj contract (pre-silu xc, projections inside)."""
    rng = np.random.default_rng(13 + reverse)
    b, t, r, d, n, dtr = 1, 162, 8, 128, 4, 8
    xc = rng.normal(size=(b, t, r, d)).astype(np.float32)
    xpw = (0.1 * rng.normal(size=(dtr + 2 * n, d))).astype(np.float32)
    dtw = (0.1 * rng.normal(size=(d, dtr))).astype(np.float32)
    _, _, A, _, _, D, bias = _scan_inputs(rng, b, 1, 1, d, n)
    args = (xc, xpw, dtw, A, D, bias)
    want = selective_scan_pallas_chain_proj(*map(J, args), reverse=reverse,
                                            use_exp2=False, interpret=True)
    got = selective_scan_chain_proj(*map(T, args), reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


def test_flat_scan_matches_jax_across_chunks():
    """The plain chunked scan == JAX's selective_scan, with chunk sizes
    that do not divide L (carry stitched across chunk boundaries)."""
    rng = np.random.default_rng(3)
    u, dt, A, B, C, D, bias = (x[:, :, 0] if x.ndim == 4 else x
                               for x in _scan_inputs(rng, 2, 300, 1, 16, 4))
    want = jax_selective_scan(J(u), J(dt), J(A), J(B), J(C), J(D),
                              delta_bias=J(bias), chunk=64)
    got = selective_scan(T(u), T(dt), T(A), T(B), T(C), T(D),
                         delta_bias=T(bias), chunk=37)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


def test_tables_match_jax():
    for ws in (8, 16):
        np.testing.assert_array_equal(relative_position_index(ws, ws),
                                      jax_rpi(ws, ws))
        np.testing.assert_array_equal(shifted_window_mask(32, 48, ws, ws // 2),
                                      jax_mask(32, 48, ws, ws // 2))
    assert shifted_window_mask(32, 48, 8, 0) is None
    for df in (1, 2):
        np.testing.assert_array_equal(relative_coords_table_all((8, 8), df),
                                      jax_table((8, 8), df))
        for w2a in (False, True):
            np.testing.assert_array_equal(
                relative_position_index_simple((8, 8), df, w2a),
                jax_rpi_simple((8, 8), df, w2a))


def test_wrappers_refuse_other_devices():
    """CPU tensors take the plain version; any non-CUDA device raises
    instead of falling back."""
    rng = np.random.default_rng(0)
    q, k, v, bias, _ = _window_inputs(rng, 8, 8, 8, 2, 8, False)
    meta = [T(a).to("meta") for a in (q, k, v, bias)]
    with pytest.raises(ValueError, match="unsupported device"):
        window_attention_nhwc(*meta, None, 2, 8)
    args, _ = _grl_inputs(rng, 8, 8, 6, 3, 8, False)
    with pytest.raises(ValueError, match="unsupported device"):
        grl_mixed_attention_nhwc(*(T(a).to("meta") for a in args), None,
                                 3, 3, 8)
    sargs = _scan_inputs(rng, 1, 4, 2, 8, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        selective_scan_chain(*(T(a).to("meta") for a in sargs))
    assert port_cuda.launch_counts.get("window_attention_nhwc", 0) == 0
