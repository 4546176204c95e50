"""MambaIR's other scan routes: the port against the JAX package.

The plain versions of the four scan entries (flat, K-direction, bidir,
spatial) against the JAX Pallas kernels #6-#9 in interpret mode, at the
shapes of tests/test_pallas_scan.py. Then SS2D's chainv5, spatial and
bidir routes in the port's MambaIR against the JAX model on the same route
(FREQFUSION_PALLAS=1, interpret mode on the CPU), and the route choice
itself: which entry each FREQFUSION_SCAN value and image shape reaches."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from freqfusion_tpu.convert.mambair import convert_mambair
from freqfusion_tpu.models.mambair import MambaIR as JaxMambaIR
from freqfusion_tpu.ops.selective_scan import (
    selective_scan_pallas, selective_scan_pallas_bidir,
    selective_scan_pallas_dirs, selective_scan_pallas_spatial)
from freqfusion_tpu_torch.models import mambair as port_mambair
from freqfusion_tpu_torch.models.mambair import MambaIR, scan_route
from freqfusion_tpu_torch.ops.selective_scan import (
    selective_scan_bidir, selective_scan_dirs, selective_scan_flat,
    selective_scan_spatial)

from test_torch_harness import KERNEL_ATOL, MODEL_TOL, nchw, nhwc, perturb

T = torch.from_numpy
J = jnp.asarray
# the model geometry of tests/test_mambair_pallas_path.py (embed 60 clears
# CAB's squeeze-30 bottleneck)
GEOMETRY = dict(upscale=4, embed_dim=60, depths=(2,), d_state=4)


def _inputs(rng, lead, d, n, group=()):
    """u, dt, A, B, C, D, bias: u and dt [*lead, d], B and C [*lead, n],
    A [*group, d, n], D and bias [*group, d]."""
    u = rng.normal(size=lead + (d,)).astype(np.float32)
    dt = (0.5 * rng.normal(size=lead + (d,))).astype(np.float32)
    A = -np.exp(rng.uniform(0, 2.7, group + (d, n))).astype(np.float32)
    B = rng.normal(size=lead + (n,)).astype(np.float32)
    C = rng.normal(size=lead + (n,)).astype(np.float32)
    D = rng.normal(size=group + (d,)).astype(np.float32)
    bias = (0.2 * rng.normal(size=group + (d,))).astype(np.float32)
    return u, dt, A, B, C, D, bias


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


@pytest.mark.parametrize("l,chunk", [(100, 16), (64, 64), (130, 32)])
def test_scan_flat_plain_matches_pallas(l, chunk):
    """#6 over [B, L, D]; L = 130 spans five of the Pallas kernel's chunks
    and two of the plain version's."""
    args = _inputs(np.random.default_rng(0), (2, l), 12, 4)
    want = selective_scan_pallas(*map(J, args), chunk=chunk, interpret=True)
    _close(selective_scan_flat(*map(T, args)), want)


def test_scan_dirs_plain_matches_pallas():
    """#7: four directions, each with its own A, D and bias, L = 200."""
    args = _inputs(np.random.default_rng(3), (4, 2, 200), 24, 4, (4,))
    want = selective_scan_pallas_dirs(*map(J, args), chunk=64, inner=8,
                                      interpret=True)
    _close(selective_scan_dirs(*map(T, args)), want)


def test_scan_bidir_plain_matches_pallas():
    """#8: u [2, B, L, D] read by four directions, the last two backward
    over the natural order; L = 200 is not a multiple of the chunk."""
    u, dt, A, B, C, D, bias = _inputs(np.random.default_rng(7), (4, 2, 200),
                                      24, 4, (4,))
    args = (u[:2], dt, A, B, C, D, bias)
    want_f, want_b = selective_scan_pallas_bidir(*map(J, args), chunk=64,
                                                 inner=8, interpret=True)
    got_f, got_b = selective_scan_bidir(*map(T, args))
    _close(got_f, want_f)
    _close(got_b, want_b)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_spatial_plain_matches_pallas(reverse):
    """#9 over [B, R, T, D]: five rows of 24, forward and as the suffix
    recurrence."""
    args = _inputs(np.random.default_rng(11), (2, 5, 24), 12, 4)
    want = selective_scan_pallas_spatial(*map(J, args), reverse=reverse,
                                         interpret=True)
    _close(selective_scan_spatial(*map(T, args), reverse=reverse), want)


@pytest.mark.parametrize("scan,hw", [("chainv5", (16, 24)),
                                     ("spatial", (16, 24)),
                                     ("chain", (12, 20))])
def test_mambair_route_matches_jax(scan, hw, monkeypatch):
    """The port's MambaIR on the chainv5, spatial and bidir routes (12 x 20:
    W is not a multiple of 8, so FREQFUSION_SCAN does not matter there)
    against the JAX model on the same route."""
    monkeypatch.setenv("FREQFUSION_PALLAS", "1")
    monkeypatch.setenv("FREQFUSION_SCAN", scan)
    h, w = hw
    x = np.random.default_rng(5).uniform(0, 1, (1, h, w, 3)).astype(
        np.float32)
    model = MambaIR(**GEOMETRY, generator=torch.Generator().manual_seed(6))
    params = convert_mambair(perturb(model, 7))
    sr_j, feat_j = JaxMambaIR(**GEOMETRY, scan_chunk=64).apply(params, J(x))
    with torch.no_grad():
        sr, feat = model(nchw(x))
    np.testing.assert_allclose(nhwc(sr), np.asarray(sr_j), **MODEL_TOL)
    np.testing.assert_allclose(nhwc(feat), np.asarray(feat_j), **MODEL_TOL)


@pytest.mark.parametrize("scan,hw,entry,calls", [
    (None, (16, 24), "selective_scan_chain_proj", 4),
    ("chainproj", (16, 24), "selective_scan_chain_proj", 4),
    ("chainv5", (16, 24), "selective_scan_chain", 4),
    ("spatial", (16, 24), "selective_scan_spatial", 4),
    ("xla", (16, 24), "selective_scan_spatial", 4),
    (None, (12, 24), "selective_scan_bidir", 1),
    ("chainv5", (16, 20), "selective_scan_bidir", 1)])
def test_scan_route_choice(scan, hw, entry, calls, monkeypatch):
    """Which entry one SS2D layer calls, and how often, for each
    FREQFUSION_SCAN value and image shape."""
    if scan is None:
        monkeypatch.delenv("FREQFUSION_SCAN", raising=False)
    else:
        monkeypatch.setenv("FREQFUSION_SCAN", scan)
    assert scan_route(*hw) == {
        "selective_scan_chain_proj": "chain",
        "selective_scan_chain": "chainv5",
        "selective_scan_spatial": "spatial",
        "selective_scan_bidir": "bidir"}[entry]
    entries = ("selective_scan_chain_proj", "selective_scan_chain",
               "selective_scan_spatial", "selective_scan_bidir")
    ran = {name: 0 for name in entries}
    for name in entries:
        def counted(*args, _name=name, _fn=getattr(port_mambair, name),
                    **kwargs):
            ran[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(port_mambair, name, counted)
    ss2d = port_mambair.SS2D(8, d_state=4)
    with torch.no_grad():
        y = ss2d(torch.randn(1, *hw, 8, generator=torch.Generator()
                             .manual_seed(0)))
    assert y.shape == (1, *hw, 8)
    assert ran == {name: calls if name == entry else 0 for name in entries}
