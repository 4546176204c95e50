"""MambaIR's chainv5, spatial and bidir scan routes in bf16: the port
against the JAX package.

- The plain versions of the chain (#5), spatial (#9) and bidir (#8) scans
  against the JAX Pallas kernels in interpret mode, at the operand dtypes
  each route hands them in bf16: #5 bf16 u, dt, B, C and y; #9 bf16 u,
  dt, B and C with fp32 y; #8 bf16 u with fp32 dt, B, C and y.
- Each route's scan operands: those the JAX SS2D hands its kernel in bf16
  (FREQFUSION_PALLAS=1, the kernel function recorded where SS2D looks it
  up), against the port's projections of the same u.
- chainv5's y in bf16 and its direction sums in bf16, as JAX's.
- The tiny MambaIR in bf16 against JAX's in bf16 on each route.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import freqfusion_tpu.ops.selective_scan as jax_scan
from freqfusion_tpu.convert.mambair import convert_mambair
from freqfusion_tpu.models.mambair import MambaIR as JaxMambaIR
from freqfusion_tpu_torch.models import mambair as port_mambair
from freqfusion_tpu_torch.models.mambair import MambaIR
from freqfusion_tpu_torch.ops.selective_scan import (
    selective_scan_bidir, selective_scan_chain, selective_scan_spatial)

from test_torch_bf16 import (PSNR_FLOOR, _assert_bf16_close, _bf16_np,
                             _psnr, _tree_bf16)
from test_torch_harness import KERNEL_ATOL, nchw, nhwc, perturb

BF = jnp.bfloat16
# the tiny MambaIR of tests/test_torch_bf16.py
GEOMETRY = dict(upscale=4, embed_dim=60, depths=(2,), d_state=8)
# route -> (image, the JAX kernel SS2D calls on it)
ROUTES = {"chainv5": ((16, 16), "selective_scan_pallas_chain"),
          "spatial": ((16, 16), "selective_scan_pallas_spatial"),
          "bidir": ((12, 20), "selective_scan_pallas_bidir")}
# JAX's calls of one layer in order -> SS2D's direction k (chainv5 and
# spatial: the row pair, forward then backward, then the column pair)
CALL_DIRECTION = (0, 2, 1, 3)
# the projections of bf16 operands in fp32, rounded once: sums in another
# order may round to the neighbouring bf16 value
BIT_EQUAL_SHARE = 0.99
# a value that cancels to near zero carries the fp32 sums' order noise
# (~2^-24 of the terms times their count), which can exceed its own bf16
# ulp: its ulp is taken at no less than 2^-16 of the operand's largest
# magnitude
ULP_FLOOR = 2.0 ** -16
# bidir's fp32 operands: sums of 120 products in another order, max-abs
# relative to the operand's largest magnitude
FP32_REL_TOL = 1e-5


def _operands(rng, lead, d, n, group=()):
    """u, dt, A, B, C, D, bias (as tests/test_torch_scan_routes.py makes
    them), each rounded to bf16 (A to fp32 after)."""
    u = rng.normal(size=lead + (d,))
    dt = 0.5 * rng.normal(size=lead + (d,))
    A = -np.exp(rng.uniform(0, 2.7, group + (d, n)))
    B, C = (rng.normal(size=lead + (n,)) for _ in range(2))
    D = rng.normal(size=group + (d,))
    bias = 0.2 * rng.normal(size=group + (d,))
    return tuple(_bf16_np(a) for a in (u, dt, A, B, C, D, bias))


def _j(a, bf16: bool):
    return jnp.asarray(a, BF if bf16 else jnp.float32)


def _t(a, bf16: bool):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(torch.bfloat16) if bf16 else t


@pytest.mark.parametrize("reverse", [False, True])
def test_chain_bf16_plain_matches_pallas(reverse):
    """#5 on chainv5's bf16 operands (u, dt, B, C bf16; A, D and the bias
    fp32, as the route pads and casts them) with y bf16 (out_dtype), D a
    multiple of 128 and R of 8 as the JAX kernel needs: the shape and
    arguments SS2D's chainv5 route hands it in the tiny MambaIR at 16 x 16
    (the route fixture below), so the two share its compiled programs."""
    args = _operands(np.random.default_rng(5 + reverse), (1, 16, 16), 128, 8)
    bf = (True, True, False, True, True, False, False)
    want = jax_scan.selective_scan_pallas_chain(
        *(_j(a, b) for a, b in zip(args, bf)), reverse=reverse,
        out_dtype=jnp.dtype(BF), approx_init=False)
    got = selective_scan_chain(*(_t(a, b) for a, b in zip(args, bf)),
                               reverse=reverse, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got.float().numpy(), want.astype(jnp.float32))


@pytest.mark.parametrize("reverse", [False, True])
def test_spatial_bf16_plain_matches_pallas(reverse):
    """#9 on the spatial route's bf16 operands (u, dt, B, C and the bias
    bf16; A and D fp32), y fp32, at tests/test_torch_scan_routes.py's
    shape."""
    args = _operands(np.random.default_rng(11 + reverse), (2, 5, 24), 12, 4)
    bf = (True, True, False, True, True, False, True)
    want = jax_scan.selective_scan_pallas_spatial(
        *(_j(a, b) for a, b in zip(args, bf)), reverse=reverse,
        interpret=True)
    got = selective_scan_spatial(*(_t(a, b) for a, b in zip(args, bf)),
                                 reverse=reverse)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


def test_bidir_bf16_plain_matches_pallas():
    """#8 on the bidir route's operands in bf16 (u and the bias bf16; dt,
    B, C, A and D fp32), y fp32: L 240 over chunks of 32 (a ragged last
    one), D 120, N 8, the shape and arguments SS2D's bidir route hands it
    in the tiny MambaIR at 12 x 20 (the route fixture below), so the two
    share its compiled programs."""
    u, *rest = _operands(np.random.default_rng(7), (4, 1, 240), 120, 8,
                         (4,))
    args = (u[:2], *rest)
    bf = (True, False, False, False, False, False, True)
    want = jax_scan.selective_scan_pallas_bidir(
        *(_j(a, b) for a, b in zip(args, bf)), chunk=32)
    got = selective_scan_bidir(*(_t(a, b) for a, b in zip(args, bf)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=KERNEL_ATOL)


def _np(a):
    """A JAX operand as (fp32 numpy, dtype name)."""
    return (np.array(jnp.asarray(a).astype(jnp.float32)),
            str(jnp.asarray(a).dtype))


@pytest.fixture(scope="module", params=sorted(ROUTES))
def jax_route(request):
    """The tiny MambaIR in bf16 through JAX on one route (FREQFUSION_PALLAS=1,
    interpret mode), the operands of each scan kernel call recorded: the
    route, the port model (bf16, the same weights), the image, JAX's bf16
    output and the calls' positional operands."""
    route = request.param
    hw, kernel = ROUTES[route]
    model = MambaIR(**GEOMETRY, generator=torch.Generator().manual_seed(1))
    params = _tree_bf16(convert_mambair(perturb(model, 3, scale=0.01)))
    x = np.random.default_rng(0).uniform(0, 1, (1, *hw, 3)).astype(
        np.float32)
    calls = []
    run = getattr(jax_scan, kernel)

    def recorded(*args, **kwargs):
        calls.append([_np(a) for a in args])
        return run(*args, **kwargs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FREQFUSION_PALLAS", "1")
        mp.setenv("FREQFUSION_SCAN", "chainv5" if route == "chainv5"
                  else "spatial")
        mp.setattr(jax_scan, kernel, recorded)
        want, _ = JaxMambaIR(**GEOMETRY, scan_chunk=32).apply(
            params, jnp.asarray(x).astype(BF))
    return (route, model.to(torch.bfloat16), x,
            np.asarray(want.astype(jnp.float32)), calls)


def _bit_equal_share(got: torch.Tensor, want: np.ndarray) -> float:
    """The share of got's bf16 values equal to want's; asserts that each
    lies within one bf16 ulp of the larger of the two magnitudes, the ulp
    taken at no less than ULP_FLOOR of want's largest magnitude."""
    g = got.float().numpy()
    mag = np.maximum(np.maximum(np.abs(g), np.abs(want)),
                     ULP_FLOOR * np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (np.abs(g - want) <= ulp).all(), np.abs(g - want).max()
    return float((g == want).mean())


def test_route_operands_match_jax(jax_route, monkeypatch):
    """The operands the port's route hands its scan kernel, from the u
    JAX's SS2D handed its kernel in the first layer, against JAX's:
    chainv5's and spatial's bf16 dt, B and C bit-equal in >= 99% of
    values and within one bf16 ulp in all; bidir's fp32 dt, B and C
    within 1e-5 of each operand's largest magnitude, beside the bf16 u."""
    route, model, _, _, calls = jax_route
    ss2d = model.layers[0].residual_group.blocks[0].self_attention
    d = ss2d.d_inner
    if route == "bidir":
        (xs2, un), (dts, dn), _, (B, bn), (C, cn) = calls[0][:5]
        assert (un, dn, bn, cn) == ("bfloat16",) + ("float32",) * 3
        seen = {}

        def recorded(u2, delta, A, Bm, Cm, D, bias):
            seen.update(u=u2, dt=delta, B=Bm, C=Cm)
            zeros = torch.zeros(u2.shape)
            return zeros, zeros
        monkeypatch.setattr(port_mambair, "selective_scan_bidir", recorded)
        h, w = ROUTES["bidir"][0]
        u = torch.from_numpy(xs2[0]).to(torch.bfloat16).view(1, h, w, d)
        with torch.no_grad():
            ss2d._bidir(u, None, None)
        assert torch.equal(seen["u"].float(), torch.from_numpy(xs2))
        for name, want in (("dt", dts), ("B", B), ("C", C)):
            got = seen[name]
            assert got.dtype == torch.float32, name
            err = np.abs(got.numpy() - want).max()
            assert err <= FP32_REL_TOL * np.abs(want).max(), (name, err)
        return
    shares = {}
    for call, k in zip(calls[:4], CALL_DIRECTION):
        (u, _), (dt, dn), _, (B, bn), (C, cn) = call[:5]
        assert (dn, bn, cn) == ("bfloat16",) * 3
        # chainv5's JAX operands carry D padded to a multiple of 128
        with torch.no_grad():
            got = ss2d._project(
                torch.from_numpy(u[..., :d]).to(torch.bfloat16), k)
        for name, g, want in zip(("dt", "B", "C"), got, (dt[..., :d], B, C)):
            assert g.dtype == torch.bfloat16, name
            shares[f"{name}{k}"] = _bit_equal_share(g, want)
    assert min(shares.values()) >= BIT_EQUAL_SHARE, shares


def test_chainv5_bf16_sums_in_bf16(monkeypatch):
    """SS2D's chainv5 route in bf16 asks selective_scan_chain for bf16 y
    (out_dtype) and sums the directions in bf16, as JAX's route does: each
    pair, then the two pair sums (the row pair transposed back)."""
    monkeypatch.setenv("FREQFUSION_SCAN", "chainv5")
    ss2d = port_mambair.SS2D(16, d_state=4)
    with torch.no_grad():
        ss2d.reset_extra(torch.Generator().manual_seed(0))
    ss2d.to(torch.bfloat16)
    ys, sums = [], []

    def recorded(*args, **kwargs):
        assert kwargs.get("out_dtype") == torch.bfloat16, kwargs
        ys.append(selective_scan_chain(*args, **kwargs))
        return ys[-1]
    monkeypatch.setattr(port_mambair, "selective_scan_chain", recorded)
    ss2d.out_norm.register_forward_pre_hook(
        lambda _, args: sums.append(args[0]))
    x = torch.randn(1, 8, 16, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ss2d(x.to(torch.bfloat16))
    assert [y.dtype for y in ys] == [torch.bfloat16] * 4
    want = (ys[0] + ys[1]).transpose(1, 2) + (ys[2] + ys[3])
    assert sums[0].dtype == torch.bfloat16
    assert torch.equal(sums[0], want)


def test_tiny_mambair_bf16_route_matches_jax(jax_route):
    """The tiny MambaIR in bf16 on each route against JAX's in bf16 on
    the same route, PSNR >= 45 dB (tests/test_torch_bf16.py's floor)."""
    route, model, x, want, calls = jax_route
    with torch.no_grad():
        sr, _ = model(nchw(x).to(torch.bfloat16))
    assert sr.dtype == torch.bfloat16
    assert len(calls) == (2 if route == "bidir" else 8)
    db = _psnr(nhwc(sr.float()), want)
    assert db >= PSNR_FLOOR, (route, db)
