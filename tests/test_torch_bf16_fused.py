"""The byte-floor configuration with bf16 experts: the port against the JAX
package.

- The bf16 plain versions of the fused FFN (#14), the CAB (#15), the
  NAFBlock (#16) and the depthwise conv (#17) against the Pallas kernels in
  interpret mode on the same bf16 operands, within two bf16 ulps
  (BF16_ULPS; the NAFBlock's of the output's largest magnitude, see
  ``_check_top``), at shapes that reach ``pl.pallas_call`` (counted: the CAB,
  NAFBlock and dwconv wrappers take an XLA fallback on small or
  indivisible images, and the fallback rounds elsewhere).
- The tiny experts of tests/test_torch_bf16.py in bf16 with the four gates
  on (FREQFUSION_MLP, _CAB, _NAFBLOCK, _DWCONV) against JAX's bf16 gated
  run (FREQFUSION_PALLAS=1, FREQFUSION_SCAN=xla) and against their own
  fp32 gated output: PSNR >= 45 dB each.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from freqfusion_tpu.ops.pallas_cab import cab_fused as jax_cab_fused
from freqfusion_tpu.ops.pallas_dwconv import dwconv3x3_pallas
from freqfusion_tpu.ops.pallas_mlp import fused_mlp_block as jax_fused_mlp
from freqfusion_tpu.ops.pallas_nafblock import nafblock_fused as jax_nafblock
from freqfusion_tpu_torch.ops.cab import cab_fused
from freqfusion_tpu_torch.ops.dwconv import dwconv3x3
from freqfusion_tpu_torch.ops.mlp import fused_mlp_block
from freqfusion_tpu_torch.ops.nafblock import nafblock_fused

from test_torch_bf16 import (BF, BF16_ULPS, PSNR_FLOOR, TINY,
                             _assert_bf16_close,
                             _bf16_np, _port, _psnr, _tree_bf16)
from test_torch_fused_blocks import GATES, _cab_spec
from test_torch_harness import nchw, nhwc, perturb


@pytest.fixture
def pallas_calls(monkeypatch):
    """The ``pl.pallas_call``s traced, with the four JAX functions' jit
    caches cleared so that every call traces."""
    calls = []
    real = pl.pallas_call

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(pl, "pallas_call", counting)
    for fn in (jax_fused_mlp, jax_cab_fused, jax_nafblock, dwconv3x3_pallas):
        fn.clear_cache()
    return calls


def _tree(rng, spec, scale):
    """bf16-valued numpy tree of normal draws from {name: shape |
    subtree}."""
    return {k: _tree(rng, v, scale) if isinstance(v, dict)
            else _bf16_np(scale * rng.standard_normal(v))
            for k, v in spec.items()}


def _jax_bf(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, BF), tree)


def _port_tree(tree):
    return {k: _port_tree(v) if isinstance(v, dict) else _port(v)
            for k, v in tree.items()}


def _check(got, want):
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got.float().numpy(), want.astype(jnp.float32))


def _check_top(got, want):
    """Max-abs within BF16_ULPS bf16 ulps of the output's largest magnitude
    (chip_smoke.py's bf16_tol). The NAFBlock rounds four intermediates
    (LN1, g s, LN2, the gate g2), and a one-ulp flip of g2 (|g2| up to ~21
    here) moves the output through conv5 and gamma by several of a small
    output's ulps: the same arithmetic in fp32 and in fp64 already differs
    by 0.031 at 27 of its 1.4 M outputs on these inputs."""
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("prenorm", [True, False])
def test_fused_mlp_bf16_matches_pallas(prenorm, pallas_calls):
    """468 rows (padded to the Pallas row tile), C 36, Ch 100."""
    rng = np.random.default_rng(0)
    c, ch = 36, 100
    x = _bf16_np(rng.standard_normal((2, 13, 18, c)))
    w = _tree(rng, {"w1": (c, ch), "b1": (ch,), "w2": (ch, c), "b2": (c,),
                    "lb": (c,)}, 0.2)
    w["ls"] = _bf16_np(1 + 0.1 * rng.standard_normal(c))
    args = [w[k] for k in ("w1", "b1", "w2", "b2", "ls", "lb")]
    want = jax_fused_mlp(jnp.asarray(x, BF), *(jnp.asarray(a, BF)
                                               for a in args),
                         prenorm=prenorm, res_scale=0.75, interpret=True)
    got = fused_mlp_block(_port(x), *map(_port, args), prenorm=prenorm,
                          res_scale=0.75)
    assert len(pallas_calls) == 1
    _check(got, want)


@pytest.mark.parametrize("form", ["grl", "mambair"])
def test_cab_bf16_matches_pallas(form, pallas_calls):
    """C 180 at 16 x 384: in bf16 the Pallas tiles come out 8 x 192 (at 16
    x 192 one tile spans the image and the wrapper falls back to XLA), a
    2 x 2 grid with halo bands. GRL's form plain, MambaIR's with the
    pre-LN and the skip scale."""
    rng = np.random.default_rng(1)
    cr, sq = (45, 18) if form == "grl" else (60, 30)
    w = _tree(rng, _cab_spec(180, cr, sq), 0.05)
    x = _bf16_np(0.5 * rng.standard_normal((1, 16, 384, 180)))
    ln = skip = None
    if form == "mambair":
        ln = {"scale": _bf16_np(1 + 0.1 * rng.standard_normal(180)),
              "bias": _bf16_np(0.1 * rng.standard_normal(180))}
        skip = _bf16_np(1 + 0.2 * rng.standard_normal(180))
    want = jax_cab_fused(jnp.asarray(x, BF), _jax_bf(w),
                         None if ln is None else _jax_bf(ln),
                         None if skip is None else jnp.asarray(skip, BF),
                         interpret=True)
    got = cab_fused(_port(x), _port_tree(w),
                    None if ln is None else _port_tree(ln),
                    None if skip is None else _port(skip))
    assert len(pallas_calls) == 2  # pool and apply
    _check(got, want)


def test_nafblock_bf16_matches_pallas(pallas_calls):
    """C 64 at 16 x 704: 8 x 176 tiles, a 2 x 4 grid with halo bands;
    batch 2 for the per-image SCA pool."""
    rng = np.random.default_rng(2)
    c = 64

    def conv(cin, cout):
        return {"kernel": (1, 1, cin, cout), "bias": (cout,)}
    w = _tree(rng, {"conv1": conv(c, 2 * c), "sca": conv(c, c),
                    "conv3": conv(c, c), "conv4": conv(c, 2 * c),
                    "conv5": conv(c, c),
                    "conv2": {"kernel": (3, 3, 1, 2 * c), "bias": (2 * c,)},
                    "beta": (c,), "gamma": (c,)}, 0.15)
    for n in ("norm1", "norm2"):
        w[n] = {"scale": _bf16_np(1 + 0.1 * rng.standard_normal(c)),
                "bias": _bf16_np(0.1 * rng.standard_normal(c))}
    w["beta"], w["gamma"] = 4 * w["beta"], 4 * w["gamma"]
    x = _bf16_np(rng.uniform(size=(2, 16, 704, c)))
    want = jax_nafblock(jnp.asarray(x, BF), _jax_bf(w), interpret=True)
    got = nafblock_fused(_port(x), _port_tree(w))
    assert len(pallas_calls) == 2  # pool and apply
    _check_top(got, want)


@pytest.mark.parametrize("shape", [(2, 13, 18, 36), (1, 20, 24, 360)])
def test_dwconv_bf16_matches_pallas(shape, pallas_calls):
    """13 x 18: one-row tiles and a whole-width band; 20 x 24 at SS2D's D
    360: 5-row tiles."""
    rng = np.random.default_rng(3)
    c = shape[-1]
    x = _bf16_np(rng.standard_normal(shape))
    k = _bf16_np(rng.standard_normal((3, 3, 1, c)) / 3)
    b = _bf16_np(rng.standard_normal(c))
    want = dwconv3x3_pallas(*(jnp.asarray(a, BF) for a in (x, k, b)),
                            interpret=True)
    got = dwconv3x3(*map(_port, (x, k, b)))
    assert len(pallas_calls) == 1
    _check(got, want)


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_gated_expert_bf16(name, monkeypatch):
    """The port's expert in bf16 with the four byte-floor gates on, against
    JAX's in bf16 with the same gates and against its own fp32 gated
    output, each PSNR >= 45 dB (the weights moved by 0.01 N(0, 1), as
    tests/test_torch_bf16.py's default-route experts)."""
    for g in GATES:
        monkeypatch.setenv(g, "1")
    monkeypatch.setenv("FREQFUSION_PALLAS", "1")
    monkeypatch.setenv("FREQFUSION_SCAN", "xla")
    cls, jax_cls, convert, cfg = TINY[name]
    model = cls(**cfg, generator=torch.Generator().manual_seed(1))
    params = convert(perturb(model, 3, scale=0.01))
    x = np.random.default_rng(0).uniform(0, 1, (1, 16, 16, 3)).astype(
        np.float32)
    want, _ = jax.jit(jax_cls(**cfg).apply)(_tree_bf16(params),
                                            jnp.asarray(x).astype(BF))
    with torch.no_grad():
        sr32, _ = model(nchw(x))
        model.to(torch.bfloat16)
        sr16, feat16 = model(nchw(x).to(torch.bfloat16))
    assert sr16.dtype == feat16.dtype == torch.bfloat16
    got = nhwc(sr16.float())
    vs_jax = _psnr(got, np.asarray(want.astype(jnp.float32)))
    vs_fp32 = _psnr(got, nhwc(sr32))
    assert vs_jax >= PSNR_FLOOR and vs_fp32 >= PSNR_FLOOR, (vs_jax, vs_fp32)
