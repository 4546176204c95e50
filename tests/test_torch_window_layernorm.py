"""TPU kernels #10 and #22 on the CPU: the port's plain versions of the
window-major window attention (``ops/attention.py:window_attention``) and
of the one-pass LayerNorm (``ops/layernorm.py``) against the Pallas
kernels in interpret mode, and the port's ``FusedLayerNorm`` with JAX
params carried across by ``from_jax_layernorm`` against the JAX module."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from freqfusion_tpu.ops.layernorm import FusedLayerNorm as JaxFusedLayerNorm
from freqfusion_tpu.ops.layernorm import fused_layernorm as jax_layernorm
from freqfusion_tpu.ops.pallas_attention import fused_window_attention
from freqfusion_tpu_torch.convert.from_jax import from_jax_layernorm
from freqfusion_tpu_torch.ops.attention import window_attention
from freqfusion_tpu_torch.ops.layernorm import FusedLayerNorm, fused_layernorm

# fp32 attention: the same sums in another order (as tests/
# test_pallas_attention.py holds the kernel to the einsum)
ATTN_TOL = dict(atol=2e-5, rtol=1e-5)
# fp32 LayerNorm (as tests/test_fused_layernorm.py)
LN_TOL = dict(atol=5e-6, rtol=1e-5)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("b,nw,n,heads,hd", [
    (2, 4, 64, 6, 30),   # tests/test_pallas_attention.py's shape
    (2, 3, 49, 3, 20),   # N not a multiple of 4 nor of the 64-token tile
    (1, 2, 96, 2, 7),    # N not a square, odd head dim
])
def test_window_attention_matches_pallas(b, nw, n, heads, hd, with_mask):
    rng = np.random.default_rng(n + heads)
    c = heads * hd
    q, k, v = (rng.normal(size=(b * nw, n, c)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(heads, n, n)).astype(np.float32)
    mask = (np.where(rng.random((nw, n, n)) < 0.2, -100.0, 0.0
                     ).astype(np.float32) if with_mask else None)
    want = fused_window_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask), num_heads=heads,
        interpret=True)
    got = window_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                           None if mask is None else torch.from_numpy(mask),
                           heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_window_attention_rejects_bad_shapes():
    q = torch.zeros(6, 16, 8)
    bias = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="multiple of nW"):
        window_attention(q, q, q, bias, torch.zeros(4, 16, 16), 2)
    big = torch.zeros(2, 4, 257)
    with pytest.raises(ValueError, match="head dim <= 256"):
        window_attention(big, big, big, torch.zeros(1, 4, 4), None, 1)


def _ln_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape[-1]).astype(np.float32),
            rng.normal(size=shape[-1]).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 33, 180), (1, 16, 24, 360), (7, 131)])
def test_layernorm_matches_pallas_fp32(shape):
    x, s, b = _ln_inputs(shape, 0)
    want = jax_layernorm(*(jnp.asarray(a) for a in (x, s, b)), eps=1e-5,
                         interpret=True)
    got = fused_layernorm(*(torch.from_numpy(a) for a in (x, s, b)),
                          eps=1e-5)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LN_TOL)


def test_layernorm_matches_pallas_bf16():
    """Both round the fp32 result to bf16 once; sums in another order may
    move it across a rounding boundary: within one bf16 ulp of each
    value."""
    x, s, b = _ln_inputs((4, 50, 180), 1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_layernorm(xb, jnp.asarray(s), jnp.asarray(b),
                                    eps=1e-5, interpret=True
                                    ).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    got = fused_layernorm(xt, torch.from_numpy(s), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp)


def test_fused_layernorm_module_matches_jax():
    x, s, b = _ln_inputs((3, 40, 96), 2)
    params = {"params": {"scale": jnp.asarray(s), "bias": jnp.asarray(b)}}
    want = JaxFusedLayerNorm(epsilon=1e-5).apply(params, jnp.asarray(x))
    module = FusedLayerNorm(96, eps=1e-5)
    module.load_state_dict(from_jax_layernorm(params), strict=True)
    assert set(module.state_dict()) == {"weight", "bias"}
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LN_TOL)
    init = JaxFusedLayerNorm().init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 96)))
    fresh = FusedLayerNorm(96).state_dict()
    for k, v in from_jax_layernorm(init).items():
        torch.testing.assert_close(fresh[k], v)
