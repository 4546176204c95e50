"""The in-kernel projection configuration in bf16 (FREQFUSION_ATTN_QKV,
_GRL_QKV, _TOKEN_ATTN with the experts and the fusion net in bf16): the
port against the JAX package.

- The bf16 plain versions of DRCT's qkv window attention (#11), GRL's qkv
  mixed attention (#12) and the token attention (#13) against the Pallas
  kernels in interpret mode on the same bf16 operands, at shapes that reach
  ``pl.pallas_call`` (counted), within two bf16 ulps of the output's
  largest magnitude (tests/test_torch_bf16_fused.py's ``_check_top``).
  #11 and #12 unshifted and shifted. #13 at both fusion-net geometries
  over 1024 pixels, where fewer than 5% of the outputs may differ at all:
  its bf16 plain version follows the kernel's rounding points, and an
  output lands on the other bf16 neighbour only where fp32 sums in another
  order cross a rounding boundary (a version that ran the projections,
  the logits and the softmax in bf16 op by op differed in 53% and 56%).
- DRCT's WindowAttention, GRL's MixedAttention and the fusion net's
  TokenMultiheadAttention with their gates on, cast to bf16, against
  JAX's gated modules on the ``astype(bfloat16)`` parameters (JAX with
  FREQFUSION_PALLAS=1): the same two ulps.
- The tiny four-expert pipeline of tests/test_torch_pipeline.py with
  ``expert_dtype`` and ``fusion_dtype`` bf16 and the three gates on,
  against JAX's ``FreqFusionPipeline`` with both bf16 and the same gates,
  and against its own fp32 gated output: PSNR >= 45 dB each.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from freqfusion_tpu.convert.grl import convert_grl
from freqfusion_tpu.models.drct import WindowAttention as JaxWindowAttention
from freqfusion_tpu.models.fusion.lka import (
    TokenMultiheadAttention as JaxTokenAttention)
from freqfusion_tpu.models.grl import MixedAttention as JaxMixedAttention
from freqfusion_tpu.ops.pallas_attention import (
    fused_grl_mixed_attention_qkv_nhwc, fused_window_attention_qkv_nhwc)
from freqfusion_tpu.ops.pallas_token_attention import fused_token_attention
from freqfusion_tpu_torch.models.drct import WindowAttention
from freqfusion_tpu_torch.models.fusion.lka import TokenMultiheadAttention
from freqfusion_tpu_torch.models.grl import GRL
from freqfusion_tpu_torch.models.pipeline import FreqFusionPipeline
from freqfusion_tpu_torch.ops.attention import (grl_mixed_attention_qkv_nhwc,
                                                window_attention_qkv_nhwc)
from freqfusion_tpu_torch.ops.grl_tables import window_shift_mask
from freqfusion_tpu_torch.ops.token_attention import token_attention
from freqfusion_tpu_torch.ops.window_attention import shifted_window_mask

from test_torch_bf16 import BF, PSNR_FLOOR, _bf16_np, _port, _psnr, _tree_bf16
from test_torch_bf16_fused import _check_top
from test_torch_fusion_bf16 import _floating_bf16
from test_torch_harness import nchw, nhwc, perturb
from test_torch_pipeline import pipelines  # noqa: F401 (fixture)
from test_torch_qkv_attention import _gates_on, _linear_tree

# #13: the share of outputs that may differ from the Pallas kernel's
DIFFER_MAX = 0.05


@pytest.fixture
def pallas_calls(monkeypatch):
    """The ``pl.pallas_call``s traced, with the three JAX functions' jit
    caches cleared so that every call traces."""
    calls = []
    real = pl.pallas_call

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(pl, "pallas_call", counting)
    for fn in (fused_window_attention_qkv_nhwc,
               fused_grl_mixed_attention_qkv_nhwc, fused_token_attention):
        fn.clear_cache()
    return calls


def _bf(rng, shape, scale=1.0):
    """Normal draws rounded to bf16, as fp32 numpy."""
    return _bf16_np(scale * rng.standard_normal(shape))


def _jx(a):
    return None if a is None else jnp.asarray(a, BF)


def _pt(a):
    return None if a is None else _port(a)


def _check(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _check_top(g, w)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_qkv_bf16_matches_pallas(masked, pallas_calls):
    """C 60 over 6 heads, 16 x 24 at window 8: bf16 x, weights, biases and
    bias table; the shift mask fp32 (the JAX wrapper casts it to bf16, its
    values exact there)."""
    rng = np.random.default_rng(60 + masked)
    h, w, c, heads, ws = 16, 24, 60, 6, 8
    n = ws * ws
    arrays = (_bf(rng, (1, h, w, c)), _bf(rng, (c, 3 * c), c ** -0.5),
              _bf(rng, (3 * c,), 0.1), _bf(rng, (c, c), c ** -0.5),
              _bf(rng, (c,), 0.1), _bf(rng, (heads, n, n), 0.5))
    mask = shifted_window_mask(h, w, ws, ws // 2) if masked else None
    want = fused_window_attention_qkv_nhwc(
        *map(_jx, arrays), None if mask is None else jnp.asarray(mask),
        num_heads=heads, window_size=ws, interpret=True)
    got = window_attention_qkv_nhwc(
        *map(_pt, arrays), None if mask is None else torch.from_numpy(mask),
        heads, ws)
    assert len(pallas_calls) == 1
    _check(got, want)


@pytest.mark.parametrize("shifted", [False, True])
def test_grl_mixed_attention_qkv_bf16_matches_pallas(shifted, pallas_calls):
    """C 48 (C/2 24 over 3 + 3 heads) at 16 x 24, window 8, 4 x 4 anchors:
    bf16 x, x_rolled, anchor and weights; fp32 scales, biases and mask, as
    GRL's module hands them in bf16 mode."""
    rng = np.random.default_rng(48 + shifted)
    h, w, c, ws = 16, 24, 48, 8
    x = _bf(rng, (1, h, w, c))
    x_rolled = np.roll(x, (-4, -4), axis=(1, 2)) if shifted else None
    mask = window_shift_mask(h, w, ws, 4) if shifted else None
    bf16s = (x, x_rolled, _bf(rng, (1, h // 2, w // 2, c // 2)),
             _bf(rng, (c, 3 * c), c ** -0.5), _bf(rng, (3 * c,), 0.1))
    fp32s = [rng.uniform(5, 30, (3, 1, 1)).astype(np.float32)
             for _ in range(3)]
    fp32s += [(16 / (1 + np.exp(-rng.standard_normal(s)))).astype(np.float32)
              for s in ((3, 64, 64), (3, 16, 64), (3, 64, 16))]
    fp32s.append(mask)
    want = fused_grl_mixed_attention_qkv_nhwc(
        *map(_jx, bf16s), *(None if a is None else jnp.asarray(a)
                            for a in fp32s),
        num_heads_w=3, num_heads_s=3, window_size=ws, down_factor=2,
        interpret=True)
    got = grl_mixed_attention_qkv_nhwc(
        *map(_pt, bf16s), *(None if a is None else torch.from_numpy(a)
                            for a in fp32s), 3, 3, ws, 2)
    assert len(pallas_calls) == 1
    _check(got, want)


def test_grl_mixed_attention_qkv_bf16_rounds_the_mask_like_pallas(
        pallas_calls):
    """The shifted case above with a mask of values that bf16 does not
    hold exactly: the JAX wrapper casts it to bf16 (pallas_attention.py:
    882), and so does the port."""
    rng = np.random.default_rng(23)
    h, w, c, ws = 16, 24, 48, 8
    x = _bf(rng, (1, h, w, c))
    mask = rng.uniform(-40, 40, (6, 64, 64)).astype(np.float32)
    assert (_bf16_np(mask) != mask).any()
    bf16s = (x, np.roll(x, (-4, -4), axis=(1, 2)),
             _bf(rng, (1, h // 2, w // 2, c // 2)),
             _bf(rng, (c, 3 * c), c ** -0.5), _bf(rng, (3 * c,), 0.1))
    fp32s = [rng.uniform(5, 30, (3, 1, 1)).astype(np.float32)
             for _ in range(3)]
    fp32s += [(16 / (1 + np.exp(-rng.standard_normal(s)))).astype(np.float32)
              for s in ((3, 64, 64), (3, 16, 64), (3, 64, 16))]
    fp32s.append(mask)
    want = fused_grl_mixed_attention_qkv_nhwc(
        *map(_jx, bf16s), *map(jnp.asarray, fp32s), num_heads_w=3,
        num_heads_s=3, window_size=ws, down_factor=2, interpret=True)
    got = grl_mixed_attention_qkv_nhwc(
        *map(_pt, bf16s), *map(torch.from_numpy, fp32s), 3, 3, ws, 2)
    assert len(pallas_calls) == 1
    _check(got, want)


@pytest.mark.parametrize("t,e,nh", [(9, 64, 4), (4, 128, 8)])
def test_token_attention_bf16_matches_pallas(t, e, nh, pallas_calls):
    """Phase 3's (9 bands, E 64, 4 heads) and phase 4's (4 experts, E 128,
    8 heads) geometries over 1024 pixels (two of the JAX wrapper's
    512-pixel blocks): two ulps of the largest output, and under 5% of
    the outputs different at all."""
    rng = np.random.default_rng(t)
    arrays = (_bf(rng, (1024, t, e)), _bf(rng, (e, 3 * e), e ** -0.5),
              _bf(rng, (3 * e,), 0.1), _bf(rng, (e, e), e ** -0.5),
              _bf(rng, (e,), 0.1))
    want = fused_token_attention(*map(_jx, arrays), num_heads=nh,
                                 interpret=True)
    got = token_attention(*map(_pt, arrays), nh)
    assert len(pallas_calls) == 1
    _check(got, want)
    differ = np.mean(got.float().numpy()
                     != np.asarray(want.astype(jnp.float32)))
    assert differ < DIFFER_MAX, differ


@pytest.mark.parametrize("shifted", [False, True])
def test_gated_window_attention_module_bf16(shifted, monkeypatch):
    """DRCT's WindowAttention (C 60, 6 heads, window 8) in bf16 with
    FREQFUSION_ATTN_QKV=1 in both packages; the shift mask fp32 in both."""
    _gates_on(monkeypatch)
    h, w, c, ws = 16, 24, 60, 8
    mod = WindowAttention(c, ws, 6)
    perturb(mod, 62 + shifted)
    params = {"params": {
        "relative_position_bias_table":
            mod.relative_position_bias_table.detach().numpy(),
        "qkv": _linear_tree(mod.qkv), "proj": _linear_tree(mod.proj)}}
    x = _bf(np.random.default_rng(63), (1, h, w, c))
    mask = shifted_window_mask(h, w, ws, ws // 2) if shifted else None
    want = JaxWindowAttention(c, ws, 6).apply(
        _tree_bf16(params), _jx(x),
        None if mask is None else jnp.asarray(mask))
    mod.to(torch.bfloat16)
    with torch.no_grad():
        got = mod(_pt(x), None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    _check(got, want)


@pytest.mark.parametrize("block", [0, 1])
def test_gated_mixed_attention_module_bf16(block, monkeypatch):
    """GRL's MixedAttention (C 48, 3 + 3 heads, window 8) in bf16 with
    FREQFUSION_GRL_QKV=1 in both packages: block 0 is shifted, block 1
    not."""
    _gates_on(monkeypatch)
    model = GRL(upscale=4, embed_dim=48, depths=(2,), num_heads_w=3,
                num_heads_s=3, window_size=8,
                generator=torch.Generator().manual_seed(64))
    tree = convert_grl(perturb(model, 65))
    params = {"params": tree["params"]["layers_0"][f"blocks_{block}"]["attn"]}
    x = _bf(np.random.default_rng(66), (1, 16, 24, 48))
    want = JaxMixedAttention(48, 3, 3, 8, block == 0, (8, 8), 2).apply(
        _tree_bf16(params), _jx(x))
    attn = model.layers[0].blocks[block].attn.to(torch.bfloat16)
    with torch.no_grad():
        got = attn(_pt(x))
    assert got.dtype == torch.bfloat16
    _check(got, want)


@pytest.mark.parametrize("t,e,nh", [(9, 64, 4), (4, 128, 8)])
def test_gated_token_attention_module_bf16(t, e, nh, monkeypatch):
    """The fusion net's TokenMultiheadAttention in bf16 with
    FREQFUSION_TOKEN_ATTN=1 in both packages, over [2, 16, 32] pixels (two
    of the JAX wrapper's blocks)."""
    _gates_on(monkeypatch)
    mod = TokenMultiheadAttention(e, nh)
    with torch.no_grad():
        mod.reset_extra(torch.Generator().manual_seed(t))
    perturb(mod, t + 70)
    params = {"params": {
        "in_proj_weight": mod.in_proj_weight.detach().numpy().T,
        "in_proj_bias": mod.in_proj_bias.detach().numpy(),
        "out_proj": _linear_tree(mod.out_proj)}}
    x = _bf(np.random.default_rng(71), (2, 16, 32, t, e))
    want = JaxTokenAttention(nh).apply(_tree_bf16(params), _jx(x))
    mod.to(torch.bfloat16)
    with torch.no_grad():
        got = mod(_pt(x))
    assert got.dtype == torch.bfloat16
    _check(got, want)


def test_tiny_pipeline_bf16_projection_matches_jax(pipelines,  # noqa: F811
                                                  monkeypatch):
    """tests/test_torch_pipeline.py's tiny pipeline with expert_dtype and
    fusion_dtype bf16 and the three projection gates on in both packages,
    against JAX's FreqFusionPipeline with both bf16 and against the port's
    own fp32 output with the same gates: PSNR >= 45 dB each."""
    _gates_on(monkeypatch)
    jp, params, port = pipelines
    lr = np.random.default_rng(0).uniform(0, 1, (1, 16, 16, 3)).astype(
        np.float32)
    jp16 = copy.copy(jp)
    jp16.expert_dtype = jp16.fusion_dtype = BF
    params16 = {n: _floating_bf16(p) if n == "fusion" else _tree_bf16(p)
                for n, p in params.items()}
    want = np.asarray(jax.jit(jp16._forward_full)(params16, jnp.asarray(lr)))
    bf = torch.bfloat16
    pipe16 = FreqFusionPipeline(copy.deepcopy(dict(port.experts)),
                                copy.deepcopy(port.fusion), port.scale, bf,
                                bf).eval()
    with torch.no_grad():
        got = pipe16(nchw(lr))
        fp32 = port(nchw(lr))
    assert got.dtype == torch.float32
    vs_jax, vs_fp32 = _psnr(nhwc(got), want), _psnr(got, fp32)
    assert vs_jax >= PSNR_FLOOR and vs_fp32 >= PSNR_FLOOR, (vs_jax, vs_fp32)
