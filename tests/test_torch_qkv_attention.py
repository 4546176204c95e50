"""The in-kernel projection configuration (FREQFUSION_ATTN_QKV,
_GRL_QKV, _TOKEN_ATTN): the port against the JAX package.

Each kernel's plain version against the JAX Pallas function in interpret
mode: DRCT's qkv window attention with an odd head dim and with six
heads, with and without the shift mask; GRL's 6-way qkv mixed attention
shifted (window half from x_rolled) and unshifted; the fusion net's token
attention at both of its geometries, with P not a multiple of the JAX
wrapper's 512-pixel block. Then the three gated modules, the tiny DRCT
and GRL, the fusion net and the tiny four-expert pipeline with the gates
on in both packages (JAX with FREQFUSION_PALLAS=1 and the scan on its
XLA route), and the gated JAX parameter trees through
``convert/from_jax.py`` and back."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from freqfusion_tpu.convert.drct import convert_drct
from freqfusion_tpu.convert.fusion import convert_fusion
from freqfusion_tpu.convert.grl import convert_grl
from freqfusion_tpu.models.drct import DRCT as JaxDRCT
from freqfusion_tpu.models.drct import WindowAttention as JaxWindowAttention
from freqfusion_tpu.models.fusion.fusion_v2 import (
    CompleteEnhancedFusionSR as JaxFusion)
from freqfusion_tpu.models.fusion.lka import (
    TokenMultiheadAttention as JaxTokenAttention)
from freqfusion_tpu.models.grl import GRL as JaxGRL
from freqfusion_tpu.models.grl import MixedAttention as JaxMixedAttention
from freqfusion_tpu.ops.pallas_attention import (
    fused_grl_mixed_attention_qkv_nhwc, fused_window_attention_qkv_nhwc)
from freqfusion_tpu.ops.pallas_token_attention import fused_token_attention
from freqfusion_tpu_torch.convert import from_jax
from freqfusion_tpu_torch.models.drct import DRCT, WindowAttention
from freqfusion_tpu_torch.models.fusion.fusion_v2 import (
    CompleteEnhancedFusionSR)
from freqfusion_tpu_torch.models.fusion.lka import TokenMultiheadAttention
from freqfusion_tpu_torch.models.grl import GRL
from freqfusion_tpu_torch.ops.attention import (grl_mixed_attention_qkv_nhwc,
                                                window_attention_qkv_nhwc)
from freqfusion_tpu_torch.ops.grl_tables import window_shift_mask
from freqfusion_tpu_torch.ops.token_attention import token_attention
from freqfusion_tpu_torch.ops.window_attention import shifted_window_mask

from test_torch_harness import KERNEL_ATOL, MODEL_TOL, nchw, nhwc, perturb

QKV_GATES = ("FREQFUSION_ATTN_QKV", "FREQFUSION_GRL_QKV",
             "FREQFUSION_TOKEN_ATTN")
ALL_GATES = QKV_GATES + ("FREQFUSION_MLP", "FREQFUSION_CAB",
                         "FREQFUSION_NAFBLOCK", "FREQFUSION_DWCONV")


def _f32(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _both(*arrays):
    """The same numpy arrays as JAX arrays and as torch tensors (None
    stays None)."""
    return ([None if a is None else jnp.asarray(a) for a in arrays],
            [None if a is None else torch.from_numpy(a) for a in arrays])


def _gates_on(monkeypatch, gates=QKV_GATES):
    for g in ALL_GATES:
        monkeypatch.delenv(g, raising=False)
    for g in gates:
        monkeypatch.setenv(g, "1")
    monkeypatch.setenv("FREQFUSION_PALLAS", "1")
    monkeypatch.setenv("FREQFUSION_SCAN", "xla")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("c,heads", [(106, 2), (60, 6)])
def test_window_attention_qkv_matches_pallas(c, heads, masked):
    """C 106 over 2 heads (head dim 53, odd; the JAX wrapper pads each of
    q|k|v to 128 columns) and C 60 over 6 heads, 16 x 24 at window 8."""
    rng = np.random.default_rng(c + masked)
    h, w, ws = 16, 24, 8
    n = ws * ws
    arrays = (_f32(rng, (1, h, w, c)), _f32(rng, (c, 3 * c), c ** -0.5),
              _f32(rng, (3 * c,), 0.1), _f32(rng, (c, c), c ** -0.5),
              _f32(rng, (c,), 0.1), _f32(rng, (heads, n, n), 0.5),
              shifted_window_mask(h, w, ws, ws // 2) if masked else None)
    jx, pt = _both(*arrays)
    want = fused_window_attention_qkv_nhwc(
        *jx, num_heads=heads, window_size=ws, interpret=True)
    got = window_attention_qkv_nhwc(*pt, heads, ws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


@pytest.mark.parametrize("shifted", [False, True])
def test_grl_mixed_attention_qkv_matches_pallas(shifted):
    """C 48 (C/2 24 over 3 + 3 heads, head dim 8) at 16 x 24, window 8,
    4 x 4 anchors; shifted blocks hand the kernel x rolled by (-4, -4)
    and the shift mask."""
    rng = np.random.default_rng(11 + shifted)
    h, w, c, ws = 16, 24, 48, 8
    c2 = c // 2
    x = _f32(rng, (1, h, w, c))
    x_rolled = np.roll(x, (-4, -4), axis=(1, 2)) if shifted else None
    mask = window_shift_mask(h, w, ws, 4) if shifted else None
    scales = [rng.uniform(5, 30, (3, 1, 1)).astype(np.float32)
              for _ in range(3)]
    biases = [(16 / (1 + np.exp(-_f32(rng, s)))).astype(np.float32)
              for s in ((3, 64, 64), (3, 16, 64), (3, 64, 16))]
    jx, pt = _both(x, x_rolled, _f32(rng, (1, h // 2, w // 2, c2)),
                   _f32(rng, (c, 3 * c), c ** -0.5), _f32(rng, (3 * c,), 0.1),
                   *scales, *biases, mask)
    want = fused_grl_mixed_attention_qkv_nhwc(
        *jx, num_heads_w=3, num_heads_s=3, window_size=ws, down_factor=2,
        interpret=True)
    got = grl_mixed_attention_qkv_nhwc(*pt, 3, 3, ws, 2)
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=0,
                                   atol=KERNEL_ATOL)


@pytest.mark.parametrize("t,e,nh", [(9, 64, 4), (4, 128, 8)])
def test_token_attention_matches_pallas(t, e, nh):
    """Phase 3's (9 bands, E 64, 4 heads) and phase 4's (4 experts, E 128,
    8 heads) geometries at P = 600 pixels: the JAX wrapper pads to 1024,
    the port's kernel masks its last block."""
    rng = np.random.default_rng(t)
    jx, pt = _both(_f32(rng, (600, t, e)), _f32(rng, (e, 3 * e), e ** -0.5),
                   _f32(rng, (3 * e,), 0.1), _f32(rng, (e, e), e ** -0.5),
                   _f32(rng, (e,), 0.1))
    want = fused_token_attention(*jx, num_heads=nh, interpret=True)
    got = token_attention(*pt, nh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


def _linear_tree(layer: torch.nn.Linear) -> dict:
    return {"kernel": layer.weight.detach().numpy().T,
            "bias": layer.bias.detach().numpy()}


@pytest.mark.parametrize("shifted", [False, True])
def test_gated_window_attention_module_matches_jax(shifted, monkeypatch):
    """DRCT's WindowAttention (C 60, 6 heads, window 8) with
    FREQFUSION_ATTN_QKV=1 in both packages."""
    _gates_on(monkeypatch)
    h, w, c, ws = 16, 24, 60, 8
    mod = WindowAttention(c, ws, 6)
    perturb(mod, 12 + shifted)
    params = {"params": {
        "relative_position_bias_table":
            mod.relative_position_bias_table.detach().numpy(),
        "qkv": _linear_tree(mod.qkv), "proj": _linear_tree(mod.proj)}}
    x = _f32(np.random.default_rng(13), (1, h, w, c))
    mask = shifted_window_mask(h, w, ws, ws // 2) if shifted else None
    want = JaxWindowAttention(c, ws, 6).apply(
        params, jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = mod(torch.from_numpy(x),
                  None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("block", [0, 1])
def test_gated_mixed_attention_module_matches_jax(block, monkeypatch):
    """GRL's MixedAttention (C 48, 3 + 3 heads, window 8) with
    FREQFUSION_GRL_QKV=1 in both packages: block 0 is shifted, block 1
    not."""
    _gates_on(monkeypatch)
    model = GRL(upscale=4, embed_dim=48, depths=(2,), num_heads_w=3,
                num_heads_s=3, window_size=8,
                generator=torch.Generator().manual_seed(14))
    tree = convert_grl(perturb(model, 15))
    params = {"params": tree["params"]["layers_0"][f"blocks_{block}"]["attn"]}
    x = _f32(np.random.default_rng(16), (1, 16, 24, 48))
    want = JaxMixedAttention(48, 3, 3, 8, block == 0, (8, 8), 2).apply(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = model.layers[0].blocks[block].attn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("t,e,nh", [(9, 64, 4), (4, 128, 8)])
def test_gated_token_attention_module_matches_jax(t, e, nh, monkeypatch):
    """The fusion net's TokenMultiheadAttention with
    FREQFUSION_TOKEN_ATTN=1 in both packages, over [2, 6, 10] pixels."""
    _gates_on(monkeypatch)
    mod = TokenMultiheadAttention(e, nh)
    with torch.no_grad():
        mod.reset_extra(torch.Generator().manual_seed(t))
    perturb(mod, t)
    params = {"params": {
        "in_proj_weight": mod.in_proj_weight.detach().numpy().T,
        "in_proj_bias": mod.in_proj_bias.detach().numpy(),
        "out_proj": _linear_tree(mod.out_proj)}}
    x = _f32(np.random.default_rng(17), (2, 6, 10, t, e))
    want = JaxTokenAttention(nh).apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


# The two experts the gates change, at the sizes of test_torch_fused_blocks.
EXPERTS = {
    "drct": (DRCT, JaxDRCT, convert_drct, from_jax.from_jax_drct,
             dict(upscale=4, embed_dim=48, num_layers=1, num_heads=6,
                  window_size=8, gc=8, mlp_ratio=2.0), (16, 16)),
    "grl": (GRL, JaxGRL, convert_grl, from_jax.from_jax_grl,
            dict(upscale=4, embed_dim=48, depths=(2,), num_heads_w=3,
                 num_heads_s=3, window_size=8), (13, 18)),
}


@pytest.mark.parametrize("name", list(EXPERTS))
def test_gated_expert_matches_jax(name, monkeypatch):
    cls, jcls, convert, _, cfg, (h, w) = EXPERTS[name]
    _gates_on(monkeypatch)
    rng = np.random.default_rng(len(name) + 30)
    x = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    model = cls(**cfg, generator=torch.Generator().manual_seed(31))
    params = convert(perturb(model, 32))
    sr_j, feat_j = jax.jit(jcls(**cfg).apply)(params, jnp.asarray(x))
    with torch.no_grad():
        sr, feat = model(nchw(x))
    np.testing.assert_allclose(nhwc(sr), np.asarray(sr_j), **MODEL_TOL)
    np.testing.assert_allclose(nhwc(feat), np.asarray(feat_j), **MODEL_TOL)


FEATURE_CHANNELS = {"drct": 180, "grl": 180, "nafnet": 64, "mamba": 180}


def _fusion_inputs(rng, h, w, s=4):
    lr = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    imgs = {k: rng.uniform(0, 1, (1, h * s, w * s, 3)).astype(np.float32)
            for k in FEATURE_CHANNELS}
    feats = {k: rng.normal(size=(1, h, w, c)).astype(np.float32)
             for k, c in FEATURE_CHANNELS.items()}
    return lr, imgs, feats


def test_gated_fusion_matches_jax(monkeypatch):
    """The 7-phase fusion net with FREQFUSION_TOKEN_ATTN=1 in both
    packages: phases 3 and 4 through the token attention kernel."""
    _gates_on(monkeypatch)
    lr, imgs, feats = _fusion_inputs(np.random.default_rng(33), 12, 16)
    model = CompleteEnhancedFusionSR(
        generator=torch.Generator().manual_seed(34))
    variables = convert_fusion(perturb(model, 35))
    want = jax.jit(JaxFusion().apply)(
        variables, jnp.asarray(lr),
        {k: jnp.asarray(v) for k, v in imgs.items()},
        {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        got = model(nchw(lr), {k: nchw(v) for k, v in imgs.items()},
                    {k: nchw(v) for k, v in feats.items()})
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **MODEL_TOL)


def test_gated_pipeline_matches_jax(monkeypatch):
    """The tiny four-expert pipeline of test_torch_pipeline.py with the
    three gates on in both packages."""
    from test_torch_pipeline import CONFIGS, CONVERT, JAX, PORT
    from freqfusion_tpu.models.pipeline import (
        FreqFusionPipeline as JaxPipeline)
    from freqfusion_tpu_torch.models.pipeline import FreqFusionPipeline

    _gates_on(monkeypatch)
    g = torch.Generator().manual_seed(36)
    experts = {n: PORT[n](**cfg, generator=g) for n, cfg in CONFIGS.items()}
    fusion = CompleteEnhancedFusionSR(upscale=4, generator=g)
    params = {n: CONVERT[n](perturb(m, 40 + i))
              for i, (n, m) in enumerate(experts.items())}
    params["fusion"] = convert_fusion(perturb(fusion, 49))
    jp = JaxPipeline.__new__(JaxPipeline)
    jp.scale = 4
    jp.models = {n: JAX[n](**cfg) for n, cfg in CONFIGS.items()}
    jp.fusion = JaxFusion(upscale=4)
    jp.expert_dtype = jp.fusion_dtype = None
    port = FreqFusionPipeline(experts, fusion).eval()

    lr = np.random.default_rng(37).uniform(0, 1, (1, 16, 16, 3)).astype(
        np.float32)
    want = jax.jit(jp._forward_full)(params, jnp.asarray(lr))
    with torch.no_grad():
        got = port(nchw(lr))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **MODEL_TOL)


def _init_shapes(name):
    if name == "fusion":
        lr, imgs, feats = _fusion_inputs(np.random.default_rng(0), 12, 16)
        return (CompleteEnhancedFusionSR, {}, convert_fusion,
                from_jax.from_jax_fusion,
                jax.eval_shape(JaxFusion().init, jax.random.PRNGKey(0), lr,
                               imgs, feats))
    cls, jcls, convert, inverse, cfg, (h, w) = EXPERTS[name]
    return (cls, cfg, convert, inverse,
            jax.eval_shape(jcls(**cfg).init, jax.random.PRNGKey(0),
                           jnp.zeros((1, h, w, 3), jnp.float32)))


@pytest.mark.parametrize("name", ["drct", "grl", "fusion"])
def test_gated_param_tree_through_from_jax(name, monkeypatch):
    """The gated JAX modules declare the same parameters (SplitQKV,
    _SplitQKV6 and RawDense handing their raw params to the kernel): the
    init tree traced with the gates on goes through from_jax into the
    port's module, strictly, and back through freqfusion_tpu.convert leaf
    for leaf."""
    _gates_on(monkeypatch)
    cls, cfg, convert, inverse, shapes = _init_shapes(name)
    rng = np.random.default_rng(len(name))
    variables = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    model = cls(**cfg)
    model.load_state_dict(inverse(variables), strict=True)
    back = convert({k: v.numpy() for k, v in model.state_dict().items()})
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf), err_msg=str(path))
