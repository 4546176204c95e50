"""The fusion-eval configuration (FREQFUSION_LKA, _HIER, _EDGE): the port
against the JAX package.

Each kernel's plain version against the JAX Pallas function in interpret
mode, at 24 x 128: the JAX wrappers fall back to XLA unless ``pick_bands``
gives a tile narrower than the image, which its width cap of 64 does only
for images wider than 64, so each test counts the ``pl.pallas_call``s it
traced. Then each gated module (LKABlock at both widths, the hierarchical
fusion, the edge refinement at HR 96 x 512, where all three levels reach
the kernels), the fusion net and the tiny four-expert pipeline with the
gates on in both packages (the port reads the same variables), and the
gated fusion net's parameter tree through ``convert/from_jax.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from freqfusion_tpu.convert.fusion import convert_fusion
from freqfusion_tpu.models.fusion.edge import (
    LaplacianPyramidRefinement as JaxEdge)
from freqfusion_tpu.models.fusion.fusion_v2 import (
    CompleteEnhancedFusionSR as JaxFusion)
from freqfusion_tpu.models.fusion.hierarchical import (
    HierarchicalMultiResolutionFusion as JaxHier)
from freqfusion_tpu.models.fusion.lka import LKABlock as JaxLKABlock
from freqfusion_tpu.ops.pallas_edge import edge_fuse_fused as jax_edge_fuse
from freqfusion_tpu.ops.pallas_edge import (
    edge_refine_fused as jax_edge_refine)
from freqfusion_tpu.ops.pallas_hier import hier_stage3_fused as jax_hier
from freqfusion_tpu.ops.pallas_lka import lka_block_fused as jax_lka
from freqfusion_tpu_torch.convert import from_jax
from freqfusion_tpu_torch.models.fusion.fusion_v2 import (
    CompleteEnhancedFusionSR)
from freqfusion_tpu_torch.ops.edge import edge_fuse_fused, edge_refine_fused
from freqfusion_tpu_torch.ops.hier import hier_stage3_fused
from freqfusion_tpu_torch.ops.lka import lka_block_fused

from test_torch_harness import KERNEL_ATOL, MODEL_TOL, nchw, nhwc, perturb

GATES = ("FREQFUSION_LKA", "FREQFUSION_HIER", "FREQFUSION_EDGE")
FEATURE_CHANNELS = {"drct": 180, "grl": 180, "nafnet": 64, "mamba": 180}


def _gates_on(monkeypatch):
    for g in GATES:
        monkeypatch.setenv(g, "1")
    monkeypatch.setenv("FREQFUSION_PALLAS", "1")
    monkeypatch.setenv("FREQFUSION_SCAN", "xla")


@pytest.fixture
def pallas_calls(monkeypatch):
    """The number of ``pl.pallas_call``s traced, with the four JAX
    functions' jit caches cleared so that every call traces."""
    calls = []
    real = pl.pallas_call

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(pl, "pallas_call", counting)
    for fn in (jax_lka, jax_hier, jax_edge_refine, jax_edge_fuse):
        fn.clear_cache()
    return calls


def _tree(rng, spec, scale):
    """numpy tree from {name: shape | subtree}: normal draws times scale
    (fan-in scaled for 3- and 4-axis kernels); BN variances positive."""
    out = {}
    for k, v in spec.items():
        if isinstance(v, dict):
            out[k] = _tree(rng, v, scale)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, v).astype(np.float32)
        else:
            s = scale / np.sqrt(np.prod(v[:-1])) if len(v) == 4 else scale
            out[k] = np.asarray(s * rng.standard_normal(v), np.float32)
    return out


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


def _conv(k, cin, cout, bias=True):
    spec = {"kernel": (k, k, cin, cout)}
    if bias:
        spec["bias"] = (cout,)
    return spec


def _bn(c):
    return {"scale": (c,), "bias": (c,), "mean": (c,), "var": (c,)}


@pytest.mark.parametrize("c,batch", [(64, 1), (128, 2)])
def test_lka_matches_pallas(c, batch, pallas_calls):
    """Phase 3's C 64 and phase 4's C 128 (batch 2), with BN statistics
    away from 0 and 1 so that the eval-affine folding is exercised."""
    rng = np.random.default_rng(c)
    spec = {"norm1": _bn(c), "norm2": _bn(c),
            "lka": {"local_conv": {"kernel": (5, 5, 1, c)},
                    "h_conv": {"kernel": (1, 21, 1, c)},
                    "v_conv": {"kernel": (21, 1, 1, c)},
                    "pw_conv": {"kernel": (1, 1, c, c)}, "bn": _bn(c)},
            "ffn_0": _conv(1, c, 2 * c), "ffn_2": _conv(1, 2 * c, c),
            "scale1": (), "scale2": ()}
    tree = _tree(rng, spec, 1.0)
    for name in ("norm1", "norm2"):
        tree[name]["scale"] += 1
    tree["lka"]["bn"]["scale"] += 1
    x = rng.standard_normal((batch, 24, 128, c)).astype(np.float32)
    jt, pt = _both(tree)
    want = jax_lka(jnp.asarray(x), jt, interpret=True)
    assert len(pallas_calls) == 1
    got = lka_block_fused(torch.from_numpy(x), pt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


def test_hier_matches_pallas(pallas_calls):
    """Stage 3 + to_rgb at HR 24 x 128, base_channels 64 (76 in)."""
    rng = np.random.default_rng(19)
    spec = {"stage3_conv_0": _conv(3, 76, 64),
            "stage3_conv_2": _conv(3, 64, 32),
            "stage3_gate": {"gate_0": _conv(1, 32, 8),
                            "gate_2": _conv(1, 8, 1)},
            "stage3_res": {"block_0": _conv(3, 32, 32, False),
                           "block_2": _conv(3, 32, 32, False),
                           "scale": ()},
            "rw23": (), "to_rgb_0": _conv(3, 32, 16),
            "to_rgb_2": _conv(3, 16, 3)}
    jt, pt = _both(_tree(rng, spec, 1.0))
    x = rng.uniform(0, 1, (1, 24, 128, 76)).astype(np.float32)
    want = jax_hier(jnp.asarray(x), jt, interpret=True)
    assert len(pallas_calls) == 1
    got = hier_stage3_fused(torch.from_numpy(x), pt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


def _refine_spec(cin=3, f=32):
    return {"proj": _conv(1, cin, f), "conv1": _conv(3, cin, f),
            "conv2": _conv(3, f, f), "conv3": _conv(3, f, f),
            "attn_0": _conv(1, f, f // 4), "attn_2": _conv(3, f // 4, 1)}


def test_edge_refine_matches_pallas(pallas_calls):
    """One EdgeRefineBlock over a 24 x 128 level, batch 2."""
    rng = np.random.default_rng(20)
    jt, pt = _both(_tree(rng, _refine_spec(), 1.0))
    lap = (0.3 * rng.standard_normal((2, 24, 128, 3))).astype(np.float32)
    want = jax_edge_refine(jnp.asarray(lap), jt, interpret=True)
    assert len(pallas_calls) == 1
    got = edge_refine_fused(torch.from_numpy(lap), pt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


def test_edge_fuse_matches_pallas(pallas_calls):
    """Weighted concat, fusion, gate and clip at HR 24 x 128."""
    rng = np.random.default_rng(21)
    spec = {"fusion_0": _conv(3, 96, 32), "fusion_2": _conv(3, 32, 3),
            "edge_gate_0": _conv(3, 6, 16), "edge_gate_2": _conv(3, 16, 1)}
    jt, pt = _both(_tree(rng, spec, 1.0))
    sr = rng.uniform(0, 1, (1, 24, 128, 3)).astype(np.float32)
    feats = [rng.standard_normal((1, 24, 128, 32)).astype(np.float32)
             for _ in range(3)]
    lw = np.asarray([0.5, 0.3, 0.2], np.float32)
    strength = np.asarray(0.4, np.float32)
    want = jax_edge_fuse(*map(jnp.asarray, (sr, *feats, lw, strength)), jt,
                         interpret=True)
    assert len(pallas_calls) == 1
    got = edge_fuse_fused(*map(torch.from_numpy, (sr, *feats, lw, strength)),
                          pt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


@pytest.fixture(scope="module")
def fusion():
    """The port's fusion net, perturbed (BN running statistics included),
    and its weights as the JAX package's variables."""
    model = CompleteEnhancedFusionSR(
        generator=torch.Generator().manual_seed(50))
    return model, convert_fusion(perturb(model, 51))


def _sub(variables, *path):
    out = {}
    for col, tree in variables.items():
        for k in path:
            tree = tree.get(k, {})
        if tree:
            out[col] = tree
    return out


@pytest.mark.parametrize("where,c", [("cross_band.lka_block", 64),
                                     ("collaborative.lka_global", 128)])
def test_gated_lka_block_module_matches_jax(where, c, fusion, monkeypatch,
                                            pallas_calls):
    """The fusion net's two LKABlocks with FREQFUSION_LKA=1 in both
    packages, at 24 x 128 (batch 2)."""
    _gates_on(monkeypatch)
    model, variables = fusion
    mod = model.get_submodule(where)
    x = np.random.default_rng(c).standard_normal(
        (2, 24, 128, c)).astype(np.float32)
    want = JaxLKABlock(21).apply(_sub(variables, *where.split(".")),
                                 jnp.asarray(x))
    assert len(pallas_calls) == 1
    with torch.no_grad():
        got = mod(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **MODEL_TOL)


def test_gated_hier_module_matches_jax(fusion, monkeypatch, pallas_calls):
    """HierarchicalMultiResolutionFusion with FREQFUSION_HIER=1 in both
    packages, HR 24 x 128: stage 3 through the kernel."""
    _gates_on(monkeypatch)
    model, variables = fusion
    rng = np.random.default_rng(22)
    imgs = {k: rng.uniform(0, 1, (1, 24, 128, 3)).astype(np.float32)
            for k in FEATURE_CHANNELS}
    want = JaxHier(4, 64).apply(_sub(variables, "multi_res"),
                                {k: jnp.asarray(v) for k, v in imgs.items()})
    assert len(pallas_calls) == 1
    with torch.no_grad():
        got = model.multi_res({k: nchw(v) for k, v in imgs.items()})
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **MODEL_TOL)


def test_gated_edge_module_matches_jax(fusion, monkeypatch, pallas_calls):
    """LaplacianPyramidRefinement with FREQFUSION_EDGE=1 in both packages,
    HR 96 x 512: the levels 96 x 512, 48 x 256 and 24 x 128 all reach the
    refine kernel, then the fuse kernel."""
    _gates_on(monkeypatch)
    model, variables = fusion
    sr = np.random.default_rng(23).uniform(0, 1, (1, 96, 512, 3)).astype(
        np.float32)
    want = JaxEdge(3, 32, 0.15).apply(_sub(variables, "edge_enhance"),
                                      jnp.asarray(sr))
    assert len(pallas_calls) == 4
    with torch.no_grad():
        got = model.edge_enhance(nchw(sr))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **MODEL_TOL)


def test_gated_fusion_matches_jax(fusion, monkeypatch):
    """The 7-phase fusion net with the three gates on in both packages, at
    LR 12 x 16 (HR 48 x 64: the JAX routes take their XLA fallbacks there;
    the module tests above reach the kernels)."""
    _gates_on(monkeypatch)
    model, variables = fusion
    rng = np.random.default_rng(24)
    h, w = 12, 16
    lr = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    imgs = {k: rng.uniform(0, 1, (1, 4 * h, 4 * w, 3)).astype(np.float32)
            for k in FEATURE_CHANNELS}
    feats = {k: rng.normal(size=(1, h, w, c)).astype(np.float32)
             for k, c in FEATURE_CHANNELS.items()}
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
    g = torch.Generator().manual_seed(56)
    experts = {n: PORT[n](**cfg, generator=g) for n, cfg in CONFIGS.items()}
    fusion_net = CompleteEnhancedFusionSR(upscale=4, generator=g)
    params = {n: CONVERT[n](perturb(m, 60 + i))
              for i, (n, m) in enumerate(experts.items())}
    params["fusion"] = convert_fusion(perturb(fusion_net, 69))
    jp = JaxPipeline.__new__(JaxPipeline)
    jp.scale = 4
    jp.models = {n: JAX[n](**cfg) for n, cfg in CONFIGS.items()}
    jp.fusion = JaxFusion(upscale=4)
    jp.expert_dtype = jp.fusion_dtype = None
    port = FreqFusionPipeline(experts, fusion_net).eval()

    lr = np.random.default_rng(57).uniform(0, 1, (1, 16, 16, 3)).astype(
        np.float32)
    want = jax.jit(jp._forward_full)(params, jnp.asarray(lr))
    with torch.no_grad():
        got = port(nchw(lr))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **MODEL_TOL)


def test_gated_param_tree_through_from_jax(monkeypatch):
    """The gated JAX fusion net declares its parameters through the
    param-only stand-ins (BNParams, DWKParams, Conv1x1Params,
    Conv3x3Params; models/param_decl.py), BN running statistics included:
    the init tree traced with the three gates on goes through from_jax into
    the port's module, strictly, and back through freqfusion_tpu.convert
    leaf for leaf."""
    _gates_on(monkeypatch)
    rng = np.random.default_rng(0)
    h, w = 12, 16
    lr = jnp.zeros((1, h, w, 3), jnp.float32)
    imgs = {k: jnp.zeros((1, 4 * h, 4 * w, 3), jnp.float32)
            for k in FEATURE_CHANNELS}
    feats = {k: jnp.zeros((1, h, w, c), jnp.float32)
             for k, c in FEATURE_CHANNELS.items()}
    shapes = jax.eval_shape(JaxFusion().init, jax.random.PRNGKey(0), lr,
                            imgs, feats)
    assert "batch_stats" in shapes
    variables = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    model = CompleteEnhancedFusionSR()
    model.load_state_dict(from_jax.from_jax_fusion(variables), strict=True)
    back = convert_fusion({k: v.numpy()
                           for k, v in model.state_dict().items()})
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf), err_msg=str(path))
