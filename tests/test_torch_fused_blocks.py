"""The byte-floor configuration (FREQFUSION_MLP, _CAB, _NAFBLOCK, _DWCONV):
the port against the JAX package.

Each fused kernel's plain version against the JAX Pallas function in
interpret mode, at shapes that reach ``pl.pallas_call`` and not the JAX
wrapper's XLA fallback (the CAB and NAFBlock wrappers fall back unless
the width forces a tile narrower than the image: see ``_tiles`` and
``pick_bands``). Then each expert and the tiny four-expert pipeline with
the gates on in both packages (the port reads the same variables), and
the gated JAX models' parameter trees through ``convert/from_jax.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from freqfusion_tpu.convert.drct import convert_drct
from freqfusion_tpu.convert.grl import convert_grl
from freqfusion_tpu.convert.mambair import convert_mambair
from freqfusion_tpu.convert.nafnet import convert_nafnet
from freqfusion_tpu.models.drct import DRCT as JaxDRCT
from freqfusion_tpu.models.grl import GRL as JaxGRL
from freqfusion_tpu.models.mambair import MambaIR as JaxMambaIR
from freqfusion_tpu.models.nafnet import NAFNetSR as JaxNAFNetSR
from freqfusion_tpu.ops.pallas_cab import cab_fused as jax_cab_fused
from freqfusion_tpu.ops.pallas_dwconv import dwconv3x3_pallas
from freqfusion_tpu.ops.pallas_mlp import fused_mlp_block as jax_fused_mlp
from freqfusion_tpu.ops.pallas_nafblock import nafblock_fused as jax_nafblock
from freqfusion_tpu_torch.convert import from_jax
from freqfusion_tpu_torch.models.drct import DRCT
from freqfusion_tpu_torch.models.grl import GRL
from freqfusion_tpu_torch.models.mambair import MambaIR
from freqfusion_tpu_torch.models.nafnet import NAFNetSR
from freqfusion_tpu_torch.ops.cab import cab_fused
from freqfusion_tpu_torch.ops.dwconv import dwconv3x3
from freqfusion_tpu_torch.ops.mlp import fused_mlp_block
from freqfusion_tpu_torch.ops.nafblock import nafblock_fused

from test_torch_harness import KERNEL_ATOL, MODEL_TOL, nchw, nhwc, perturb

GATES = ("FREQFUSION_MLP", "FREQFUSION_CAB", "FREQFUSION_NAFBLOCK",
         "FREQFUSION_DWCONV")


def _tree(rng, spec, scale=0.1):
    """numpy tree of normal draws from {name: shape | subtree}."""
    return {k: _tree(rng, v, scale) if isinstance(v, dict)
            else (scale * rng.standard_normal(v)).astype(np.float32)
            for k, v in spec.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("prenorm", [True, False])
def test_fused_mlp_matches_pallas(prenorm):
    """2 x 13 x 18 = 468 rows: the Pallas wrapper pads them to its row
    tile, the port's kernel masks its last tile."""
    rng = np.random.default_rng(0)
    c, ch = 36, 100
    x = rng.standard_normal((2, 13, 18, c)).astype(np.float32)
    w = _tree(rng, {"w1": (c, ch), "b1": (ch,), "w2": (ch, c), "b2": (c,),
                    "lb": (c,)})
    w["ls"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    args = [w[k] for k in ("w1", "b1", "w2", "b2", "ls", "lb")]
    want = jax_fused_mlp(jnp.asarray(x), *map(jnp.asarray, args),
                         prenorm=prenorm, res_scale=0.75, interpret=True)
    got = fused_mlp_block(torch.from_numpy(x), *map(torch.from_numpy, args),
                          prenorm=prenorm, res_scale=0.75)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


def _cab_spec(c, cr, sq):
    def conv(k, cin, cout):
        return {"kernel": (k, k, cin, cout), "bias": (cout,)}
    return {"cab_0": conv(3, c, cr), "cab_2": conv(3, cr, c),
            "ca_1": conv(1, c, c // sq), "ca_3": conv(1, c // sq, c)}


@pytest.mark.parametrize("form", ["grl", "mambair"])
def test_cab_matches_pallas(form):
    """C 180 at 16 x 192: the Pallas tiles come out 8 x 96 (VMEM budget),
    so the grid is 2 x 2 per image with halo bands; batch 2 for the
    per-image pool. GRL's form (cr 4, squeeze 18) plain, MambaIR's (cr 3,
    squeeze 30) with the pre-LN and the skip scale."""
    rng = np.random.default_rng(1)
    cr, sq = (45, 18) if form == "grl" else (60, 30)
    w = _tree(rng, _cab_spec(180, cr, sq), 0.05)
    x = (0.5 * rng.standard_normal((2, 16, 192, 180))).astype(np.float32)
    ln = skip = None
    if form == "mambair":
        ln = {"scale": (1 + 0.1 * rng.standard_normal(180)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(180)).astype(np.float32)}
        skip = (1 + 0.2 * rng.standard_normal(180)).astype(np.float32)
    want = jax_cab_fused(jnp.asarray(x), _jax(w),
                         None if ln is None else _jax(ln),
                         None if skip is None else jnp.asarray(skip),
                         interpret=True)
    got = cab_fused(torch.from_numpy(x), _torch(w),
                    None if ln is None else _torch(ln),
                    None if skip is None else torch.from_numpy(skip))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


def test_nafblock_matches_pallas():
    """C 64 at 16 x 704: the Pallas tiles come out 8 x 176 (VMEM budget),
    a 2 x 4 grid with halo bands; batch 2 for the per-image SCA pool."""
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
        w[n] = {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    w["beta"], w["gamma"] = 4 * w["beta"], 4 * w["gamma"]
    x = rng.uniform(size=(2, 16, 704, c)).astype(np.float32)
    want = jax_nafblock(jnp.asarray(x), _jax(w), interpret=True)
    got = nafblock_fused(torch.from_numpy(x), _torch(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


@pytest.mark.parametrize("shape", [(2, 13, 18, 36), (1, 20, 24, 360)])
def test_dwconv_matches_pallas(shape):
    """13 x 18: one-row tiles and a whole-width band (13 is prime);
    20 x 24 at SS2D's D 360: 5-row tiles."""
    rng = np.random.default_rng(3)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal((3, 3, 1, c)).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    want = dwconv3x3_pallas(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                            interpret=True)
    got = dwconv3x3(*map(torch.from_numpy, (x, k, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


# Each expert with its gates; the JAX side runs the Pallas routes
# (FREQFUSION_PALLAS=1, interpret mode on the CPU) with MambaIR's scan on
# its XLA route, as tests/test_pipeline.py does.
EXPERTS = {
    "drct": (DRCT, JaxDRCT, convert_drct, from_jax.from_jax_drct,
             dict(upscale=4, embed_dim=48, num_layers=1, num_heads=6,
                  window_size=8, gc=8, mlp_ratio=2.0),
             ("FREQFUSION_MLP",), (16, 16)),
    "grl": (GRL, JaxGRL, convert_grl, from_jax.from_jax_grl,
            dict(upscale=4, embed_dim=48, depths=(2,), num_heads_w=3,
                 num_heads_s=3, window_size=8),
            ("FREQFUSION_MLP", "FREQFUSION_CAB"), (13, 18)),
    "nafnet": (NAFNetSR, JaxNAFNetSR, convert_nafnet, from_jax.from_jax_nafnet,
               dict(upscale=4, width=16, middle_blk_num=1,
                    enc_blk_nums=(1, 1), dec_blk_nums=(1, 1)),
               ("FREQFUSION_NAFBLOCK",), (13, 18)),
    "nafnet-dw": (NAFNetSR, JaxNAFNetSR, convert_nafnet,
                  from_jax.from_jax_nafnet,
                  dict(upscale=4, width=16, middle_blk_num=1,
                       enc_blk_nums=(1, 1), dec_blk_nums=(1, 1)),
                  ("FREQFUSION_DWCONV",), (13, 18)),
    "mamba": (MambaIR, JaxMambaIR, convert_mambair, from_jax.from_jax_mamba,
              dict(upscale=4, embed_dim=32, depths=(2,), mlp_ratio=2.0),
              ("FREQFUSION_DWCONV", "FREQFUSION_CAB"), (8, 12)),
}


def _gates_on(monkeypatch, gates):
    for g in GATES:
        monkeypatch.delenv(g, raising=False)
    for g in gates:
        monkeypatch.setenv(g, "1")
    monkeypatch.setenv("FREQFUSION_PALLAS", "1")
    monkeypatch.setenv("FREQFUSION_SCAN", "xla")


@pytest.mark.parametrize("name", list(EXPERTS))
def test_gated_expert_matches_jax(name, monkeypatch):
    cls, jcls, convert, _, cfg, gates, (h, w) = EXPERTS[name]
    _gates_on(monkeypatch, gates)
    rng = np.random.default_rng(len(name))
    x = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    model = cls(**cfg, generator=torch.Generator().manual_seed(len(name)))
    params = convert(perturb(model, 7))
    sr_j, feat_j = jax.jit(jcls(**cfg).apply)(params, jnp.asarray(x))
    with torch.no_grad():
        sr, feat = model(nchw(x))
    np.testing.assert_allclose(nhwc(sr), np.asarray(sr_j), **MODEL_TOL)
    np.testing.assert_allclose(nhwc(feat), np.asarray(feat_j), **MODEL_TOL)


@pytest.mark.parametrize("name", ["drct", "grl", "nafnet", "mamba"])
def test_gated_param_tree_through_from_jax(name, monkeypatch):
    """The gated JAX models declare their parameters through the
    param-only stand-ins (models/param_decl.py): their init tree (shapes
    traced with the gates on, values drawn) goes through from_jax into the
    port's module, strictly, and back through freqfusion_tpu.convert leaf
    for leaf."""
    cls, jcls, convert, inverse, cfg, gates, (h, w) = EXPERTS[name]
    _gates_on(monkeypatch, gates)
    shapes = jax.eval_shape(jcls(**cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, h, w, 3), jnp.float32))
    rng = np.random.default_rng(len(name))
    variables = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = inverse(variables)
    model = cls(**cfg)
    model.load_state_dict(sd, strict=True)
    back = convert({k: v.numpy() for k, v in model.state_dict().items()})
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf), err_msg=str(path))


def test_gated_pipeline_matches_jax(monkeypatch):
    """The tiny four-expert pipeline of test_torch_pipeline.py with all
    four gates on in both packages."""
    from test_torch_pipeline import CONFIGS, CONVERT, JAX, PORT
    from freqfusion_tpu.convert.fusion import convert_fusion
    from freqfusion_tpu.models.fusion.fusion_v2 import (
        CompleteEnhancedFusionSR as JaxFusion)
    from freqfusion_tpu.models.pipeline import (
        FreqFusionPipeline as JaxPipeline)
    from freqfusion_tpu_torch.models.fusion.fusion_v2 import (
        CompleteEnhancedFusionSR)
    from freqfusion_tpu_torch.models.pipeline import FreqFusionPipeline

    _gates_on(monkeypatch, GATES)
    g = torch.Generator().manual_seed(0)
    experts = {n: PORT[n](**cfg, generator=g) for n, cfg in CONFIGS.items()}
    fusion = CompleteEnhancedFusionSR(upscale=4, generator=g)
    params = {n: CONVERT[n](perturb(m, 20 + i))
              for i, (n, m) in enumerate(experts.items())}
    params["fusion"] = convert_fusion(perturb(fusion, 29))
    jp = JaxPipeline.__new__(JaxPipeline)
    jp.scale = 4
    jp.models = {n: JAX[n](**cfg) for n, cfg in CONFIGS.items()}
    jp.fusion = JaxFusion(upscale=4)
    jp.expert_dtype = jp.fusion_dtype = None
    port = FreqFusionPipeline(experts, fusion).eval()

    lr = np.random.default_rng(3).uniform(0, 1, (1, 16, 16, 3)).astype(
        np.float32)
    want = jax.jit(jp._forward_full)(params, jnp.asarray(lr))
    with torch.no_grad():
        got = port(nchw(lr))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **MODEL_TOL)
