"""The fusion net in bf16 (the pipeline's ``fusion_dtype``, the JAX
package's bench mode): the port against the JAX package.

- The bf16 plain versions of the fusion-eval kernels (the LKABlock #18,
  hierarchical stage 3 #19, the edge refine #20 and fuse #21) against the
  Pallas kernels in interpret mode on the same bf16 operands, at
  tests/test_torch_fusion_eval.py's 24 x 128 shapes (each test counts the
  one ``pl.pallas_call`` it traced), within two bf16 ulps of each element,
  the ulp taken at no less than 1/16 of the output's largest magnitude
  (tests/test_torch_bf16.py's BF16_ULPS: the same rounding points, fp32
  sums in another order); the LKABlock's within two ulps of the output's
  largest magnitude (tests/test_torch_bf16_fused.py's ``_check_top``, see
  its test).
- The fusion net cast to bf16 against JAX's on the same weights cast with
  ``astype(bfloat16)``, with the fusion-eval gates off and on in both
  packages, and against its own fp32 output: PSNR >= 45 dB each
  (tests/test_bf16_quality.py's floor).
- The tiny four-expert pipeline with ``expert_dtype`` and ``fusion_dtype``
  bf16 against JAX's ``FreqFusionPipeline`` with both bf16: >= 45 dB.
- The fusion net's parameters and BN statistics as ``fusion_dtype`` casts
  them, taken through freqfusion_tpu.convert, bit-equal to JAX's tree after
  ``astype(bfloat16)``.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from freqfusion_tpu.convert.fusion import convert_fusion
from freqfusion_tpu.models.fusion.fusion_v2 import (
    CompleteEnhancedFusionSR as JaxFusion)
from freqfusion_tpu.ops.pallas_edge import edge_fuse_fused as jax_edge_fuse
from freqfusion_tpu.ops.pallas_edge import (
    edge_refine_fused as jax_edge_refine)
from freqfusion_tpu.ops.pallas_hier import hier_stage3_fused as jax_hier
from freqfusion_tpu.ops.pallas_lka import lka_block_fused as jax_lka
from freqfusion_tpu_torch.models.fusion.fusion_v2 import (
    CompleteEnhancedFusionSR)
from freqfusion_tpu_torch.models.pipeline import FreqFusionPipeline
from freqfusion_tpu_torch.ops.edge import edge_fuse_fused, edge_refine_fused
from freqfusion_tpu_torch.ops.hier import hier_stage3_fused
from freqfusion_tpu_torch.ops.lka import lka_block_fused

from test_torch_bf16 import PSNR_FLOOR, _assert_bf16_close, _psnr, _tree_bf16
from test_torch_bf16_fused import _check_top
from test_torch_fusion_eval import (  # noqa: F401 (pallas_calls: fixture)
    FEATURE_CHANNELS, _bn, _conv, _gates_on, _refine_spec, _tree,
    pallas_calls)
from test_torch_harness import nchw, nhwc, perturb
from test_torch_pipeline import pipelines  # noqa: F401 (fixture)

BF = jnp.bfloat16


def _both_bf16(tree):
    """A numpy tree rounded to bf16 for both packages (the same
    round-to-nearest-even)."""
    return (jax.tree_util.tree_map(lambda a: jnp.asarray(a, BF), tree),
            jax.tree_util.tree_map(
                lambda a: torch.from_numpy(a).to(torch.bfloat16), tree))


def _pair(a):
    return jnp.asarray(a, BF), torch.from_numpy(a).to(torch.bfloat16)


def _close(got, want):
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got.float().numpy(), want.astype(jnp.float32))


@pytest.mark.parametrize("c,batch", [(64, 1), (128, 2)])
def test_lka_bf16_matches_pallas(c, batch, pallas_calls):
    """Phase 3's C 64 and phase 4's C 128 (batch 2), BN statistics away
    from 0 and 1: the affines from the bf16 statistics in fp32, the taps in
    fp32, the three products on bf16 operands. Held to two ulps of the
    output's largest magnitude: the block rounds three intermediates (a,
    BN2(x1), the hidden), and a one-ulp flip of a hidden unit (up to ~16
    here) moves a small output through F2 and scale2 by ~3 of its ulps;
    the same arithmetic in fp32 and in fp64 differs by 0.031 at C 64 (the
    output's largest magnitude 15.8)."""
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
    jt, pt = _both_bf16(tree)
    jx, px = _pair(rng.standard_normal((batch, 24, 128, c)).astype(
        np.float32))
    want = jax_lka(jx, jt, interpret=True)
    assert len(pallas_calls) == 1
    _check_top(lka_block_fused(px, pt), want)


def test_hier_bf16_matches_pallas(pallas_calls):
    """Stage 3 + to_rgb at HR 24 x 128, 76 channels in."""
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
    jt, pt = _both_bf16(_tree(rng, spec, 1.0))
    jx, px = _pair(rng.uniform(0, 1, (1, 24, 128, 76)).astype(np.float32))
    want = jax_hier(jx, jt, interpret=True)
    assert len(pallas_calls) == 1
    _close(hier_stage3_fused(px, pt), want)


def test_edge_refine_bf16_matches_pallas(pallas_calls):
    """One EdgeRefineBlock over a 24 x 128 level, batch 2."""
    rng = np.random.default_rng(20)
    jt, pt = _both_bf16(_tree(rng, _refine_spec(), 1.0))
    jx, px = _pair((0.3 * rng.standard_normal((2, 24, 128, 3))).astype(
        np.float32))
    want = jax_edge_refine(jx, jt, interpret=True)
    assert len(pallas_calls) == 1
    _close(edge_refine_fused(px, pt), want)


def test_edge_fuse_bf16_matches_pallas(pallas_calls):
    """Weighted concat, fusion, gate and clip at HR 24 x 128: the level
    weights scale the bf16 levels before the fusion conv rounds them."""
    rng = np.random.default_rng(21)
    spec = {"fusion_0": _conv(3, 96, 32), "fusion_2": _conv(3, 32, 3),
            "edge_gate_0": _conv(3, 6, 16), "edge_gate_2": _conv(3, 16, 1)}
    jt, pt = _both_bf16(_tree(rng, spec, 1.0))
    arrays = [rng.uniform(0, 1, (1, 24, 128, 3)).astype(np.float32)]
    arrays += [rng.standard_normal((1, 24, 128, 32)).astype(np.float32)
               for _ in range(3)]
    arrays += [np.asarray([0.5, 0.3, 0.2], np.float32),
               np.asarray(0.4, np.float32)]
    pairs = [_pair(a) for a in arrays]
    want = jax_edge_fuse(*(j for j, _ in pairs), jt, interpret=True)
    assert len(pallas_calls) == 1
    _close(edge_fuse_fused(*(p for _, p in pairs), pt), want)


@pytest.fixture(scope="module")
def fusion_inputs():
    """tests/test_torch_fusion.py's fusion net (seed 6, LR 12 x 16), its
    weights as JAX variables, and the inputs."""
    rng = np.random.default_rng(6)
    h, w, s = 12, 16, 4
    lr = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    imgs = {k: rng.uniform(0, 1, (1, h * s, w * s, 3)).astype(np.float32)
            for k in FEATURE_CHANNELS}
    feats = {k: rng.normal(size=(1, h, w, c)).astype(np.float32)
             for k, c in FEATURE_CHANNELS.items()}
    model = CompleteEnhancedFusionSR(
        generator=torch.Generator().manual_seed(6))
    return model, convert_fusion(perturb(model, 7)), lr, imgs, feats


def _floating_bf16(tree):
    """The JAX pipeline's fusion_dtype cast: floating leaves to bf16."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(BF)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


@pytest.mark.parametrize("gated", [False, True])
def test_fusion_bf16_matches_jax(fusion_inputs, gated, monkeypatch):
    """The port's fusion net cast to bf16, on bf16 inputs, against JAX's
    on the astype(bfloat16) tree (gates off, or the three fusion-eval gates
    on in both packages: at this size the JAX routes take their XLA
    fallbacks, the port its bf16 plain versions), and against its own
    fp32 output: PSNR >= 45 dB each (JAX's own bf16 output lies ~52 dB
    from its fp32 one on these weights)."""
    if gated:
        _gates_on(monkeypatch)
    model, variables, lr, imgs, feats = fusion_inputs
    want = jax.jit(JaxFusion().apply)(
        _floating_bf16(variables), jnp.asarray(lr, BF),
        {k: jnp.asarray(v, BF) for k, v in imgs.items()},
        {k: jnp.asarray(v, BF) for k, v in feats.items()})
    bf = torch.bfloat16
    model16 = copy.deepcopy(model).to(bf)
    with torch.no_grad():
        fp32 = model(nchw(lr), {k: nchw(v) for k, v in imgs.items()},
                     {k: nchw(v) for k, v in feats.items()})
        got = model16(nchw(lr).to(bf),
                      {k: nchw(v).to(bf) for k, v in imgs.items()},
                      {k: nchw(v).to(bf) for k, v in feats.items()})
    assert got.dtype == bf
    vs_jax = _psnr(nhwc(got.float()), np.asarray(want.astype(jnp.float32)))
    vs_fp32 = _psnr(got.float(), fp32)
    assert vs_jax >= PSNR_FLOOR and vs_fp32 >= PSNR_FLOOR, (vs_jax, vs_fp32)


def test_tiny_pipeline_all_bf16_matches_jax(pipelines):  # noqa: F811
    """tests/test_torch_pipeline.py's tiny pipeline with expert_dtype and
    fusion_dtype bf16 against JAX's FreqFusionPipeline with both bf16 (its
    _forward_full: the expert outputs cast before the crops, the fallbacks
    and the LR in bf16, the result fp32), PSNR >= 45 dB."""
    jp, params, port = pipelines
    lr = np.random.default_rng(0).uniform(0, 1, (1, 13, 18, 3)).astype(
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
    assert {p.dtype for p in pipe16.parameters()} == {bf}
    with torch.no_grad():
        imgs, feats = pipe16.run_experts(nchw(lr[:, :8, :16]).repeat(
            1, 1, 2, 1))
        got = pipe16(nchw(lr))
    assert {t.dtype for t in (*imgs.values(), *feats.values())} == {bf}
    assert got.dtype == torch.float32
    assert _psnr(nhwc(got), want) >= PSNR_FLOOR


def test_fusion_dtype_cast_bit_equal_to_jax(fusion_inputs):
    """fusion_dtype's cast of the fusion net (parameters and buffers: BN
    running statistics and the scalar parameters too), taken through
    freqfusion_tpu.convert, is bit-equal to JAX's astype(bfloat16) of the
    fp32 tree leaf for leaf; BN's step counter stays an integer."""
    model, variables, *_ = fusion_inputs
    fusion16 = copy.deepcopy(model)
    FreqFusionPipeline({}, fusion16, fusion_dtype=torch.bfloat16)
    sd = fusion16.state_dict()
    assert {v.dtype for k, v in sd.items()
            if not k.endswith("num_batches_tracked")} == {torch.bfloat16}
    assert all(v.dtype == torch.int64 for k, v in sd.items()
               if k.endswith("num_batches_tracked"))
    got = convert_fusion({k: v.float().numpy() if v.is_floating_point()
                          else v.numpy() for k, v in sd.items()})
    want = _floating_bf16(variables)
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    flat_want, tree_want = jax.tree_util.tree_flatten(want)
    assert tree_got == tree_want
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w.astype(jnp.float32)))
