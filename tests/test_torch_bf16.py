"""The bf16 expert mode of the port against the JAX package's.

- The bf16 plain versions of window attention (#1), GRL's mixed attention
  (#2) and the chain scan (#3/#4) against the Pallas kernels in interpret
  mode on the same bf16 operands, within two bf16 ulps (BF16_ULPS).
- The tiny experts of tests/test_bf16_quality.py in bf16 against the JAX
  models in bf16 and against their own fp32 outputs (PSNR >= 45 dB, the
  JAX test's floor).
- The tiny pipeline of tests/test_torch_pipeline.py with its experts in
  bf16 against the JAX pipeline with ``expert_dtype=jnp.bfloat16``.
- ``load_pipeline`` under FREQFUSION_EXPERT_DTYPE, the experts' cast
  parameters bit-equal to the JAX tree's ``astype(bfloat16)``, and the
  ``interface/ntire.py`` CLI on the CPU.
"""

import copy
import json

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
from freqfusion_tpu.ops.pallas_attention import (
    fused_grl_mixed_attention_nhwc, fused_window_attention_nhwc)
from freqfusion_tpu.ops.selective_scan import selective_scan_pallas_chain_proj
from freqfusion_tpu_torch.interface import ntire
from freqfusion_tpu_torch.interface.io import _TORCH_FILES, load_pipeline
from freqfusion_tpu_torch.models.drct import DRCT
from freqfusion_tpu_torch.models.grl import GRL
from freqfusion_tpu_torch.models.mambair import MambaIR
from freqfusion_tpu_torch.models.nafnet import NAFNetSR
from freqfusion_tpu_torch.models.pipeline import FreqFusionPipeline
from freqfusion_tpu_torch.ops.attention import (grl_mixed_attention_nhwc,
                                                window_attention_nhwc)
from freqfusion_tpu_torch.ops.selective_scan import selective_scan_chain_proj
from freqfusion_tpu_torch.ops.window_attention import shifted_window_mask
from freqfusion_tpu_torch.utils.image_io import read_image, write_image

from test_torch_harness import PORT, _imports, nchw, nhwc, perturb
from test_torch_pipeline import pipelines  # noqa: F401 (fixture)

BF = jnp.bfloat16
# Kernel plain versions against the Pallas kernels, both in bf16: the same
# rounding points, fp32 sums in another order, so an output may land on
# the neighbouring bf16 value. Two ulps of each element, the ulp taken at
# no less than 1/16 of the output's largest magnitude (an output that is a
# sum of larger terms carries their rounding).
BF16_ULPS = 2
# bf16 against fp32, and the port's bf16 against JAX's bf16: the floor of
# tests/test_bf16_quality.py
PSNR_FLOOR = 45.0


def _bf16_np(a) -> np.ndarray:
    """a rounded to bf16, as fp32 numpy."""
    return np.asarray(jnp.asarray(a, BF).astype(jnp.float32))


def _port(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16)


def _assert_bf16_close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(want), np.abs(want).max() / 16)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    bad = np.abs(got - want) > BF16_ULPS * ulp
    assert not bad.any(), (f"{bad.sum()} of {bad.size} beyond {BF16_ULPS} "
                           f"bf16 ulps; max abs {np.abs(got - want).max()}")


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


@pytest.mark.parametrize("h,w,c,heads,ws,shift", [
    (16, 32, 60, 6, 8, 4),     # shifted, head dim 10
    (16, 16, 106, 2, 16, 0),   # N 256, head dim 53 (odd head offsets)
])
def test_window_attention_bf16_matches_pallas(h, w, c, heads, ws, shift):
    rng = np.random.default_rng(c)
    q, k, v = (_bf16_np(rng.standard_normal((1, h, w, c))) for _ in range(3))
    bias = _bf16_np(0.5 * rng.standard_normal((heads, ws * ws, ws * ws)))
    mask = shifted_window_mask(h, w, ws, shift)
    want = fused_window_attention_nhwc(
        *(jnp.asarray(t, BF) for t in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask), num_heads=heads,
        window_size=ws, interpret=True)
    got = window_attention_nhwc(
        _port(q), _port(k), _port(v), _port(bias),
        None if mask is None else torch.from_numpy(mask), heads, ws)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got.float().numpy(), want.astype(jnp.float32))


def test_window_attention_bf16_rounds_the_mask_like_pallas():
    """A mask of values that bf16 does not hold exactly (the first
    shape above, its compiled program): the JAX wrapper casts it to bf16
    (pallas_attention.py:279), and so does the port."""
    h, w, c, heads, ws = 16, 32, 60, 6, 8
    rng = np.random.default_rng(23)
    q, k, v = (_bf16_np(rng.standard_normal((1, h, w, c))) for _ in range(3))
    bias = _bf16_np(0.5 * rng.standard_normal((heads, ws * ws, ws * ws)))
    mask = rng.uniform(-40, 40, (8, ws * ws, ws * ws)).astype(np.float32)
    assert (_bf16_np(mask) != mask).any()
    want = fused_window_attention_nhwc(
        *(jnp.asarray(t, BF) for t in (q, k, v, bias)), jnp.asarray(mask),
        num_heads=heads, window_size=ws, interpret=True)
    got = window_attention_nhwc(_port(q), _port(k), _port(v), _port(bias),
                                torch.from_numpy(mask), heads, ws)
    _assert_bf16_close(got.float().numpy(), want.astype(jnp.float32))


@pytest.mark.parametrize("c2,shift", [(24, 4), (30, 0)])
def test_grl_mixed_attention_bf16_matches_pallas(c2, shift):
    """bf16 halves and anchor; fp32 scales and biases, as GRL's module
    computes them in bf16 mode."""
    h, w, heads = 16, 24, 3
    rng = np.random.default_rng(c2)
    halves = [_bf16_np(rng.standard_normal((1, h, w, c2))) for _ in range(6)]
    anchor = _bf16_np(rng.standard_normal((1, h // 2, w // 2, c2)))
    scales = [(10 + np.abs(rng.standard_normal((heads, 1, 1)))).astype(
        np.float32) for _ in range(3)]
    biases = [(16 / (1 + np.exp(-rng.standard_normal(s)))).astype(np.float32)
              for s in ((heads, 64, 64), (heads, 16, 64), (heads, 64, 16))]
    mask = shifted_window_mask(h, w, 8, shift)
    want = fused_grl_mixed_attention_nhwc(
        *(jnp.asarray(t, BF) for t in halves + [anchor]),
        *(jnp.asarray(t) for t in scales + biases),
        None if mask is None else jnp.asarray(mask), num_heads_w=heads,
        num_heads_s=heads, window_size=8, interpret=True)
    got = grl_mixed_attention_nhwc(
        *(_port(t) for t in halves + [anchor]),
        *(torch.from_numpy(t) for t in scales + biases),
        None if mask is None else torch.from_numpy(mask), heads, heads, 8)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.bfloat16
        _assert_bf16_close(g.float().numpy(), wnt.astype(jnp.float32))


def test_chain_proj_bf16_matches_pallas():
    """The v6 kernel the JAX model runs in bf16 (chain_proj: dt/B/C kept
    fp32, y rounded to bf16), reverse, at the smallest shape it takes (D a
    multiple of 128, R of 8); one interpret-mode call takes ~7 s."""
    t, r, d, n, dtr = 16, 8, 128, 16, 8
    rng = np.random.default_rng(7)
    xc = _bf16_np(rng.standard_normal((1, t, r, d)))
    xpw = _bf16_np(rng.uniform(-1, 1, (dtr + 2 * n, d)) / np.sqrt(d))
    dtw = _bf16_np(rng.uniform(-1, 1, (d, dtr)) / np.sqrt(dtr))
    A = -np.tile(np.arange(1, n + 1, dtype=np.float32), (d, 1))
    D = _bf16_np(1 + 0.1 * rng.standard_normal(d))
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), d))
    bias = _bf16_np(dt + np.log(-np.expm1(-dt)))
    want = selective_scan_pallas_chain_proj(
        *(jnp.asarray(a, BF) for a in (xc, xpw, dtw)), jnp.asarray(A),
        jnp.asarray(D, BF), jnp.asarray(bias, BF), reverse=True,
        out_dtype=BF, interpret=True)
    got = selective_scan_chain_proj(_port(xc), _port(xpw), _port(dtw),
                                    torch.from_numpy(A), _port(D),
                                    _port(bias), reverse=True)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got.float().numpy(), want.astype(jnp.float32))


# the tiny experts of tests/test_bf16_quality.py
TINY = {
    "drct": (DRCT, JaxDRCT, convert_drct,
             dict(upscale=4, embed_dim=60, num_layers=1, num_heads=6,
                  window_size=8, gc=12)),
    "grl": (GRL, JaxGRL, convert_grl,
            dict(upscale=4, embed_dim=48, depths=(2,), num_heads_w=3,
                 num_heads_s=3, window_size=8)),
    "nafnet": (NAFNetSR, JaxNAFNetSR, convert_nafnet,
               dict(upscale=4, width=16, middle_blk_num=2,
                    enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))),
    "mamba": (MambaIR, JaxMambaIR, convert_mambair,
              dict(upscale=4, embed_dim=60, depths=(2,), d_state=8)),
}


def _tree_bf16(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(BF), tree)


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_expert_bf16(name):
    """The port's expert in bf16 against JAX's in bf16 and against its own
    fp32 output, each PSNR >= 45 dB. The weights are the seeded init moved
    by 0.01 N(0, 1) (the zero-initialised gates exercised): at 0.05 these
    untrained tiny models amplify bf16 rounding to 32-34 dB in the JAX
    package and in the port alike."""
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


def test_tiny_pipeline_bf16_matches_jax(pipelines):  # noqa: F811
    """The experts in bf16, the fusion net in fp32, on the fixture of
    tests/test_torch_pipeline.py: against JAX's pipeline with
    expert_dtype=bf16 and against the port's fp32 output, PSNR >= 45 dB
    each (on a CPU, JAX's own bf16 output lies ~49 dB from its fp32 one on
    these weights, and the port's as far from JAX's bf16 one)."""
    jp, params, port = pipelines
    lr = np.random.default_rng(0).uniform(0, 1, (1, 13, 18, 3)).astype(
        np.float32)
    jp16 = copy.copy(jp)
    jp16.expert_dtype = BF
    params16 = {n: p if n == "fusion" else _tree_bf16(p)
                for n, p in params.items()}
    want = np.asarray(jax.jit(jp16._forward_full)(params16, jnp.asarray(lr)))
    pipe16 = FreqFusionPipeline(copy.deepcopy(dict(port.experts)),
                                port.fusion, port.scale, torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in pipe16.experts.parameters())
    assert all(p.dtype == torch.float32 for p in pipe16.fusion.parameters())
    assert all(p.dtype == torch.float32 for p in port.experts.parameters())
    with torch.no_grad():
        got = pipe16.eval()(nchw(lr))
        fp32 = port(nchw(lr))
    assert got.dtype == torch.float32
    vs_jax, vs_fp32 = _psnr(nhwc(got), want), _psnr(got, fp32)
    assert vs_jax >= PSNR_FLOOR and vs_fp32 >= PSNR_FLOOR, (vs_jax, vs_fp32)


@pytest.fixture(scope="module")
def small_checkpoints(tmp_path_factory):
    """A small DRCT and MambaIR under the reference file names (GRL,
    NAFNet and the fusion net missing: degraded / seeded)."""
    root = tmp_path_factory.mktemp("bf16_models")
    for i, (name, cls, cfg) in enumerate((
            ("drct", DRCT, dict(embed_dim=60, num_layers=1, window_size=8,
                                gc=16, mlp_ratio=2.0)),
            ("mamba", MambaIR, dict(embed_dim=60, depths=(1,))))):
        model = cls(**cfg, generator=torch.Generator().manual_seed(i))
        torch.save({"params": model.state_dict()}, root / _TORCH_FILES[name])
    return root


@pytest.mark.parametrize("value,dtype", [
    ("bf16", torch.bfloat16), ("BFloat16", torch.bfloat16),
    (None, torch.float32), ("fp16", torch.float32)])
def test_load_pipeline_reads_expert_dtype(small_checkpoints, monkeypatch,
                                          value, dtype):
    """As freqfusion_tpu/interface/io.py: "bf16" or "bfloat16" in any case
    casts the experts, anything else (or nothing) leaves fp32; the fusion
    net stays fp32."""
    if value is None:
        monkeypatch.delenv("FREQFUSION_EXPERT_DTYPE", raising=False)
    else:
        monkeypatch.setenv("FREQFUSION_EXPERT_DTYPE", value)
    pipe = load_pipeline(str(small_checkpoints), "cpu", verbose=False)
    assert sorted(pipe.experts) == ["drct", "mamba"]
    assert pipe.expert_dtype == (None if dtype == torch.float32 else dtype)
    assert {p.dtype for p in pipe.experts.parameters()} == {dtype}
    assert {p.dtype for p in pipe.fusion.parameters()} == {torch.float32}
    with torch.no_grad():
        imgs, feats = pipe.run_experts(torch.rand(
            1, 3, 16, 16, generator=torch.Generator().manual_seed(0)))
    for out in (*imgs.values(), *feats.values()):
        assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("name", sorted(TINY))
def test_cast_parameters_bit_equal_to_jax(name):
    """The port's expert cast to bf16 (as the pipeline casts it), taken
    through freqfusion_tpu.convert, is bit-equal to the JAX tree of the
    fp32 weights after ``astype(bfloat16)`` (the JAX pipeline's cast)."""
    cls, _, convert, cfg = TINY[name]
    model = cls(**cfg, generator=torch.Generator().manual_seed(2))
    want = _tree_bf16(convert(perturb(model, 4, scale=0.01)))
    model.to(torch.bfloat16)
    got = convert({k: v.float().numpy() for k, v in
                   model.state_dict().items()})
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    flat_want, tree_want = jax.tree_util.tree_flatten(want)
    assert tree_got == tree_want
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_array_equal(
            np.asarray(g, np.float32), np.asarray(w.astype(jnp.float32)))


def test_ntire_cli_on_cpu(tmp_path, monkeypatch, capsys):
    """test.py's flags, paths, outputs and results.json keys, served on the
    CPU (no checkpoints: bilinear experts and a seeded fusion net); model
    0 is not ported; without --device it takes the card and raises where
    there is none; the CLI imports nothing of the JAX package."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "model_zoo" / "team29_FreqFusionSR").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for split, size in (("valid", (8, 12)), ("test", (12, 8))):
        (tmp_path / split).mkdir()
        write_image(str(tmp_path / split / f"{split}_a.png"),
                    rng.uniform(0, 1, size + (3,)).astype(np.float32))
    results = ntire.main(["--valid_dir", "valid", "--test_dir", "test",
                          "--device", "cpu"])
    assert sorted(results) == ["29_FreqFusionSR_test_ms",
                               "29_FreqFusionSR_valid_ms"]
    assert json.loads((tmp_path / "results.json").read_text()) == results
    for split, size in (("valid", (8, 12)), ("test", (12, 8))):
        out = read_image(str(tmp_path / "results" / "29_FreqFusionSR" / split
                             / f"{split}_a.png"))
        assert out.shape == (4 * size[0], 4 * size[1], 3)
    assert capsys.readouterr().out.count("runtime (Including I/O)") == 2
    with pytest.raises(NotImplementedError, match="not ported"):
        ntire.main(["--test_dir", "test", "--model_id", "0"])
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ntire.main(["--test_dir", "test"])
    path = PORT / "interface" / "ntire.py"
    assert not [m for m in _imports(path)
                if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                       "freqfusion_tpu")]
