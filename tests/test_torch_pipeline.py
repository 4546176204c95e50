"""The whole x4 slice: the port's FreqFusionPipeline against the JAX
pipeline (pad 16, four experts, crop, NAFNet feature resize, MambaIR
clamp, fusion) on a 13x18 LR, and with a missing expert."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from freqfusion_tpu.convert.drct import convert_drct
from freqfusion_tpu.convert.fusion import convert_fusion
from freqfusion_tpu.convert.grl import convert_grl
from freqfusion_tpu.convert.mambair import convert_mambair
from freqfusion_tpu.convert.nafnet import convert_nafnet
from freqfusion_tpu.models.drct import DRCT as JaxDRCT
from freqfusion_tpu.models.fusion.fusion_v2 import (
    CompleteEnhancedFusionSR as JaxFusion)
from freqfusion_tpu.models.grl import GRL as JaxGRL
from freqfusion_tpu.models.mambair import MambaIR as JaxMambaIR
from freqfusion_tpu.models.nafnet import NAFNetSR as JaxNAFNetSR
from freqfusion_tpu.models.pipeline import (
    FreqFusionPipeline as JaxPipeline)
from freqfusion_tpu_torch.models.drct import DRCT
from freqfusion_tpu_torch.models.fusion.fusion_v2 import (
    CompleteEnhancedFusionSR)
from freqfusion_tpu_torch.models.grl import GRL
from freqfusion_tpu_torch.models.mambair import MambaIR
from freqfusion_tpu_torch.models.nafnet import NAFNetSR
from freqfusion_tpu_torch.models.pipeline import FreqFusionPipeline

from test_torch_harness import MODEL_TOL, nchw, nhwc, perturb

# the tiny geometry of tests/test_pipeline.py
CONFIGS = {
    "drct": dict(upscale=4, embed_dim=180, num_layers=1, num_heads=6,
                 window_size=8, gc=8),
    "grl": dict(upscale=4, embed_dim=180, depths=(1,), num_heads_w=3,
                num_heads_s=3, window_size=8),
    "nafnet": dict(upscale=4, width=64, middle_blk_num=1, enc_blk_nums=(1,),
                   dec_blk_nums=(1,)),
    "mamba": dict(upscale=4, embed_dim=180, depths=(1,), mlp_ratio=2.0),
}
JAX = {"drct": JaxDRCT, "grl": JaxGRL, "nafnet": JaxNAFNetSR,
       "mamba": JaxMambaIR}
PORT = {"drct": DRCT, "grl": GRL, "nafnet": NAFNetSR, "mamba": MambaIR}
CONVERT = {"drct": convert_drct, "grl": convert_grl,
           "nafnet": convert_nafnet, "mamba": convert_mambair}


@pytest.fixture(scope="module")
def pipelines():
    g = torch.Generator().manual_seed(0)
    experts = {n: PORT[n](**cfg, generator=g) for n, cfg in CONFIGS.items()}
    fusion = CompleteEnhancedFusionSR(upscale=4, generator=g)
    params = {n: CONVERT[n](perturb(m, 10 + i))
              for i, (n, m) in enumerate(experts.items())}
    params["fusion"] = convert_fusion(perturb(fusion, 19))
    jp = JaxPipeline.__new__(JaxPipeline)
    jp.scale = 4
    jp.models = {n: JAX[n](**cfg) for n, cfg in CONFIGS.items()}
    jp.fusion = JaxFusion(upscale=4)
    jp.expert_dtype = jp.fusion_dtype = None
    return jp, params, FreqFusionPipeline(experts, fusion).eval()


def _compare(jp, params, port, lr):
    want = jax.jit(jp._forward_full)(params, jnp.asarray(lr))
    with torch.no_grad():
        got = port(nchw(lr))
    assert got.shape == (1, 3, 4 * lr.shape[1], 4 * lr.shape[2])
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **MODEL_TOL)


def test_pipeline_matches_jax(pipelines):
    jp, params, port = pipelines
    lr = np.random.default_rng(0).uniform(0, 1, (1, 13, 18, 3)).astype(
        np.float32)
    _compare(jp, params, port, lr)


def test_pipeline_missing_expert_matches_jax(pipelines):
    jp, params, port = pipelines
    params = {k: v for k, v in params.items() if k != "mamba"}
    port = FreqFusionPipeline({k: v for k, v in port.experts.items()
                               if k != "mamba"}, port.fusion).eval()
    lr = np.random.default_rng(1).uniform(0, 1, (1, 16, 16, 3)).astype(
        np.float32)
    _compare(jp, params, port, lr)
