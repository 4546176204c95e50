"""The 7-phase fusion net: the port against the JAX model (eval, BN with
running statistics) on the same weights."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from freqfusion_tpu.convert.fusion import convert_fusion
from freqfusion_tpu.models.fusion.fusion_v2 import (
    CompleteEnhancedFusionSR as JaxFusion)
from freqfusion_tpu_torch.models.fusion.fusion_v2 import (
    CompleteEnhancedFusionSR)

from test_torch_harness import MODEL_TOL, nchw, nhwc, perturb

FEATURE_CHANNELS = {"drct": 180, "grl": 180, "nafnet": 64, "mamba": 180}


def test_fusion_matches_jax():
    rng = np.random.default_rng(6)
    h, w, s = 12, 16, 4
    lr = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    imgs = {k: rng.uniform(0, 1, (1, h * s, w * s, 3)).astype(np.float32)
            for k in FEATURE_CHANNELS}
    feats = {k: rng.normal(size=(1, h, w, c)).astype(np.float32)
             for k, c in FEATURE_CHANNELS.items()}
    model = CompleteEnhancedFusionSR(
        generator=torch.Generator().manual_seed(6))
    variables = convert_fusion(perturb(model, 7))
    want = jax.jit(JaxFusion().apply)(
        variables, jnp.asarray(lr), {k: jnp.asarray(v) for k, v in imgs.items()},
        {k: jnp.asarray(v) for k, v in feats.items()})

    with torch.no_grad():
        got = model(nchw(lr), {k: nchw(v) for k, v in imgs.items()},
                    {k: nchw(v) for k, v in feats.items()})
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **MODEL_TOL)
