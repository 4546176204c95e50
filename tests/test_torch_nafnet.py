"""NAFNet-SR: the port against the JAX model on the same weights."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from freqfusion_tpu.convert.nafnet import convert_nafnet
from freqfusion_tpu.models.nafnet import NAFNetSR as JaxNAFNetSR
from freqfusion_tpu_torch.models.nafnet import NAFNetSR

from test_torch_harness import MODEL_TOL, nchw, nhwc, perturb

SMALL = dict(upscale=4, width=16, middle_blk_num=2, enc_blk_nums=(1, 1),
             dec_blk_nums=(1, 1))


def test_nafnet_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (1, 13, 18, 3)).astype(np.float32)
    model = NAFNetSR(**SMALL, generator=torch.Generator().manual_seed(0))
    params = convert_nafnet(perturb(model, 1))
    sr_j, feat_j = jax.jit(JaxNAFNetSR(**SMALL).apply)(params, jnp.asarray(x))

    with torch.no_grad():
        sr, feat = model(nchw(x))
    assert feat.shape == (1, 16, 52, 72)          # HR-resolution feature
    np.testing.assert_allclose(nhwc(sr), np.asarray(sr_j), **MODEL_TOL)
    np.testing.assert_allclose(nhwc(feat), np.asarray(feat_j), **MODEL_TOL)
