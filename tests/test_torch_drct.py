"""DRCT: the port against the JAX model on the same weights.

embed 48 / 6 heads / gc 8 gives dense-block widths 48..80 with 6, 4, 2,
6 and 4 heads (head dims 8, 14, 32, 12, 20), shifted and unshifted
windows, through the window-attention kernel's plain version."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from freqfusion_tpu.convert.drct import convert_drct
from freqfusion_tpu.models.drct import DRCT as JaxDRCT
from freqfusion_tpu_torch.models.drct import DRCT

from test_torch_harness import MODEL_TOL, nchw, nhwc, perturb

SMALL = dict(upscale=4, embed_dim=48, num_layers=2, num_heads=6,
             window_size=8, gc=8, mlp_ratio=2.0)


def test_drct_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (1, 16, 24, 3)).astype(np.float32)
    model = DRCT(**SMALL, generator=torch.Generator().manual_seed(1))
    params = convert_drct(perturb(model, 2))
    sr_j, feat_j = jax.jit(JaxDRCT(**SMALL).apply)(params, jnp.asarray(x))

    with torch.no_grad():
        sr, feat = model(nchw(x))
    np.testing.assert_allclose(nhwc(sr), np.asarray(sr_j), **MODEL_TOL)
    np.testing.assert_allclose(nhwc(feat), np.asarray(feat_j), **MODEL_TOL)
