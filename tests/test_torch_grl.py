"""GRL: the port against the JAX model on the same weights.

depths (2,) covers a shifted H-stripe block and an unshifted W-stripe
block; 13x18 exercises GRL's own reflect pad to the window and its crop.
On the CPU the port runs the mixed-attention kernel's plain version and
JAX its einsum route."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from freqfusion_tpu.convert.grl import convert_grl
from freqfusion_tpu.models.grl import GRL as JaxGRL
from freqfusion_tpu_torch.models.grl import GRL

from test_torch_harness import MODEL_TOL, nchw, nhwc, perturb

SMALL = dict(upscale=4, embed_dim=48, depths=(2,), num_heads_w=3,
             num_heads_s=3, window_size=8)


def test_grl_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (1, 13, 18, 3)).astype(np.float32)
    model = GRL(**SMALL, generator=torch.Generator().manual_seed(2))
    params = convert_grl(perturb(model, 3))
    sr_j, feat_j = jax.jit(JaxGRL(**SMALL).apply)(params, jnp.asarray(x))

    with torch.no_grad():
        sr, feat = model(nchw(x))
    assert sr.shape == (1, 3, 52, 72) and feat.shape == (1, 48, 13, 18)
    np.testing.assert_allclose(nhwc(sr), np.asarray(sr_j), **MODEL_TOL)
    np.testing.assert_allclose(nhwc(feat), np.asarray(feat_j), **MODEL_TOL)
