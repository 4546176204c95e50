"""MambaIR: the port against the JAX model on the same weights.

The JAX model on the CPU takes its exact XLA scan route (flip + chunked
scan per direction); the port runs the chain-layout scan's plain version
with the reverse directions scanned in place."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from freqfusion_tpu.convert.mambair import convert_mambair
from freqfusion_tpu.models.mambair import MambaIR as JaxMambaIR
from freqfusion_tpu_torch.models.mambair import MambaIR

from test_torch_harness import MODEL_TOL, nchw, nhwc, perturb

SMALL = dict(upscale=4, embed_dim=32, depths=(2,), mlp_ratio=2.0)


def test_mambair_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (1, 8, 12, 3)).astype(np.float32)
    model = MambaIR(**SMALL, generator=torch.Generator().manual_seed(4))
    params = convert_mambair(perturb(model, 5))
    sr_j, feat_j = jax.jit(JaxMambaIR(**SMALL, scan_chunk=32).apply)(
        params, jnp.asarray(x))

    with torch.no_grad():
        sr, feat = model(nchw(x))
    np.testing.assert_allclose(nhwc(sr), np.asarray(sr_j), **MODEL_TOL)
    np.testing.assert_allclose(nhwc(feat), np.asarray(feat_j), **MODEL_TOL)
