"""Small LR images: the port's reflect padding (``ops/pad.py``) against
numpy's for any pad, and the port's pipeline against the JAX pipeline on
LR sides shorter than the pipeline's pad to 16, the fusion net's DCT
block pad to 8 and its db4 DWT pad of 7."""

import numpy as np
import pytest
import torch

from freqfusion_tpu_torch.ops.pad import pad_reflect

from test_torch_pipeline import _compare, pipelines  # noqa: F401 (fixture)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 4), (2, 3), (5, 7)])
def test_pad_reflect_matches_numpy(h, w):
    """Every pad from 0 to three times the side, on each edge: exact."""
    x = np.random.default_rng(h * 10 + w).normal(size=(2, 3, h, w)).astype(
        np.float32)
    t = torch.from_numpy(x)
    for top, bottom in ((a, b) for a in range(3 * h + 1)
                        for b in (0, 3 * h - a)):
        for left, right in ((a, 3 * w - a) for a in range(3 * w + 1)):
            want = np.pad(x, ((0, 0), (0, 0), (top, bottom), (left, right)),
                          mode="reflect")
            np.testing.assert_array_equal(
                pad_reflect(t, top, bottom, left, right).numpy(), want)


@pytest.mark.parametrize("h,w", [(8, 12), (5, 5), (1, 20)])
def test_pipeline_small_lr_matches_jax(pipelines, h, w):  # noqa: F811
    """Within MODEL_TOL (``_compare``), on the module fixture of
    test_torch_pipeline.py."""
    jp, params, port = pipelines
    lr = np.random.default_rng(h * 100 + w).uniform(0, 1, (1, h, w, 3)
                                                    ).astype(np.float32)
    _compare(jp, params, port, lr)
