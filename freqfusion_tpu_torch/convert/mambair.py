"""MambaIR geometry from a checkpoint's tensor shapes.

The port's copy of ``freqfusion_tpu/convert/mambair.py:sniff_mambair_config``
(see ``convert/drct.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

from .drct import upscale_of

__all__ = ["sniff_mambair_config"]


def sniff_mambair_config(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """``models.mambair.MambaIR`` keyword arguments from the shapes of the
    tensors of `sd`. d_state comes from A_logs [4 d_inner, d_state], the
    expansion (``mlp_ratio``) from d_inner over embed_dim; dt_rank is
    derived from embed_dim, not stored."""
    embed_dim = int(sd["conv_first.weight"].shape[0])
    layer_ids = sorted({int(k.split(".")[1]) for k in sd
                        if k.startswith("layers.")})
    depths = []
    for i in layer_ids:
        blocks = {int(k.split(".")[4]) for k in sd
                  if k.startswith(f"layers.{i}.residual_group.blocks.")}
        depths.append(1 + max(blocks))
    a_logs = sd["layers.0.residual_group.blocks.0.self_attention.A_logs"]
    return {
        "embed_dim": embed_dim,
        "depths": tuple(depths),
        "d_state": int(a_logs.shape[1]),
        "mlp_ratio": (int(a_logs.shape[0]) // 4) / embed_dim,
        "num_feat": int(sd["conv_before_upsample.0.weight"].shape[0]),
        "upscale": upscale_of(sd),
    }
