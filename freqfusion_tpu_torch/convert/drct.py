"""DRCT geometry from a checkpoint's tensor shapes.

The port's copy of ``freqfusion_tpu/convert/drct.py:sniff_drct_config``:
the port keeps the reference's state-dict names, so a checkpoint loads
by name once the model is built at the geometry it was trained with.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

__all__ = ["sniff_drct_config"]


def upscale_of(sd: Mapping[str, Any]) -> int:
    """The product of the upsample convs' pixel-shuffle factors, each read
    from its output/input channel ratio (4C -> x2, 9C -> x3), so an x3
    checkpoint (one 9C conv) is not read as x2."""
    upscale = 1
    for k in sorted(sd):
        if k.startswith("upsample.") and k.endswith(".weight"):
            w = sd[k]
            upscale *= int(round((w.shape[0] / w.shape[1]) ** 0.5))
    return upscale


def sniff_drct_config(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """``models.drct.DRCT`` keyword arguments from the shapes of the
    tensors of `sd` (torch tensors or numpy arrays): the official DRCT-L
    release's mlp_ratio 2 as well as the reference's 4."""
    embed_dim = int(sd["conv_first.weight"].shape[0])
    num_layers = 1 + max(int(k.split(".")[1]) for k in sd
                         if k.startswith("layers."))
    table = sd["layers.0.swin1.attn.relative_position_bias_table"]
    window_size = (int(round(table.shape[0] ** 0.5)) + 1) // 2
    return {
        "embed_dim": embed_dim,
        "num_layers": num_layers,
        "num_heads": int(table.shape[1]),
        "window_size": window_size,
        "gc": int(sd["layers.0.adjust1.weight"].shape[0]),
        "mlp_ratio": int(sd["layers.0.swin1.mlp.fc1.weight"].shape[0])
        / embed_dim,
        "num_feat": int(sd["conv_before_upsample.0.weight"].shape[0]),
        "upscale": upscale_of(sd),
    }
