"""JAX params -> the port's state dicts, one function per model family.

The inverse of ``freqfusion_tpu/convert/<family>.py`` and of the layout
rules of ``freqfusion_tpu/convert/common.py``: a conv kernel [kh, kw, I, O]
(depthwise [kh, kw, 1, C]) goes back to [O, I, kh, kw], a Dense kernel
[I, O] to [O, I], ``scale`` to ``weight``, BatchNorm ``mean``/``var`` to
``running_mean``/``running_var``. Each function takes the JAX variables
({"params": ..., ["batch_stats": ...]}) as nested dicts of arrays and
returns the port's ``state_dict`` (fp32 tensors), loadable with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

__all__ = ["from_jax_nafnet", "from_jax_drct", "from_jax_grl",
           "from_jax_mamba", "from_jax_fusion"]

_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterable[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_path(parts: Tuple[str, ...]) -> str:
    """JAX module path -> torch dotted path: 'layers_3' -> 'layers.3',
    'encoders_0_1' -> 'encoders.0.1'."""
    return ".".join(re.sub(r"_(\d+)(?=_|$)", r".\1", p) for p in parts)


def _convert(variables: Mapping[str, Any],
             rename: Callable[[str], str]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, value in _flatten(tree):
            w = np.asarray(value, dtype=np.float32)
            module, leaf = _module_path(path[:-1]), path[-1]
            if leaf == "kernel":
                w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
                leaf = "weight"
            else:
                leaf = _LEAF.get(leaf, leaf)
            name = rename(f"{module}.{leaf}" if module else leaf)
            out[name] = torch.from_numpy(np.ascontiguousarray(w))
            if collection == "batch_stats" and leaf == "running_var":
                out[name[:-len("running_var")] + "num_batches_tracked"] = \
                    torch.tensor(0)
    return out


def _sub(rules):
    def rename(name: str) -> str:
        for pat, rep in rules:
            name = re.sub(pat, rep, name)
        return name
    return rename


def from_jax_nafnet(variables) -> Dict[str, torch.Tensor]:
    """NAFNetSR params -> ``models.nafnet.NAFNetSR`` state dict."""
    sd = _convert(variables, _sub([
        (r"^nafnet\.ups\.(\d+)\.weight$", r"nafnet.ups.\1.0.weight"),
        (r"\.sca\.(weight|bias)$", r".sca.1.\1"),
    ]))
    for k in sd:
        if k.endswith((".beta", ".gamma")):
            sd[k] = sd[k].reshape(1, -1, 1, 1)
    return sd


def from_jax_drct(variables) -> Dict[str, torch.Tensor]:
    """DRCT params (unstacked layers) -> ``models.drct.DRCT`` state dict."""
    return _convert(variables, _sub([
        (r"^patch_embed_norm\.", "patch_embed.norm."),
    ]))


def from_jax_grl(variables) -> Dict[str, torch.Tensor]:
    """GRL params (unstacked layers) -> ``models.grl.GRL`` state dict."""
    return _convert(variables, _sub([
        (r"\.attn\.qkv\.", ".attn.qkv.body."),
        (r"\.attn\.anchor\.", ".attn.anchor.body.0.reduction."),
        (r"\.mlp_fc(\d)\.", r".mlp.fc\1."),
        (r"\.conv\.ca\.(\d)\.", r".conv.cab.3.attention.\1."),
        (r"^upsample\.", "upsample.up."),
    ]))


def from_jax_mamba(variables) -> Dict[str, torch.Tensor]:
    """MambaIR params (unstacked layers) -> ``models.mambair.MambaIR``."""
    return _convert(variables, _sub([
        (r"^layers\.(\d+)\.blocks\.", r"layers.\1.residual_group.blocks."),
        (r"\.conv_blk\.ca\.(\d)\.", r".conv_blk.cab.3.attention.\1."),
        (r"\.ln\.(\d)\.", r".ln_\1."),
        (r"^patch_embed_norm\.", "patch_embed.norm."),
    ]))


def from_jax_fusion(variables) -> Dict[str, torch.Tensor]:
    """Fusion-net params + batch_stats -> ``CompleteEnhancedFusionSR``."""
    sd = _convert(variables, _sub([
        (r"^collaborative\.align_(\w+?)\.", r"collaborative.align_layers.\1."),
        (r"(stage\d_res)\.weight$", r"\1.scale"),
        (r"\.edge_refiners\.(\d)\.attn\.(\d)\.",
         r".edge_refiners.\1.attn.conv.\2."),
    ]))
    for k in list(sd):
        if k.endswith("in_proj_weight"):
            sd[k] = sd[k].T.contiguous()
        elif k.endswith("freq_mask_logits"):
            sd[k] = sd[k].permute(0, 3, 1, 2).contiguous()
    return sd
