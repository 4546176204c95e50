"""Per-pixel token attention (the fusion net's band and expert attention),
with its plain version.

Counterpart of ``freqfusion_tpu/ops/pallas_token_attention.py``: torch
``nn.MultiheadAttention`` in eval over a short token axis (T <= 16),
independently at every pixel, in- and out-projections included and the
residual left to the caller. The weights come in the JAX wrapper's
[in, out] layout (``in_proj_w`` [E, 3E], ``out_w`` [E, E]); the port's
``TokenMultiheadAttention`` holds torch's ``in_proj_weight`` [3E, E] and
``out_proj.weight`` [E, E] and transposes them at the call. A CPU tensor
goes to the plain version; a CUDA tensor goes to ``csrc/token_attention.cu``
or the call raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda

__all__ = ["token_attention", "token_attention_reference"]


def token_attention_reference(x: torch.Tensor, in_proj_w: torch.Tensor,
                              in_proj_b: torch.Tensor, out_w: torch.Tensor,
                              out_b: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """Plain PyTorch: packed projection, per-head softmax attention over
    T, output projection."""
    e = x.shape[-1]
    hd = e // num_heads
    q, k, v = F.linear(x, in_proj_w.t(), in_proj_b).chunk(3, dim=-1)
    q, k, v = (t.reshape(*t.shape[:-1], num_heads, hd) for t in (q, k, v))
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) / hd ** 0.5
    out = torch.einsum("...hqk,...khd->...qhd", logits.softmax(-1), v)
    return F.linear(out.reshape(x.shape), out_w.t(), out_b)


def token_attention(x: torch.Tensor, in_proj_w: torch.Tensor,
                    in_proj_b: torch.Tensor, out_w: torch.Tensor,
                    out_b: torch.Tensor, num_heads: int) -> torch.Tensor:
    """x [P, T, E]; in_proj_w [E, 3E] (q | k | v columns), in_proj_b [3E];
    out_w [E, E] ([in, out]), out_b [E]. Returns out_proj(MHA(x)) before
    the residual, [P, T, E]."""
    p, t, e = x.shape
    if x.device.type == "cpu":
        return token_attention_reference(x, in_proj_w, in_proj_b, out_w,
                                         out_b, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"token_attention: unsupported device {x.device}")
    if not 1 <= t <= 16 or e % num_heads or e % 4 or e > 160 or p < 1:
        raise ValueError(f"token_attention: T={t} must be 1..16, E={e} at "
                         f"most 160 and a multiple of 4 and of heads="
                         f"{num_heads}, P={p} positive")
    dev = x.device
    cuda.require(x, "x", (p, t, e), dev)
    cuda.require(in_proj_w, "in_proj_w", (e, 3 * e), dev)
    cuda.require(in_proj_b, "in_proj_b", (3 * e,), dev)
    cuda.require(out_w, "out_w", (e, e), dev)
    cuda.require(out_b, "out_b", (e,), dev)
    out = torch.empty_like(x)
    err = cuda.library().ff_token_attention(
        *(cuda.ptr(a) for a in (x, in_proj_w, in_proj_b, out_w, out_b, out)),
        p, t, e, num_heads, cuda.stream(x))
    cuda.check(err, "token_attention")
    cuda.launch_counts["token_attention"] += 1
    return out
