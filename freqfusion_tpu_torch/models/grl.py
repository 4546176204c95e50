"""GRL-B expert: window + anchored-stripe mixed attention (body in NHWC).

Counterpart of ``freqfusion_tpu/models/grl.py``: 7 stages (depths
4, 4, 8, 8, 8, 4, 4; embed 180), each block mixing half-channel 8x8 window
cosine attention (shifted on even blocks) with half-channel anchored
stripe attention (2x average-pooled, linearly projected anchors), a CAB
conv branch, and a post-norm MLP. FREQFUSION_CAB=1 and FREQFUSION_MLP=1
route the CAB and the MLP half through ``ops/cab.py`` and ``ops/mlp.py``,
as ``freqfusion_tpu/models/grl.py:340,479`` gate them. Both attention
halves of every block run in one call of
``ops/attention.py:grl_mixed_attention_nhwc``, or, with
FREQFUSION_GRL_QKV=1 (``freqfusion_tpu/models/grl.py:403``), of
``grl_mixed_attention_qkv_nhwc``, which also does the 6-way qkv
projection; GRL-B pins
stripe size == window size (8 x 8) and 4 x 4 anchors, which that call
requires. The 13 reference buffers (tables, indices, masks) are
recomputed from ``ops/grl_tables.py`` and are not in the state dict.
Returns (sr, conv_after_body feature), cropped to the unpadded input.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import (grl_mixed_attention_nhwc,
                             grl_mixed_attention_qkv_nhwc)
from ..ops.cab import cab_fused
from ..ops.grl_tables import (relative_coords_table_all,
                              relative_position_index_simple,
                              window_shift_mask)
from ..ops.mlp import fused_mlp_block
from ..ops.pad import pad_reflect
from ..ops.window_attention import device_table
from .common import (RGB_MEAN, Mlp, conv_nhwc, gate, hwio_view,
                     init_weights, pixel_shuffle_upsampler, to_nchw, to_nhwc)

__all__ = ["GRL"]

_LOGIT_MAX = math.log(1.0 / 0.01)


class AffineTransform(nn.Module):
    """Clamped logit scale and the CPB-MLP continuous position bias."""

    def __init__(self, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1),
                                                   math.log(10.0)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(),
                                     nn.Linear(512, num_heads, bias=False))

    def reset_extra(self, g: torch.Generator) -> None:
        self.logit_scale.fill_(math.log(10.0))

    def scale(self) -> torch.Tensor:
        """[nH, 1, 1] exp(min(logit_scale, log 100)), in fp32 whatever the
        parameter's dtype (the JAX module's numpy clamp bound promotes a
        bf16 logit scale to fp32)."""
        return torch.exp(torch.clamp(self.logit_scale.float(),
                                     max=_LOGIT_MAX))

    def bias(self, table: torch.Tensor, index: torch.Tensor, n1: int,
             n2: int) -> torch.Tensor:
        """[nH, n1, n2] 16 * sigmoid(CPB-MLP(table)[index]), in the
        table's dtype (fp32: flax's Dense promotes bf16 weights to the fp32
        table's dtype)."""
        fc0, fc2 = self.cpb_mlp[0], self.cpb_mlp[2]
        dt = table.dtype
        hid = F.relu(F.linear(table, fc0.weight.to(dt), fc0.bias.to(dt)))
        bt = F.linear(hid, fc2.weight.to(dt)).view(-1, self.num_heads)
        b = bt[index.reshape(-1)].view(n1, n2, -1).permute(2, 0, 1)
        return (16.0 * torch.sigmoid(b)).contiguous()


class _WindowAttn(nn.Module):
    def __init__(self, num_heads: int):
        super().__init__()
        self.attn_transform = AffineTransform(num_heads)


class _StripeAttn(nn.Module):
    def __init__(self, num_heads: int):
        super().__init__()
        self.attn_transform1 = AffineTransform(num_heads)
        self.attn_transform2 = AffineTransform(num_heads)


class _Body(nn.Module):
    """A module holding one Linear as ``body`` (reference QKVProjection)."""

    def __init__(self, body: nn.Module):
        super().__init__()
        self.body = body


class _AnchorLinear(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.reduction = nn.Linear(dim, out)


class MixedAttention(nn.Module):
    def __init__(self, dim: int, num_heads_w: int, num_heads_s: int,
                 window_size: int, window_shift: bool,
                 stripe_size: Tuple[int, int], anchor_down_factor: int):
        super().__init__()
        if tuple(stripe_size) != (window_size, window_size):
            raise ValueError("GRL port supports stripe size == window size "
                             f"only, got {stripe_size} vs {window_size}")
        self.dim, self.nhw, self.nhs = dim, num_heads_w, num_heads_s
        self.ws, self.df = window_size, anchor_down_factor
        self.shift = window_size // 2 if window_shift else 0
        self.qkv = _Body(nn.Linear(dim, 3 * dim))
        self.anchor = _Body(nn.ModuleList([_AnchorLinear(dim, dim // 2)]))
        self.window_attn = _WindowAttn(num_heads_w)
        self.stripe_attn = _StripeAttn(num_heads_s)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, c = x.shape
        c2, ws, df, ss, dev = c // 2, self.ws, self.df, self.shift, x.device
        wq, bq = self.qkv.body.weight, self.qkv.body.bias
        pooled = to_nhwc(F.avg_pool2d(to_nchw(x), 2, 2))
        anchor = self.anchor.body[0].reduction(pooled)
        n, na = ws * ws, (ws // df) ** 2
        mask = device_table(window_shift_mask, h, w, ws, ss, device=dev)
        tw = self.window_attn.attn_transform
        bias_w = tw.bias(
            device_table(relative_coords_table_all, (ws, ws), 1, device=dev),
            device_table(relative_position_index_simple, (ws, ws), 1, True,
                         device=dev), n, n)
        t1 = self.stripe_attn.attn_transform1
        t2 = self.stripe_attn.attn_transform2
        table_s = device_table(relative_coords_table_all, (ws, ws), df,
                               device=dev)
        bias_s1 = t1.bias(table_s, device_table(
            relative_position_index_simple, (ws, ws), df, False, device=dev),
            na, n)
        bias_s2 = t2.bias(table_s, device_table(
            relative_position_index_simple, (ws, ws), df, True, device=dev),
            n, na)
        tables = (tw.scale(), t1.scale(), t2.scale(), bias_w, bias_s1,
                  bias_s2, mask, self.nhw, self.nhs, ws, df)
        if gate("FREQFUSION_GRL_QKV"):
            # 6-way qkv projection inside the kernel: the window half
            # projects from the rolled x, the stripe half from x; the
            # weight as a view of the parameter, so that the bf16 kernel's
            # cached layout is found (a copy made under inference mode has
            # no version counter and would be laid out on every call)
            x_rolled = (torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
                        if ss else None)
            x_window, x_stripe = grl_mixed_attention_qkv_nhwc(
                x, x_rolled, anchor, wq.t(), bq, *tables)
        else:
            qw, kw, vw, qs, ks, vs = (
                F.linear(x, wq[i * c2:(i + 1) * c2], bq[i * c2:(i + 1) * c2])
                for i in range(6))
            if ss:
                qw, kw, vw = (torch.roll(t, shifts=(-ss, -ss), dims=(1, 2))
                              for t in (qw, kw, vw))
            x_window, x_stripe = grl_mixed_attention_nhwc(
                qw, kw, vw, qs, ks, vs, anchor, *tables)
        if ss:
            x_window = torch.roll(x_window, shifts=(ss, ss), dims=(1, 2))
        return self.proj(torch.cat([x_window, x_stripe], -1))


class _ChannelAttention(nn.Module):
    def __init__(self, dim: int, squeeze: int):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(dim, dim // squeeze, 1),
            nn.ReLU(), nn.Conv2d(dim // squeeze, dim, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.attention(x)


class CAB(nn.Module):
    """Conv-GELU-conv + RCAN channel attention (NCHW)."""

    def __init__(self, dim: int, compress_ratio: int, squeeze: int):
        super().__init__()
        self.cab = nn.Sequential(
            nn.Conv2d(dim, dim // compress_ratio, 3, 1, 1), nn.GELU(),
            nn.Conv2d(dim // compress_ratio, dim, 3, 1, 1),
            _ChannelAttention(dim, squeeze))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cab(x)

    def fused_weights(self) -> dict:
        """The flax CAB tree (cab_0, cab_2, ca_1, ca_3) that
        ``ops/cab.py:cab_fused`` takes, every kernel a view of its
        parameter (:func:`hwio_view`)."""
        ca = self.cab[3].attention
        return {"cab_0": hwio_view(self.cab[0]),
                "cab_2": hwio_view(self.cab[2]), "ca_1": hwio_view(ca[1]),
                "ca_3": hwio_view(ca[3])}

    def forward_nhwc(self, x: torch.Tensor, ln: Optional[nn.LayerNorm] = None,
                     skip_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """The branch on an NHWC tensor: through the fused CAB kernel when
        FREQFUSION_CAB=1, with an optional pre-LN and skip-scale residual
        folded in (x * skip_scale + CAB(ln(x))); else through the modules."""
        if gate("FREQFUSION_CAB"):
            lnw = None if ln is None else {"scale": ln.weight,
                                           "bias": ln.bias}
            return cab_fused(x, self.fused_weights(), lnw, skip_scale,
                             eps=1e-5 if ln is None else ln.eps)
        out = conv_nhwc(self, x if ln is None else ln(x))
        return out if skip_scale is None else x * skip_scale + out


class EfficientMixAttnTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads_w: int, num_heads_s: int,
                 window_size: int, window_shift: bool, stripe_type: str,
                 stripe_size: Tuple[int, int], anchor_down_factor: int,
                 mlp_ratio: float = 2.0, res_scale: float = 1.0):
        super().__init__()
        ss = stripe_size if stripe_type == "H" else stripe_size[::-1]
        self.res_scale = res_scale
        self.attn = MixedAttention(dim, num_heads_w, num_heads_s,
                                   window_size, window_shift, ss,
                                   anchor_down_factor)
        self.norm1 = nn.LayerNorm(dim)
        self.conv = CAB(dim, 4, 18)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (x + self.res_scale * self.norm1(self.attn(x))
             + self.conv.forward_nhwc(x))
        if gate("FREQFUSION_MLP"):
            # post-norm FFN half in one kernel: fc1, GELU, fc2, LN2, residual
            fc1, fc2 = self.mlp.fc1, self.mlp.fc2
            return fused_mlp_block(
                x, fc1.weight.t(), fc1.bias, fc2.weight.t(), fc2.bias,
                self.norm2.weight,
                self.norm2.bias, prenorm=False, res_scale=self.res_scale,
                eps=self.norm2.eps)
        return x + self.res_scale * self.norm2(self.mlp(x))


class TransformerStage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads_w: int,
                 num_heads_s: int, window_size: int,
                 stripe_size: Tuple[int, int], anchor_down_factor: int,
                 mlp_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList(
            EfficientMixAttnTransformerBlock(
                dim, num_heads_w, num_heads_s, window_size,
                window_shift=(i % 2 == 0),
                stripe_type="H" if i % 2 == 0 else "W",
                stripe_size=stripe_size,
                anchor_down_factor=anchor_down_factor, mlp_ratio=mlp_ratio)
            for i in range(depth))
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        for blk in self.blocks:
            res = blk(res)
        return conv_nhwc(self.conv, res) + x


class _Upsample(nn.Module):
    """The reference's ``upsample.up`` Sequential."""

    def __init__(self, upscale: int, num_feat: int):
        super().__init__()
        self.up = pixel_shuffle_upsampler(upscale, num_feat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(x)


class GRL(nn.Module):
    def __init__(self, upscale: int = 4, embed_dim: int = 180,
                 depths: Tuple[int, ...] = (4, 4, 8, 8, 8, 4, 4),
                 num_heads_w: int = 3, num_heads_s: int = 3,
                 window_size: int = 8, stripe_size: Tuple[int, int] = (8, 8),
                 anchor_down_factor: int = 2, mlp_ratio: float = 2.0,
                 img_range: float = 1.0, num_feat: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upscale, self.window_size, self.img_range = (upscale,
                                                          window_size,
                                                          img_range)
        self.conv_first = nn.Conv2d(3, embed_dim, 3, 1, 1)
        self.norm_start = nn.LayerNorm(embed_dim)
        self.layers = nn.ModuleList(
            TransformerStage(embed_dim, d, num_heads_w, num_heads_s,
                             window_size, tuple(stripe_size),
                             anchor_down_factor, mlp_ratio)
            for d in depths)
        self.norm_end = nn.LayerNorm(embed_dim)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
        self.conv_before_upsample = nn.Sequential(
            nn.Conv2d(embed_dim, num_feat, 3, 1, 1), nn.LeakyReLU(0.01))
        self.upsample = _Upsample(upscale, num_feat)
        self.conv_last = nn.Conv2d(num_feat, 3, 3, 1, 1)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, 3, H, W] -> (sr [B, 3, 4H, 4W], feature [B, 180, H, W])."""
        h, w = x.shape[-2:]
        p = self.window_size
        ph, pw = (p - h % p) % p, (p - w % p) % p
        x = pad_reflect(x, 0, ph, 0, pw)
        mean = x.new_tensor(RGB_MEAN).view(1, 3, 1, 1)
        x = (x - mean) * self.img_range
        feat = self.conv_first(x)
        t = self.norm_start(to_nhwc(feat))
        for layer in self.layers:
            t = layer(t)
        body = self.conv_after_body(to_nchw(self.norm_end(t)))
        up = self.upsample(self.conv_before_upsample(body + feat))
        out = self.conv_last(up) / self.img_range + mean
        s = self.upscale
        return out[..., :h * s, :w * s], body[..., :h, :w]

