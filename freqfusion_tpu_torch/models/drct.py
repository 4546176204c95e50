"""DRCT-L expert: dense-residual Swin transformer (body in NHWC).

Counterpart of ``freqfusion_tpu/models/drct.py``: 12 RDGs of five Swin
blocks with dense channel concat (dim + k * gc, gc 32), 1x1 adjusts and a
0.2-scaled residual; window 16 with shifts (0, 8, 0, 8, 0); embed 180,
6 heads; pixel-shuffle x4. Returns (sr, conv_after_body feature). The
dense concat gives the five blocks of an RDG widths 180..308 with 6, 4,
2, 6 and 4 heads, so head dims 30, 53, 122, 46, 77 reach the window
attention kernel (``ops/attention.py:window_attention_nhwc``). Module
names follow the reference state dict (conv_first, patch_embed.norm,
layers.i.swin1..5 / adjust1..5, norm, conv_after_body,
conv_before_upsample.0, upsample.{0,2}, conv_last).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import window_attention_nhwc
from ..ops.window_attention import (device_table, relative_position_index,
                                    shifted_window_mask)
from .common import (RGB_MEAN, Mlp, PatchEmbed, conv1x1_nhwc, init_weights,
                     pixel_shuffle_upsampler, to_nchw, to_nhwc)

__all__ = ["WindowAttention", "SwinTransformerBlock", "RDG", "DRCT"]


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def reset_extra(self, g: torch.Generator) -> None:
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02,
                              generator=g)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        """x [B, H, W, C] -> [B, H, W, C]."""
        c, ws, nh = self.dim, self.window_size, self.num_heads
        w, b = self.qkv.weight, self.qkv.bias
        q, k, v = (F.linear(x, w[i * c:(i + 1) * c], b[i * c:(i + 1) * c])
                   for i in range(3))
        idx = device_table(relative_position_index, ws, ws, device=x.device)
        bias = self.relative_position_bias_table[idx.reshape(-1)]
        bias = bias.view(ws * ws, ws * ws, nh).permute(2, 0, 1).contiguous()
        return self.proj(window_attention_nhwc(q, k, v, bias, mask, nh, ws))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 16,
                 shift_size: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        ws, ss = self.window_size, self.shift_size
        if min(h, w) < ws:
            raise ValueError(f"DRCT: input {h}x{w} smaller than window {ws}")
        if min(h, w) == ws:
            ss = 0
        shortcut = x
        x = self.norm1(x)
        if ss:
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
        mask = device_table(shifted_window_mask, h, w, ws, ss, device=x.device)
        x = self.attn(x, mask)
        if ss:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class RDG(nn.Module):
    """Residual dense group: five Swin blocks over a growing concat."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 gc: int = 32, mlp_ratio: float = 4.0):
        super().__init__()
        for k in range(5):
            bdim = dim + k * gc
            heads = num_heads - (bdim % num_heads)
            ratio = mlp_ratio if k < 3 else 1.0
            shift = window_size // 2 if k % 2 == 1 else 0
            self.add_module(f"swin{k + 1}", SwinTransformerBlock(
                bdim, heads, window_size, shift, ratio))
            self.add_module(f"adjust{k + 1}",
                            nn.Conv2d(bdim, dim if k == 4 else gc, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for k in range(5):
            out = getattr(self, f"swin{k + 1}")(torch.cat(feats, -1)
                                                if k else x)
            out = conv1x1_nhwc(getattr(self, f"adjust{k + 1}"), out)
            if k < 4:
                out = F.leaky_relu(out, 0.2)
            feats.append(out)
        return feats[-1] * 0.2 + x


class DRCT(nn.Module):
    def __init__(self, upscale: int = 4, embed_dim: int = 180,
                 num_layers: int = 12, num_heads: int = 6,
                 window_size: int = 16, gc: int = 32, mlp_ratio: float = 4.0,
                 img_range: float = 1.0, num_feat: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.img_range = img_range
        self.conv_first = nn.Conv2d(3, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            RDG(embed_dim, num_heads, window_size, gc, mlp_ratio)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
        self.conv_before_upsample = nn.Sequential(
            nn.Conv2d(embed_dim, num_feat, 3, 1, 1), nn.LeakyReLU(0.01))
        self.upsample = pixel_shuffle_upsampler(upscale, num_feat)
        self.conv_last = nn.Conv2d(num_feat, 3, 3, 1, 1)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, 3, H, W] -> (sr [B, 3, 4H, 4W], feature [B, 180, H, W])."""
        mean = x.new_tensor(RGB_MEAN).view(1, 3, 1, 1)
        x = (x - mean) * self.img_range
        feat = self.conv_first(x)
        t = self.patch_embed.norm(to_nhwc(feat))
        for layer in self.layers:
            t = layer(t)
        body = self.conv_after_body(to_nchw(self.norm(t)))
        up = self.upsample(self.conv_before_upsample(body + feat))
        return self.conv_last(up) / self.img_range + mean, body
