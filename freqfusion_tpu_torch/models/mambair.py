"""MambaIR expert: residual state-space groups (body in NHWC).

Counterpart of ``freqfusion_tpu/models/mambair.py``: 6 RSSGs x 6 VSS
blocks (embed 180, d_state 16, d_inner 360, dt_rank 12). Each block is
LN -> SS2D (2-D selective scan over rows and columns, each forward and
reverse) with a skip scale, then LN -> CAB with a skip scale.
FREQFUSION_DWCONV=1 runs SS2D's depthwise conv through ``ops/dwconv.py``
and FREQFUSION_CAB=1 the LN -> CAB -> skip half through ``ops/cab.py``, as
``freqfusion_tpu/models/mambair.py:88,423`` gate them. SS2D's four
directions run through ``ops/selective_scan.py:selective_scan_chain_proj``
(silu and the dt/B/C projections inside, exact cross-chain state): the
row directions read the [B, W, H, D] transpose (sequence h * W + w), the
column directions the NHWC tensor itself (sequence w * H + h). Returns
(sr, conv_after_body feature). Module names follow the reference state
dict (layers.i.residual_group.blocks.j.{ln_1, self_attention.*,
skip_scale, conv_blk.cab.*, ln_2, skip_scale2}, layers.i.conv, ...).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dwconv import dwconv3x3
from ..ops.selective_scan import selective_scan_chain_proj
from .common import (RGB_MEAN, PatchEmbed, conv_nhwc, gate, hwio,
                     init_weights, pixel_shuffle_upsampler, to_nchw, to_nhwc)
from .grl import CAB

__all__ = ["SS2D", "VSSBlock", "MambaIR"]


class SS2D(nn.Module):
    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 3,
                 expand: float = 2.0):
        super().__init__()
        d_inner = int(expand * d_model)
        self.d_inner, self.d_state = d_inner, d_state
        self.dt_rank = math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv2d = nn.Conv2d(d_inner, d_inner, d_conv,
                                padding=(d_conv - 1) // 2, groups=d_inner)
        self.x_proj_weight = nn.Parameter(
            torch.zeros(4, self.dt_rank + 2 * d_state, d_inner))
        self.dt_projs_weight = nn.Parameter(
            torch.zeros(4, d_inner, self.dt_rank))
        self.dt_projs_bias = nn.Parameter(torch.zeros(4, d_inner))
        self.A_logs = nn.Parameter(torch.zeros(4 * d_inner, d_state))
        self.Ds = nn.Parameter(torch.ones(4 * d_inner))
        self.out_norm = nn.LayerNorm(d_inner)
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)

    def reset_extra(self, g: torch.Generator) -> None:
        """The reference's S6 init: x_proj Linear default, dt_proj weight
        U(+-dt_rank^-0.5), dt bias = softplus^-1 of a log-uniform dt in
        [1e-3, 1e-1], A = -(1..N), D = 1."""
        bound = self.d_inner ** -0.5
        self.x_proj_weight.uniform_(-bound, bound, generator=g)
        std = self.dt_rank ** -0.5
        self.dt_projs_weight.uniform_(-std, std, generator=g)
        u = torch.rand(self.dt_projs_bias.shape, generator=g)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3)).clamp(min=1e-4)
        self.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        a = torch.arange(1, self.d_state + 1, dtype=torch.float32)
        self.A_logs.copy_(torch.log(a).repeat(4 * self.d_inner, 1))
        self.Ds.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] -> [B, H, W, C]."""
        d = self.d_inner
        xc = F.linear(x, self.in_proj.weight[:d])
        z = F.linear(x, self.in_proj.weight[d:])
        if gate("FREQFUSION_DWCONV"):                     # pre-silu
            xc = dwconv3x3(xc, **hwio(self.conv2d))
        else:
            xc = conv_nhwc(self.conv2d, xc)
        A = -torch.exp(self.A_logs.float()).view(4, d, self.d_state)
        Ds = self.Ds.view(4, d)
        y = None
        # rows read [B, W, H, D] (directions 0, 2); columns NHWC (1, 3)
        for first, lay in ((0, xc.transpose(1, 2).contiguous()), (1, xc)):
            pair = None
            for k in (first, first + 2):
                yk = selective_scan_chain_proj(
                    lay, self.x_proj_weight[k], self.dt_projs_weight[k], A[k],
                    Ds[k], self.dt_projs_bias[k], reverse=k >= 2)
                pair = yk if pair is None else pair + yk
            y = pair.transpose(1, 2) if first == 0 else y + pair
        y = self.out_norm(y.to(x.dtype))
        return self.out_proj(y * F.silu(z))


class VSSBlock(nn.Module):
    def __init__(self, dim: int, d_state: int = 16, expand: float = 2.0):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim)
        self.self_attention = SS2D(dim, d_state, expand=expand)
        self.skip_scale = nn.Parameter(torch.ones(dim))
        self.ln_2 = nn.LayerNorm(dim)
        self.conv_blk = CAB(dim, 3, 30)
        self.skip_scale2 = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * self.skip_scale + self.self_attention(self.ln_1(x))
        return self.conv_blk.forward_nhwc(x, self.ln_2, self.skip_scale2)


class _Blocks(nn.Module):
    def __init__(self, dim: int, depth: int, d_state: int, expand: float):
        super().__init__()
        self.blocks = nn.ModuleList(VSSBlock(dim, d_state, expand)
                                    for _ in range(depth))


class ResidualGroup(nn.Module):
    """RSSG: VSS blocks + 3x3 conv + residual."""

    def __init__(self, dim: int, depth: int, d_state: int = 16,
                 expand: float = 2.0):
        super().__init__()
        self.residual_group = _Blocks(dim, depth, d_state, expand)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        for blk in self.residual_group.blocks:
            res = blk(res)
        return conv_nhwc(self.conv, res) + x


class MambaIR(nn.Module):
    def __init__(self, upscale: int = 4, embed_dim: int = 180,
                 depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6),
                 d_state: int = 16, mlp_ratio: float = 2.0,
                 img_range: float = 1.0, num_feat: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.img_range = img_range
        self.conv_first = nn.Conv2d(3, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            ResidualGroup(embed_dim, d, d_state, mlp_ratio) for d in depths)
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
