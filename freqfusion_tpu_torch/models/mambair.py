"""MambaIR expert: residual state-space groups (body in NHWC).

Counterpart of ``freqfusion_tpu/models/mambair.py``: 6 RSSGs x 6 VSS
blocks (embed 180, d_state 16, d_inner 360, dt_rank 12). Each block is
LN -> SS2D (2-D selective scan over rows and columns, each forward and
reverse) with a skip scale, then LN -> CAB with a skip scale.
FREQFUSION_DWCONV=1 runs SS2D's depthwise conv through ``ops/dwconv.py``
and FREQFUSION_CAB=1 the LN -> CAB -> skip half through ``ops/cab.py``, as
``freqfusion_tpu/models/mambair.py:88,423`` gate them.

SS2D's four directions (0 row-major, 1 column-major, 2 and 3 their
reversals) run on one of the JAX package's scan routes, chosen at forward
time by :func:`scan_route` as the JAX SS2D chooses with its kernels on
(``freqfusion_tpu/models/mambair.py:118-135``); each runs the entries of
``ops/selective_scan.py``, whose plain versions take CPU tensors:

- chain (default): ``selective_scan_chain_proj`` x4, silu and the dt/B/C
  projections inside; the row directions read the [B, W, H, D] transpose
  (sequence h * W + w), the column directions the NHWC tensor itself
  (sequence w * H + h);
- chainv5: the same layouts, the projections in PyTorch, then
  ``selective_scan_chain`` x4;
- spatial: the projections in PyTorch, then ``selective_scan_spatial`` x4,
  the row directions over the NHWC tensor, the column ones over its
  transpose;
- bidir (H or W not a multiple of 8): the projections of all four
  directions from the two unflipped sequences, then one
  ``selective_scan_bidir``.

Returns (sr, conv_after_body feature). Module names follow the reference
state dict (layers.i.residual_group.blocks.j.{ln_1, self_attention.*,
skip_scale, conv_blk.cab.*, ln_2, skip_scale2}, layers.i.conv, ...).
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dwconv import dwconv3x3
from ..ops.selective_scan import (selective_scan_bidir, selective_scan_chain,
                                  selective_scan_chain_proj,
                                  selective_scan_spatial)
from .common import (RGB_MEAN, PatchEmbed, conv_nhwc, gate, hwio,
                     init_weights, pixel_shuffle_upsampler, to_nchw, to_nhwc)
from .grl import CAB

__all__ = ["SS2D", "VSSBlock", "MambaIR", "scan_route"]


def scan_route(h: int, w: int) -> str:
    """SS2D's scan route for an H x W feature map: "bidir" when H or W is
    not a multiple of 8; else "chain" for FREQFUSION_SCAN unset, "chain"
    or "chainproj", "chainv5" for "chainv5", and "spatial" for any other
    value ("xla" included), as the JAX package routes with its kernels
    on."""
    if h % 8 or w % 8:
        return "bidir"
    impl = os.environ.get("FREQFUSION_SCAN", "chain")
    if impl in ("chain", "chainproj"):
        return "chain"
    return "chainv5" if impl == "chainv5" else "spatial"


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
        bias = self.dt_projs_bias
        route = scan_route(xc.shape[1], xc.shape[2])
        if route == "chain":
            y = self._directions(xc, True, lambda k, lay: (
                selective_scan_chain_proj(
                    lay, self.x_proj_weight[k], self.dt_projs_weight[k],
                    A[k], Ds[k], bias[k], reverse=k >= 2)))
        elif route == "bidir":
            y = self._bidir(F.silu(xc), A, Ds)
        else:
            # chainv5's y comes back in u's dtype and its direction sums
            # run in it (a bf16 sum a pair, then of the pairs); spatial's
            # stays fp32, summed in fp32 and cast once below
            scan = (functools.partial(selective_scan_chain,
                                      out_dtype=xc.dtype)
                    if route == "chainv5" else selective_scan_spatial)

            def one(k, lay):
                dt, B, C = self._project(lay, k)
                return scan(lay, dt, A[k], B, C, Ds[k], bias[k],
                            reverse=k >= 2)
            y = self._directions(F.silu(xc), route == "chainv5", one)
        y = self.out_norm(y.to(x.dtype))
        return self.out_proj(y * F.silu(z))

    @staticmethod
    def _directions(xc: torch.Tensor, rows_transposed: bool, scan
                    ) -> torch.Tensor:
        """The sum of the four directions over xc [B, H, W, D]:
        `scan(k, layout)` scans direction k over `layout`, xc or its
        [B, W, H, D] transpose. The row directions (0, 2) read the
        transpose when `rows_transposed` (the chain layout [B, T, R, D],
        T = W), else xc (the spatial layout [B, R, T, D], R = H); the
        column directions (1, 3) read the other one."""
        xt = xc.transpose(1, 2).contiguous()
        y = None
        for first, lay in ((0, xt if rows_transposed else xc),
                           (1, xc if rows_transposed else xt)):
            pair = scan(first, lay) + scan(first + 2, lay)
            if lay is xt:
                pair = pair.transpose(1, 2)
            y = pair if y is None else y + pair
        return y

    def _project(self, u: torch.Tensor, k: int):
        """Direction k's dt [.., D], B and C [.., N] from u [.., D], as the
        JAX chainv5 and spatial routes' einsums compute them: in fp32 (for
        a bf16 u, fp32 sums of the exact bf16 products, as
        ``preferred_element_type`` keeps them; dt_low stays fp32 into the
        dt product), each of dt, B and C rounded to u's dtype once."""
        r, n = self.dt_rank, self.d_state
        dbl = F.linear(u.float(), self.x_proj_weight[k].float())
        dt = F.linear(dbl[..., :r], self.dt_projs_weight[k].float())
        return tuple(v.to(u.dtype).contiguous()
                     for v in (dt, dbl[..., r:r + n], dbl[..., r + n:]))

    def _bidir(self, u: torch.Tensor, A: torch.Tensor, Ds: torch.Tensor
               ) -> torch.Tensor:
        """The bidir route over u [B, H, W, D] (post-silu): direction k's
        projections from the row-major (k even) or column-major sequence,
        in fp32 (for a bf16 u, fp32 sums of the exact bf16 products, kept
        fp32 as JAX's route keeps x_dbl and dt), one scan of all four, the
        backward outputs already in natural order."""
        b, h, w, d = u.shape
        l, r, n = h * w, self.dt_rank, self.d_state
        xs2 = torch.stack([u.reshape(b, l, d),
                           u.transpose(1, 2).reshape(b, l, d)])
        # [4, C, D] -> [fwd/bwd, row/col, C, D]: direction k = 2 j + i
        w4 = self.x_proj_weight.view(2, 2, r + 2 * n, d)
        dbl = torch.einsum("ibld,jicd->jiblc", xs2.float(),
                           w4.float()).reshape(4, b, l, -1)
        dts = torch.einsum("kblr,kdr->kbld", dbl[..., :r],
                           self.dt_projs_weight.float()).contiguous()
        y_fwd, y_bwd = selective_scan_bidir(
            xs2, dts, A, dbl[..., r:r + n].contiguous(),
            dbl[..., r + n:].contiguous(), Ds, self.dt_projs_bias)
        y_col = (y_fwd[1] + y_bwd[1]).view(b, w, h, d).transpose(1, 2)
        return (y_fwd[0] + y_bwd[0]).view(b, h, w, d) + y_col


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
