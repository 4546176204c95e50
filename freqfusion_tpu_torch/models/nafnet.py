"""NAFNet-SIDD-64 expert (NCHW), wrapped for x4 SR.

Counterpart of ``freqfusion_tpu/models/nafnet.py``: bicubic x4 upscale,
then the activation-free UNet (width 64, encoders (2, 2, 4, 8), 12 middle
blocks, decoders (2, 2, 2, 2)), clamped to [0, 1]. Returns (sr, feat) with
the feature (the input of the ``ending`` conv) at HR resolution. Module
names follow the reference state dict (intro, encoders.i.j, downs.i,
middle_blks.j, ups.i.0, decoders.i.j, ending; per block conv1..conv5,
sca.1, norm1/2, beta, gamma). Calls no kernel on the default path.

The JAX package's two gates are carried over (``freqfusion_tpu/models/
nafnet.py:108,136``): FREQFUSION_NAFBLOCK=1 runs each whole block through
``ops/nafblock.py:nafblock_fused``; otherwise FREQFUSION_DWCONV=1 runs each
block's depthwise conv through ``ops/dwconv.py:dwconv3x3``. Both kernels
take NHWC, so with either gate on the network keeps its activations
channels-last from the intro conv on: an NCHW tensor in channels-last
memory is an NHWC tensor, and the kernels get it without a permute copy.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dwconv import dwconv3x3
from ..ops.nafblock import nafblock_fused
from ..ops.resize import upscale_bicubic
from .common import LayerNorm2d, gate, hwio, hwio_view, init_weights

__all__ = ["simple_gate", "NAFBlock", "NAFNet", "NAFNetSR"]


def simple_gate(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=1)
    return x1 * x2


class NAFBlock(nn.Module):
    def __init__(self, c: int, dw_expand: int = 2, ffn_expand: int = 2):
        super().__init__()
        dw = c * dw_expand
        self.conv1 = nn.Conv2d(c, dw, 1)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
        self.conv3 = nn.Conv2d(dw // 2, c, 1)
        self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                 nn.Conv2d(dw // 2, dw // 2, 1))
        self.conv4 = nn.Conv2d(c, ffn_expand * c, 1)
        self.conv5 = nn.Conv2d(ffn_expand * c // 2, c, 1)
        self.norm1 = LayerNorm2d(c)
        self.norm2 = LayerNorm2d(c)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def fused_weights(self) -> dict:
        """The flax NAFBlock tree that ``ops/nafblock.py:nafblock_fused``
        takes. The 1x1 kernels are views of the parameters (the kernels
        lay them out once per parameter and reuse that while it is
        unchanged); the depthwise taps a contiguous copy."""
        def norm(n):
            return {"scale": n.weight, "bias": n.bias}

        io = hwio_view
        return {"norm1": norm(self.norm1), "conv1": io(self.conv1),
                "conv2": hwio(self.conv2), "sca": io(self.sca[1]),
                "conv3": io(self.conv3), "beta": self.beta.reshape(-1),
                "norm2": norm(self.norm2), "conv4": io(self.conv4),
                "conv5": io(self.conv5), "gamma": self.gamma.reshape(-1)}

    def _dw(self, x: torch.Tensor) -> torch.Tensor:
        if gate("FREQFUSION_DWCONV"):
            nhwc = x.permute(0, 2, 3, 1).contiguous()
            return dwconv3x3(nhwc, **hwio(self.conv2)).permute(0, 3, 1, 2)
        return self.conv2(x)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        if (gate("FREQFUSION_NAFBLOCK") and self.conv1.out_channels == 2 *
                self.conv1.in_channels == self.conv4.out_channels):
            # the whole block in the fused kernels, on the NHWC view
            nhwc = inp.permute(0, 2, 3, 1).contiguous()
            out = nafblock_fused(nhwc, self.fused_weights())
            return out.permute(0, 3, 1, 2)
        x = simple_gate(self._dw(self.conv1(self.norm1(inp))))
        x = self.conv3(x * self.sca(x))
        y = inp + x * self.beta
        x = self.conv5(simple_gate(self.conv4(self.norm2(y))))
        return y + x * self.gamma


class NAFNet(nn.Module):
    def __init__(self, img_channel: int = 3, width: int = 64,
                 middle_blk_num: int = 12,
                 enc_blk_nums: Sequence[int] = (2, 2, 4, 8),
                 dec_blk_nums: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.intro = nn.Conv2d(img_channel, width, 3, padding=1)
        self.ending = nn.Conv2d(width, img_channel, 3, padding=1)
        self.encoders, self.downs = nn.ModuleList(), nn.ModuleList()
        self.ups, self.decoders = nn.ModuleList(), nn.ModuleList()
        chan = width
        for num in enc_blk_nums:
            self.encoders.append(nn.Sequential(*[NAFBlock(chan)
                                                 for _ in range(num)]))
            self.downs.append(nn.Conv2d(chan, 2 * chan, 2, 2))
            chan *= 2
        self.middle_blks = nn.Sequential(*[NAFBlock(chan)
                                           for _ in range(middle_blk_num)])
        for num in dec_blk_nums:
            self.ups.append(nn.Sequential(nn.Conv2d(chan, chan * 2, 1,
                                                    bias=False),
                                          nn.PixelShuffle(2)))
            chan //= 2
            self.decoders.append(nn.Sequential(*[NAFBlock(chan)
                                                 for _ in range(num)]))
        self.padder_size = 2 ** len(enc_blk_nums)

    def forward(self, inp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (restored image, ending-conv input), both cropped to the
        input size."""
        h, w = inp.shape[-2:]
        ph = (self.padder_size - h % self.padder_size) % self.padder_size
        pw = (self.padder_size - w % self.padder_size) % self.padder_size
        x_in = F.pad(inp, (0, pw, 0, ph)) if (ph or pw) else inp
        x = self.intro(x_in)
        if gate("FREQFUSION_NAFBLOCK") or gate("FREQFUSION_DWCONV"):
            x = x.contiguous(memory_format=torch.channels_last)
        skips = []
        for enc, down in zip(self.encoders, self.downs):
            x = enc(x)
            skips.append(x)
            x = down(x)
        x = self.middle_blks(x)
        for dec, up, skip in zip(self.decoders, self.ups, skips[::-1]):
            x = dec(up(x) + skip)
        out = self.ending(x) + x_in
        return out[..., :h, :w], x[..., :h, :w]


class NAFNetSR(nn.Module):
    """Bicubic x`upscale` + NAFNet refinement, clamped to [0, 1]."""

    def __init__(self, upscale: int = 4, width: int = 64,
                 middle_blk_num: int = 12,
                 enc_blk_nums: Sequence[int] = (2, 2, 4, 8),
                 dec_blk_nums: Sequence[int] = (2, 2, 2, 2),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upscale = upscale
        self.nafnet = NAFNet(3, width, middle_blk_num, enc_blk_nums,
                             dec_blk_nums)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, 3, H, W] -> (sr [B, 3, sH, sW], feat [B, width, sH, sW])."""
        out, feat = self.nafnet(upscale_bicubic(x, self.upscale))
        return out.clamp(0.0, 1.0), feat
