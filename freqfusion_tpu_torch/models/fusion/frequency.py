"""Phase 2: multi-domain frequency decomposition (DCT + DWT + FFT, 9 bands).

Counterpart of ``freqfusion_tpu/models/fusion/frequency.py`` (NCHW): 8x8
block DCT-II split by zigzag thirds, a single-level db4 DWT with reflect
padding resized back to the input size, and rfft2 (norm="ortho") with a
learnable radial low-pass mask. ``torch.fft`` replaces the TPU's matmul
DFT (``freqfusion_tpu/ops/dft.py``).

In bf16 (the fusion net cast by the pipeline's ``fusion_dtype``) each
band keeps the JAX module's dtypes: the DCT's fp32 basis promotes the
bf16 blocks, so both products and ``band_scale`` run in fp32 and each band
is rounded to bf16 at the end; the DWT's filters are rounded to bf16 and
its convs and resizes run in bf16 (``ops/resize.py``: rounded after each
axis); the FFT runs on x in fp32 with the mask from the bf16 logits and
temperature computed in bf16, each band rounded at the end.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.pad import pad_reflect
from ...ops.resize import resize_bilinear
from ...ops.window_attention import device_table

__all__ = ["DCTDecomposition", "DWTDecomposition", "FFTDecomposition",
           "MultiDomainFrequencyDecomposition"]

# Daubechies-4 decomposition filters (pywt's db4 dec_lo / dec_hi).
DB4_LO_D = np.array([
    -0.010597401784997278, 0.032883011666982945, 0.030841381835986965,
    -0.18703481171888114, -0.027983769416983849, 0.63088076792959036,
    0.71484657055291582, 0.23037781330885523], dtype=np.float32)
DB4_HI_D = np.array([
    -0.23037781330885523, 0.71484657055291582, -0.63088076792959036,
    -0.027983769416983849, 0.18703481171888114, 0.030841381835986965,
    -0.032883011666982945, -0.010597401784997278], dtype=np.float32)


@functools.lru_cache(maxsize=8)
def _dct_basis_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis D, so that Y = D X D^T."""
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    mat = np.sqrt(2.0 / n) * np.cos(np.pi * k * (2 * m + 1) / (2 * n))
    mat[0, :] = np.sqrt(1.0 / n)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _zigzag_band_masks_np(n: int) -> np.ndarray:
    """[3, n, n] low / mid / high masks splitting zigzag order in thirds."""
    order = np.zeros((n, n), dtype=np.int64)
    idx = 0
    for s in range(2 * n - 1):
        diag = [(i, s - i) for i in range(max(0, s - n + 1), min(s, n - 1) + 1)]
        if s % 2 == 0:
            diag = diag[::-1]
        for i, j in diag:
            order[i, j] = idx
            idx += 1
    total = n * n
    low = (order < total // 3).astype(np.float32)
    high = (order >= 2 * total // 3).astype(np.float32)
    return np.stack([low, 1.0 - low - high, high])


def _radial_lowpass_logits(size: int) -> np.ndarray:
    coords = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    yy, xx = np.meshgrid(coords, coords, indexing="ij")
    return (3.0 * (0.5 - np.sqrt(xx ** 2 + yy ** 2)))[None, None]


class DCTDecomposition(nn.Module):
    def __init__(self, block_size: int = 8):
        super().__init__()
        self.block_size = block_size
        self.band_scale = nn.Parameter(torch.ones(3))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        n = self.block_size
        b, c, h, w = x.shape
        ph, pw = (n - h % n) % n, (n - w % n) % n
        xp = pad_reflect(x, 0, ph, 0, pw)
        hp, wp = h + ph, w + pw
        basis = device_table(_dct_basis_np, n, device=x.device)
        masks = device_table(_zigzag_band_masks_np, n, device=x.device)
        blocks = xp.reshape(b, c, hp // n, n, wp // n, n).permute(0, 1, 2, 4, 3, 5)
        coeffs = basis @ blocks.float() @ basis.T
        out = []
        for band in range(3):
            spatial = basis.T @ (coeffs * masks[band]) @ basis
            img = spatial.permute(0, 1, 2, 4, 3, 5).reshape(b, c, hp, wp)
            out.append((img[..., :h, :w]
                        * self.band_scale[band].float()).to(x.dtype))
        return out


def _dwt_conv(x: torch.Tensor, filt: torch.Tensor, axis: str) -> torch.Tensor:
    """Depthwise stride-2 1-D wavelet conv along W or H, reflect padded."""
    c, k = x.shape[1], filt.numel()
    if axis == "w":
        x = pad_reflect(x, 0, 0, k - 1, k - 1)
        return F.conv2d(x, filt.view(1, 1, 1, k).expand(c, 1, 1, k),
                        stride=(1, 2), groups=c)
    x = pad_reflect(x, k - 1, k - 1, 0, 0)
    return F.conv2d(x, filt.view(1, 1, k, 1).expand(c, 1, k, 1),
                    stride=(2, 1), groups=c)


def _db4(kind: str) -> np.ndarray:
    return DB4_LO_D if kind == "lo" else DB4_HI_D


class DWTDecomposition(nn.Module):
    def __init__(self):
        super().__init__()
        self.subband_scale = nn.Parameter(torch.ones(4))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h, w = x.shape[-2:]
        lo = device_table(_db4, "lo", device=x.device).to(x.dtype)
        hi = device_table(_db4, "hi", device=x.device).to(x.dtype)
        lo_rows, hi_rows = _dwt_conv(x, lo, "w"), _dwt_conv(x, hi, "w")
        bands = [_dwt_conv(lo_rows, lo, "h"), _dwt_conv(lo_rows, hi, "h"),
                 _dwt_conv(hi_rows, lo, "h"), _dwt_conv(hi_rows, hi, "h")]
        return [resize_bilinear(sb, h, w) * self.subband_scale[i]
                for i, sb in enumerate(bands)]


class FFTDecomposition(nn.Module):
    def __init__(self, init_mask_size: int = 64):
        super().__init__()
        self.freq_mask_logits = nn.Parameter(
            torch.from_numpy(_radial_lowpass_logits(init_mask_size)))
        self.temperature = nn.Parameter(torch.tensor(5.0))
        self.band_scale = nn.Parameter(torch.ones(2))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h, w = x.shape[-2:]
        x_fft = torch.fft.rfft2(x.float(), norm="ortho")
        mask = resize_bilinear(self.freq_mask_logits, *x_fft.shape[-2:])
        mask = torch.sigmoid(mask * torch.clamp(self.temperature, min=1.0))
        low = torch.fft.irfft2(x_fft * mask, s=(h, w), norm="ortho")
        high = torch.fft.irfft2(x_fft * (1.0 - mask), s=(h, w), norm="ortho")
        return [(low * self.band_scale[0]).to(x.dtype),
                (high * self.band_scale[1]).to(x.dtype)]


class MultiDomainFrequencyDecomposition(nn.Module):
    """DCT (3) + DWT (4) + FFT (2) = the 9 raw bands."""

    def __init__(self, block_size: int = 8, fft_mask_size: int = 64):
        super().__init__()
        self.dct = DCTDecomposition(block_size)
        self.dwt = DWTDecomposition()
        self.fft = FFTDecomposition(fft_mask_size)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.dct(x) + self.dwt(x) + self.fft(x)
