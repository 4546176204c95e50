"""Window attention's plan and 3xTF32 arithmetic, on the CPU.

``csrc/window_attention.cuh`` computes both products of window attention on
the tensor cores in TF32, three products each: x = hi + lo with hi = x
rounded to TF32 (to nearest, ties away, 10 mantissa bits) and lo = x - hi,
which the tensor core truncates to its top 10 mantissa bits; a product is
lo*hi + hi*lo + hi*hi, summed in fp32. Keys go 16 a tile with an online
softmax in exp2, and a head's channels sit in a box of hdp channels that
``ops/attention.py:plan_window_attention`` picks, the neighbouring heads'
channels in it zeroed in Q. These tests hold a plain PyTorch model of that
arithmetic to the plain window attention the kernel is held to on the card
(``window_attention_nhwc_reference``, ``ATTN_TOL``), and show that one TF32
product (hi*hi alone) misses the tolerance where logits reach +-30, which
is why the kernel splits. The card tests
(``tests/test_torch_kernels_cuda.py``) run the kernel itself."""

import math

import numpy as np
import pytest
import torch

from freqfusion_tpu_torch.ops.attention import (HEAD_BOXES,
                                                plan_window_attention,
                                                window_attention_nhwc_reference)
from freqfusion_tpu_torch.ops.window_attention import (shifted_window_mask,
                                                       window_partition)

# fp32 attention, max-abs (chip_smoke.py and the card tests)
ATTN_TOL = 1e-4
KEY_TILE = 16  # keys a tile (csrc/window_attention.cuh WaShape::kKt)
LOG2E = 1.4426950408889634


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds: to nearest, ties away
    from zero, on the int32 bits (add half of the 13 dropped bits, clear
    them)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads a TF32 operand: its top 10 mantissa
    bits."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo) as the tensor core sees them: hi = rna(x), lo = x - hi
    truncated."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a @ b over its inner dim in 8-wide steps, each step lo*hi, hi*lo,
    hi*hi (terms 3) or hi*hi alone (terms 1), added in fp32."""
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ah, al = split(a[..., k0:k0 + 8].contiguous())
        bh, bl = split(b[..., k0:k0 + 8, :].contiguous())
        if terms == 3:
            acc = acc + al @ bh
            acc = acc + ah @ bl
        acc = acc + ah @ bh
    return acc


def head_boxes(x: torch.Tensor, heads: int, hdp: int, vec: bool):
    """[B_, N, C] -> ([B_, heads, N, hdp] boxes, per-head box column of
    channel 0): the vec route's box starts at the head's first channel
    rounded down to a multiple of 4 and holds the neighbours' channels (or
    zeros past C); the generic route's holds the head's channels and
    zeros."""
    b_, n, c = x.shape
    hd = c // heads
    padded = torch.cat([x, x.new_zeros(b_, n, hdp)], -1)
    boxes, offs = [], []
    for h in range(heads):
        a = (h * hd) % 4 if vec else 0
        box = padded[..., h * hd - a:h * hd - a + hdp].clone()
        if not vec:
            box[..., hd:] = 0
        boxes.append(box)
        offs.append(a)
    return torch.stack(boxes, 1), offs


def model_window_attention(q, k, v, bias, mask, heads: int, ws: int,
                           terms: int = 3, vec: bool = True,
                           hdp: int = None):
    """The kernel's arithmetic on NHWC q/k/v [B, H, W, C]: head boxes (Q's
    neighbouring channels zeroed), key tiles of KEY_TILE with an online
    softmax in exp2, products as in `product`. Returns [B_, N, C]."""
    c = q.shape[-1]
    hd = c // heads
    if hdp is None:
        hdp, vec = plan_window_attention(hd, heads, c, vec)
    qw, kw, vw = (window_partition(t, ws) for t in (q, k, v))
    b_, n, _ = qw.shape
    qb, offs = head_boxes(qw, heads, hdp, vec)
    kb, _ = head_boxes(kw, heads, hdp, vec)
    vb, _ = head_boxes(vw, heads, hdp, vec)
    for h, a in enumerate(offs):
        qb[:, h, :, :a] = 0
        qb[:, h, :, a + hd:] = 0
    add = bias[None].expand(b_, heads, n, n)
    if mask is not None:
        nw = mask.shape[0]
        add = (add.reshape(b_ // nw, nw, heads, n, n)
               + mask[None, :, None]).reshape(b_, heads, n, n)
    scale = hd ** -0.5
    m = torch.full((b_, heads, n, 1), -math.inf)
    l = torch.zeros(b_, heads, n, 1)
    o = torch.zeros(b_, heads, n, hdp)
    for k0 in range(0, n, KEY_TILE):
        k1 = min(k0 + KEY_TILE, n)
        kt = torch.zeros(b_, heads, KEY_TILE, hdp)
        vt = torch.zeros(b_, heads, KEY_TILE, hdp)
        kt[:, :, :k1 - k0] = kb[:, :, k0:k1]
        vt[:, :, :k1 - k0] = vb[:, :, k0:k1]
        s = product(qb, kt.transpose(-2, -1), terms)
        at = torch.zeros(b_, heads, n, KEY_TILE)
        at[..., :k1 - k0] = add[..., k0:k1]
        s = s * (scale * LOG2E) + at * LOG2E
        s[..., k1 - k0:] = -math.inf
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - mn)
        p = torch.exp2(s - mn)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + product(p, vt, terms)
        m = mn
    o = o / l
    out = torch.stack([o[:, h, :, a:a + hd] for h, a in enumerate(offs)], 2)
    return out.reshape(b_, n, c)


def _inputs(seed, b, h, w, c, heads, ws, shift, qk_scale=1.0):
    rng = np.random.default_rng(seed)
    n = ws * ws
    q, k = (torch.from_numpy(qk_scale * rng.normal(size=(b, h, w, c))
                             .astype(np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
    bias = torch.from_numpy(0.5 * rng.normal(size=(heads, n, n))
                            .astype(np.float32))
    mask = shifted_window_mask(h, w, ws, shift)
    return q, k, v, bias, None if mask is None else torch.from_numpy(mask)


def _error(got, q, k, v, bias, mask, heads, ws):
    want = window_partition(window_attention_nhwc_reference(
        q, k, v, bias, mask, heads, ws), ws)
    return (got - want).abs().max().item()


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),   # 1.0 stays
    (0x3F801000, 0x3F802000),   # 1 + 2^-11: a tie, away from zero
    (0xBF801000, 0xBF802000),   # -(1 + 2^-11): away from zero too
    (0x3F800FFF, 0x3F800000),   # just under the tie: down
    (0x3F803000, 0x3F804000),   # 1 + 3 * 2^-11: a tie, away
    (0x3FFFF000, 0x40000000),   # rounds up into the next binade
])
def test_tf32_rounding_is_nearest_ties_away(bits, want):
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
        torch.float32)
    got = tf32_rna(x).view(torch.int32).item() & 0xFFFFFFFF
    assert got == want


def test_split_keeps_every_bit():
    """hi has 10 mantissa bits, hi + lo == x exactly, |lo| <= 2^-11 |x|,
    and the truncated lo the tensor core reads is within 2^-21 |x|."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=4096)
                          * 10.0 ** rng.uniform(-6, 6, 4096))
                         .astype(np.float32))
    hi = tf32_rna(x)
    lo = x - hi
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert torch.equal(hi + lo, x)
    assert bool((lo.abs() <= 2.0 ** -11 * x.abs()).all())
    assert bool(((lo - tf32_trunc(lo)).abs() <= 2.0 ** -21 * x.abs()).all())


@pytest.mark.parametrize("c,heads,want", [(180, 6, 32), (212, 4, 56),
                                          (244, 2, 128), (276, 6, 48),
                                          (308, 4, 80)])
@pytest.mark.parametrize("packed", [False, True])
def test_plan_at_drct_widths(c, heads, want, packed):
    """DRCT-L's five widths take the 16-byte route with boxes 32/56/128/
    48/80, for separate q/k/v (rows of C) and the 3C projection alike."""
    hd = c // heads
    hdp, vec = plan_window_attention(hd, heads, 3 * c if packed else c, True)
    assert (hdp, vec) == (want, True)
    assert all((h * hd) % 4 + hd <= hdp for h in range(heads))


@pytest.mark.parametrize("hd,heads,ldi,aligned,want", [
    (14, 3, 42, True, (16, False)),    # C 42: rows not 16-byte multiples
    (30, 6, 180, False, (32, False)),  # an unaligned base
    (7, 2, 14, True, (16, False)),
    (253, 2, 508, True, (256, True)),  # 253 + (253 % 4) fits the box
    (255, 2, 512, True, (256, False)),  # 255 + 3 does not: generic
    (256, 1, 256, True, (256, True)),
    (1, 1, 1, True, (16, False)),
])
def test_plan_routes(hd, heads, ldi, aligned, want):
    assert plan_window_attention(hd, heads, ldi, aligned) == want
    assert want[0] in HEAD_BOXES


def test_plan_rejects_wide_heads():
    with pytest.raises(ValueError, match="head dim 257"):
        plan_window_attention(257, 1, 257, True)


@pytest.mark.parametrize("ws", [7, 12, 16])     # N 49, 144, 256: ragged
@pytest.mark.parametrize("c,heads", [(24, 2), (42, 3), (60, 3)])
@pytest.mark.parametrize("shift", [0, 1])
def test_model_matches_reference(ws, c, heads, shift):
    """Small widths, windows whose N leaves a ragged last key tile (49,
    144) or none (256), with and without the shift mask; C 42 takes the
    generic route (rows of 168 bytes)."""
    args = _inputs(ws + c, 1, ws, 2 * ws, c, heads, ws, shift * ws // 2)
    vec = c % 4 == 0
    got = model_window_attention(*args, heads, ws, vec=vec)
    assert _error(got, *args, heads, ws) <= ATTN_TOL


@pytest.mark.parametrize("c,heads", [(180, 6), (212, 4), (244, 2)])
def test_model_at_drct_head_dims(c, heads):
    """Head dims 30, 53 and 122 at window 16 (N 256) on two windows,
    shifted: the boxes 32, 56 and 128 hold the neighbouring heads'
    channels."""
    args = _inputs(c, 1, 16, 32, c, heads, 16, 8)
    got = model_window_attention(*args, heads, 16)
    assert _error(got, *args, heads, 16) <= ATTN_TOL


def test_neighbouring_channels_do_not_leak():
    """The vec route's box holds the neighbouring heads' channels: Q's are
    zeroed, so K's and V's do not reach the output, however large (finite)
    they are. Changing every channel but head 1's leaves head 1's output
    bit-equal."""
    c, heads, ws = 212, 4, 8   # head 1 at channels 53..105: box from 52
    q, k, v, bias, mask = _inputs(3, 1, 8, 16, c, heads, ws, 4)
    out = model_window_attention(q, k, v, bias, mask, heads, ws)
    keep = torch.zeros(c, dtype=torch.bool)
    keep[53:106] = True
    noisy = [torch.where(keep, t, 1e6 * torch.randn_like(t))
             for t in (q, k, v)]
    again = model_window_attention(*noisy, bias, mask, heads, ws)
    assert torch.equal(out[..., 53:106], again[..., 53:106])


@pytest.mark.parametrize("c,heads", [(244, 2), (180, 6)])
def test_one_tf32_product_misses_the_tolerance(c, heads):
    """With q and k scaled so that logits reach +-30 (as the card's
    precision guard does), the 3xTF32 model stays within ATTN_TOL and one
    TF32 product (hi * hi) does not: TF32's 2^-11 input rounding moves such
    logits by ~1e-2."""
    args = _inputs(c + 7, 1, 16, 32, c, heads, 16, 0, qk_scale=2.6)
    q, k = args[0], args[1]
    hd = c // heads
    qh = window_partition(q, 16).reshape(-1, 256, heads, hd).transpose(1, 2)
    kh = window_partition(k, 16).reshape(-1, 256, heads, hd).transpose(1, 2)
    assert (qh @ kh.transpose(-2, -1)).abs().max().item() * hd ** -0.5 >= 30
    three = model_window_attention(*args, heads, 16)
    one = model_window_attention(*args, heads, 16, terms=1)
    assert _error(three, *args, heads, 16) <= ATTN_TOL
    assert _error(one, *args, heads, 16) > ATTN_TOL
