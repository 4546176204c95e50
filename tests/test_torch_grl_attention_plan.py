"""GRL mixed attention's plan and 3xTF32 arithmetic, on the CPU.

``csrc/grl_attention.cuh`` (TPU kernel #2, and #12's attention stage)
computes every product of GRL's window and anchored-stripe attention on the
tensor cores in TF32, three products each (x = hi + lo, hi = x rounded to
TF32, lo = x - hi, which the tensor core truncates to 10 mantissa bits;
lo*hi + hi*lo + hi*hi in fp32). A head's hd channels are read as a box of
hdp from its first channel, the box's channels past hd (the next head's,
or zeros past the tile) zeroed in the A operand only. The cosine
normalisation is a pass over the operands in shared memory (each head's
channels of a row times 1 / max(|x|, 1e-12), q's also times its scale *
log2 e; stage 1 scales the anchors by s1 as it reads them), each product
adds onto (bias + mask) * log2 e, a softmax in exp2 (over the whole row
in the stripe's stages; carried across two halves of 32 keys in the
window half), and P V is normalised by 1 / sum afterwards; the stripe's
x1 is normalised before it meets stage 2's P. These tests hold a plain PyTorch
model of that arithmetic to ``grl_mixed_attention_nhwc_reference`` within
ATTN_TOL (the tolerance ``chip_smoke.py`` and the card tests hold the
kernel to), show that one TF32 product (hi*hi alone) misses it where
scales reach 100, and check the block and scratch plans of
``ops/attention.py`` (``plan_grl_attention``,
``plan_grl_qkv_projections``) at GRL-B's shapes. The card tests
(``tests/test_torch_kernels_cuda.py``) run the kernels.
"""

import math

import numpy as np
import pytest
import torch

from freqfusion_tpu_torch.ops import tf32_gemm
from freqfusion_tpu_torch.ops.attention import (
    GRL_HEAD_BOXES, GRL_WARPS, grl_mixed_attention_nhwc_reference,
    plan_grl_attention, plan_grl_qkv_projections)
from freqfusion_tpu_torch.ops.window_attention import (shifted_window_mask,
                                                       window_partition,
                                                       window_reverse)
from test_torch_window_attention_plan import product

ATTN_TOL = 1e-4  # fp32 attention, max-abs (chip_smoke.py, the card tests)
LOG2E = 1.4426950408889634
WS, AWS = 8, 4   # the tile side and the anchor tile side the kernel takes
SM_SMEM = 233472  # bytes of shared memory an SM has for blocks (228 KB)


def _boxes(x: torch.Tensor, heads: int, hdp: int):
    """[B_, n, C2] -> one [B_, n, hdp] box a head from its first channel:
    the head's hd channels, then what follows them in the kernel's shared
    memory (the next head's channels; past the row, finite data of the
    next row, modelled as 7x the previous token's channels)."""
    c2 = x.shape[-1]
    hd = c2 // heads
    padded = torch.cat([x, 7.0 * x.roll(1, dims=-2)], -1)
    return [padded[..., h * hd:h * hd + hdp] for h in range(heads)], hd


def _zero_past(a: torch.Tensor, hd: int) -> torch.Tensor:
    """The A operand as the kernel reads it: box columns >= hd as zeros."""
    a = a.clone()
    a[..., hd:] = 0
    return a


def _normalised(x: torch.Tensor, hd: int, scale: float = 1.0):
    """The box with its head's hd channels scaled in place by scale /
    max(||row||, 1e-12), fp32, as the kernel's pass over shared memory
    does (the rest of the box as it was)."""
    f = scale / torch.clamp((x[..., :hd] ** 2).sum(-1, keepdim=True).sqrt(),
                            min=1e-12)
    return torch.cat([x[..., :hd] * f, x[..., hd:]], -1)


def _probs(a, b, hd, add, terms):
    """Unnormalised probabilities and 1 / row sums of softmax over the
    rows of a b^T + add (a and b normalised, a's scale and log2 e folded
    in), the kernel's way: 3xTF32 product onto the (bias + mask) * log2 e
    it starts from, exp2."""
    s = add * LOG2E + product(_zero_past(a, hd), b.transpose(-2, -1), terms)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    return p, 1.0 / p.sum(-1, keepdim=True)


def _window_head(q, k, v, add, hd, terms):
    """One window head the kernel's way: the 64 keys in two halves of 32,
    the softmax carried across them (running max, rescaled sum and O)."""
    m = None
    for k0 in (0, 32):
        s = add[..., k0:k0 + 32] * LOG2E + product(
            _zero_past(q, hd), k[:, k0:k0 + 32].transpose(-2, -1), terms)
        mx = s.amax(-1, keepdim=True)
        mn = mx if m is None else torch.maximum(m, mx)
        p = torch.exp2(s - mn)
        pv = product(p, v[:, k0:k0 + 32], terms)
        if m is None:
            l, o = p.sum(-1, keepdim=True), pv
        else:
            corr = torch.exp2(m - mn)
            l, o = l * corr + p.sum(-1, keepdim=True), o * corr + pv
        m = mn
    return o * (1.0 / l)


def model_grl(qw, kw, vw, qs, ks, vs, anchor, scale_w, scale_s1, scale_s2,
              bias_w, bias_s1, bias_s2, mask, heads_w: int, heads_s: int,
              terms: int = 3):
    """The kernel's arithmetic on NHWC halves [B, H, W, C2] (8x8 tiles,
    4x4 anchors). Returns (x_window, x_stripe) as the reference does."""
    b, h, w, c2 = qw.shape
    plan = plan_grl_attention(b, h, w, c2, heads_w, heads_s)
    hdp = plan.hdp
    outs = []
    # window half
    (qb, hd), (kb, _), (vb, _) = (_boxes(window_partition(t, WS), heads_w,
                                         hdp) for t in (qw, kw, vw))
    b_ = qb[0].shape[0]
    add = bias_w[None].expand(b_, -1, -1, -1)
    if mask is not None:
        nw = mask.shape[0]
        add = (add.reshape(b_ // nw, nw, heads_w, 64, 64)
               + mask[None, :, None]).reshape(b_, heads_w, 64, 64)
    heads = []
    for hh in range(heads_w):
        q = _normalised(qb[hh], hd, scale_w[hh].item() * LOG2E)
        heads.append(_window_head(q, _normalised(kb[hh], hd), vb[hh],
                                  add[:, hh], hd, terms)[..., :hd])
    outs.append(window_reverse(torch.cat(heads, -1), WS, h, w))
    # stripe half
    (qb, hd), (kb, _), (vb, _) = (_boxes(window_partition(t, WS), heads_s,
                                         hdp) for t in (qs, ks, vs))
    ab, _ = _boxes(window_partition(anchor, AWS), heads_s, hdp)
    heads = []
    for hh in range(heads_s):
        a, k = _normalised(ab[hh], hd), _normalised(kb[hh], hd)
        p1, inv1 = _probs(a * (scale_s1[hh].item() * LOG2E), k, hd,
                          bias_s1[hh], terms)
        x1 = product(p1, vb[hh], terms) * inv1
        q = _normalised(qb[hh], hd, scale_s2[hh].item() * LOG2E)
        p2, inv2 = _probs(q, a, hd, bias_s2[hh], terms)
        heads.append((product(p2, x1, terms) * inv2)[..., :hd])
    outs.append(window_reverse(torch.cat(heads, -1), WS, h, w))
    return tuple(outs)


def _inputs(seed, b, h, w, c2, heads_w, heads_s, shift, scale_range):
    """Seeded halves, anchor, biases in [0, 16) (GRL's 16 sigmoid) and
    scales uniform in `scale_range`; the shift mask where `shift`."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    halves = [t(rng.normal(size=(b, h, w, c2))) for _ in range(6)]
    anchor = t(rng.normal(size=(b, h // 2, w // 2, c2)))
    scales = [t(rng.uniform(*scale_range, (n, 1, 1)))
              for n in (heads_w, heads_s, heads_s)]
    biases = [t(rng.uniform(0, 16, (n, r, c)))
              for n, r, c in ((heads_w, 64, 64), (heads_s, 16, 64),
                              (heads_s, 64, 16))]
    mask = shifted_window_mask(h, w, WS, WS // 2) if shift else None
    return (*halves, anchor, *scales, *biases,
            None if mask is None else t(mask))


def _error(got, args, heads_w, heads_s):
    want = grl_mixed_attention_nhwc_reference(*args, heads_w, heads_s, WS)
    return max((g - w_).abs().max().item() for g, w_ in zip(got, want))


@pytest.mark.parametrize("c2,heads_w,heads_s", [(90, 3, 3), (90, 2, 3),
                                                (42, 3, 3), (42, 2, 3)])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("scale_range", [(10.0, 12.0), (30.0, 100.0)])
def test_model_matches_reference(c2, heads_w, heads_s, shift, scale_range):
    """GRL-B's width (C/2 90: head dims 30, and 45 at two window heads) and
    C/2 42 (rows of 168 bytes, not 16-byte multiples one by one; head dims
    14 and 21), shifted and not, at GRL-B's scales (~10-12) and up to 100:
    logits reach +-100 + bias 16. Two images, 2 x 3 tiles each."""
    args = _inputs(c2 + heads_w + 2 * shift + int(scale_range[1]), 2, 16,
                   24, c2, heads_w, heads_s, shift, scale_range)
    got = model_grl(*args, heads_w, heads_s)
    assert _error(got, args, heads_w, heads_s) <= ATTN_TOL


def test_one_tf32_product_misses_the_tolerance():
    """At scales up to 100 the 3xTF32 model holds ATTN_TOL and one TF32
    product (hi * hi) does not: TF32's 2^-11 input rounding moves logits of
    +-100 by ~5e-2."""
    args = _inputs(5, 1, 16, 24, 90, 3, 3, True, (30.0, 100.0))
    assert _error(model_grl(*args, 3, 3), args, 3, 3) <= ATTN_TOL
    assert _error(model_grl(*args, 3, 3, terms=1), args, 3, 3) > ATTN_TOL


def test_neighbouring_channels_do_not_leak():
    """A head's box holds the next head's channels (and, past the row,
    other data): zeroed in the A operand, they reach no logit or output.
    Changing every channel but head 1's leaves head 1's outputs
    bit-equal."""
    args = list(_inputs(9, 1, 16, 16, 90, 3, 3, True, (10.0, 12.0)))
    out = model_grl(*args, 3, 3)
    keep = torch.zeros(90, dtype=torch.bool)
    keep[30:60] = True
    for i in range(7):  # the six halves and the anchor
        args[i] = torch.where(keep, args[i], 1e6 * torch.randn_like(args[i]))
    again = model_grl(*args, 3, 3)
    for o, a in zip(out, again):
        assert torch.equal(o[..., 30:60], a[..., 30:60])


def test_plan_at_grl_b():
    """GRL-B at 336x512: C/2 90, 3 + 3 heads of 30 in a 32 box, six warps
    of 32 query rows, 75,008 bytes a block (the stripe's q, k, v and
    anchor tiles and the pad), two blocks an SM, a block a (tile, half)."""
    p = plan_grl_attention(1, 336, 512, 90, 3, 3)
    assert (p.hdp, p.rows, p.units_w, p.units_s) == (32, 32, 6, 6)
    assert p.units_w == p.units_s == GRL_WARPS
    assert p.smem == 4 * (208 * 90 + 32) == 75008
    assert 2 * (p.smem + 1024 + 16) <= SM_SMEM
    assert p.blocks == 2 * (336 // 8) * (512 // 8) == 5376


@pytest.mark.parametrize("c2,heads_w,heads_s,hdp,rows", [
    (42, 2, 3, 32, 32), (42, 6, 6, 16, 32), (90, 2, 6, 48, 32),
    (180, 3, 3, 64, 32), (180, 2, 6, 96, 16), (180, 6, 2, 96, 16),
    (8, 1, 1, 16, 32)])
def test_plan_boxes(c2, heads_w, heads_s, hdp, rows):
    """The box holds the wider half's head dim (a multiple of 16 of
    GRL_HEAD_BOXES), one m-tile a warp past box 64; every tile row of
    every operand is a whole number of 16-byte pieces (8 pixels of C2
    floats, or of 3 C2 packed; 4 anchors), so a bulk copy takes it."""
    p = plan_grl_attention(2, 16, 24, c2, heads_w, heads_s)
    assert (p.hdp, p.rows) == (hdp, rows)
    assert p.hdp in GRL_HEAD_BOXES
    assert max(c2 // heads_w, c2 // heads_s) <= p.hdp
    assert p.units_w == heads_w * 64 // rows
    assert p.units_s == heads_s * 64 // rows
    assert p.smem <= tf32_gemm.SMEM_LIMIT - 16
    for row_bytes in (4 * WS * c2, 4 * WS * 3 * c2, 4 * AWS * c2):
        assert row_bytes % 16 == 0
    assert p.blocks == 2 * 2 * 2 * 3


@pytest.mark.parametrize("c2,heads,match", [(194, 2, "head dim 97"),
                                            (280, 4, "shared memory")])
def test_plan_rejects(c2, heads, match):
    with pytest.raises(ValueError, match=match):
        plan_grl_attention(1, 8, 8, c2, heads, heads)


@pytest.mark.parametrize("m,cin,c2", [(336 * 512, 180, 90), (2 * 16 * 24, 60,
                                                             30),
                                      (64, 84, 42)])
def test_qkv_plan(m, cin, c2):
    """#12's two projections (each half's q|k|v, 3 C2 columns from x or
    x_rolled) on the GEMM: K padded to 16, N to the block width that pads
    it less, A's rows to 128; the scratch holds both splits, one tiled A
    and both q|k|v, each region 16-byte aligned, and a tile row of a
    q|k|v (8 pixels of 3 C2 floats) starts 16-byte aligned. At GRL-B:
    K 180 -> 192, N 270 -> 320 on 64-column blocks."""
    p = plan_grl_qkv_projections(m, cin, c2)
    g = p.proj
    assert g.kp == -(-cin // 16) * 16 and p.mp == -(-m // 128) * 128
    assert g.np == min((-(-3 * c2 // c) * c for c in (128, 64)))
    assert p.qkv_floats == -(-m * 3 * c2 // 4) * 4
    regions = [g.split_floats, g.split_floats, p.mp * g.kp, p.qkv_floats,
               p.qkv_floats]
    assert p.scratch_floats == sum(regions)
    assert all(r % 4 == 0 for r in regions)
    assert (WS * 3 * c2) % 4 == 0
    if (m, cin, c2) == (336 * 512, 180, 90):
        assert (g.kp, g.cols, g.np) == (192, 64, 320)
        # 33.4 GFLOP of projections: the 3xTF32 bound's operations term
        flops = 2.0 * m * cin * 6 * c2 + m * c2 * (4.0 * 64 + 8 * 16)
        assert math.isclose(1e3 * 3 * flops / 495e12, 0.239, abs_tol=5e-4)


def test_qkv_plan_rejects_wide_rows():
    with pytest.raises(ValueError, match="Cin=2049"):
        plan_grl_qkv_projections(64, 2049, 90)
