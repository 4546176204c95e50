"""The fusion-eval kernels' 3xTF32 plans and arithmetic, on the CPU.

``csrc/hier.cu`` (TPU kernel #19) runs hierarchical stage 3's six 3x3
convolutions as implicit GEMMs on ``csrc/conv3x3_tf32.cuh``: Cin padded to
8 a stage, K = 9 Cin taken stage by stage and tap by tap, the halo zero
outside the image, Cout padded to the block's n-tiles, three TF32 products
an fp32 one, the SpatialGate in conv1's epilogue. ``csrc/lka.cu`` (#18)
folds the LKABlock's BatchNorms into its products (sbn into pw's columns,
BN2 into ffn_0's rows and bias) and runs the three products in 3xTF32 with
the hidden in chunks of the padded width. These tests check the plans that
``ops/hier.py:plan_hier`` and ``ops/lka.py:plan_lka`` make at the path's
shapes (padding, tiles, shared memory under the card's limit, scratch),
and hold numpy models of both kernels' padded, reordered 3xTF32 arithmetic
and the folding to the plain versions. The rounding model is
``test_torch_tf32_gemm.py``'s; the card tests
(``tests/test_torch_kernels_cuda.py``) run the kernels themselves.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from freqfusion_tpu_torch.ops import hier as hier_ops
from freqfusion_tpu_torch.ops import lka as lka_ops
from freqfusion_tpu_torch.ops.hier import (hier_stage3_fused_reference,
                                           plan_hier)
from freqfusion_tpu_torch.ops.lka import (fold_lka, lka_block_fused_reference,
                                          plan_lka)
from test_torch_tf32_gemm import _close, _gelu, product

SM_SMEM = 233472     # bytes of shared memory an SM has for blocks (228 KB)
BLOCK_SMEM = 232448  # a block's limit (227 KB)
BLOCK_RESERVED = 1024  # the runtime's reserve a block
# the card tests' border shapes and the 1344x2048 HR size of the 336x512
# bucket (#19); the bucket itself (#18)
BORDER_SHAPES = [(13, 18), (45, 70), (112, 144)]
HR = (1344, 2048)


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v.astype(np.float64)))


# ------------------------------------------------------------ #19's plan


@pytest.mark.parametrize("hw", [HR, *BORDER_SHAPES])
def test_hier_plan(hw):
    """Cin 76 -> 80; conv0 two blocks of 4 n-tiles a tile, conv1 and the
    residual block's one, all four on 24-row tiles; to_rgb's 2 and 1 n-tiles
    (Cout 3 padded to 8) on 32-row tiles; shared memory under the limit
    with the two blocks an SM the launch bounds ask."""
    h, w = hw
    p = plan_hier(h, w, 76)
    want = [(76, 64, 80, 64, 4, 3), (64, 32, 64, 32, 4, 3),
            (32, 32, 32, 32, 4, 3), (32, 32, 32, 32, 4, 3),
            (32, 16, 32, 16, 2, 4), (16, 3, 16, 8, 1, 4)]
    assert [c[:6] for c in p.convs] == want
    for c in p.convs:
        rows = 8 * c.mt
        assert c.tiles == -(-h // rows) * -(-w // hier_ops.TILE_W)
        assert c.blocks == c.tiles * c.coutp // (8 * c.nt)
        assert c.smem <= BLOCK_SMEM
        assert 2 * (c.smem + BLOCK_RESERVED) <= SM_SMEM
        assert c.cinp % hier_ops.CK == 0
    assert p.scratch_floats == 18 * sum(c.cinp * c.coutp for c in p.convs)
    if hw == HR:  # 24 x 16 tiles for three m-tiles a warp, 32 x 16 for 4
        assert p.convs[0].tiles == 56 * 128 and p.convs[5].tiles == 42 * 128


def test_hier_plan_pads_other_widths():
    p = plan_hier(20, 36, 35)
    assert (p.convs[0].cin, p.convs[0].cinp) == (35, 40)


# ------------------------------------------------------ #19's arithmetic


def conv_model(x, w, b, cinp, terms=3):
    """csrc/conv3x3_tf32.cuh's conv: x [B, H, W, Cin] zero-padded to cinp
    channels and by one pixel, K taken as (stage of 8 channels, tap, channel)
    in 3xTF32 k8 steps (`terms` 1: hi*hi alone), + bias."""
    bsz, h, w_, cin = x.shape
    cout = w.shape[-1]
    xp = np.zeros((bsz, h + 2, w_ + 2, cinp), np.float32)
    xp[:, 1:-1, 1:-1, :cin] = x
    wp = np.zeros((3, 3, cinp, cout), np.float32)
    wp[:, :, :cin] = w
    cols, rows = [], []
    for s in range(cinp // 8):
        for dy in range(3):
            for dx in range(3):
                cols.append(xp[:, dy:dy + h, dx:dx + w_, 8 * s:8 * s + 8]
                            .reshape(-1, 8))
                rows.append(wp[dy, dx, 8 * s:8 * s + 8])
    y = product(np.concatenate(cols, 1), np.concatenate(rows, 0), terms)
    y = y.reshape(bsz, h, w_, cout)
    return y if b is None else (y + b).astype(np.float32)


def hier_model(s3, p, terms=3):
    """csrc/hier.cu's chain on the padded extents of plan_hier."""
    def n(t):
        return t.numpy()

    plan = plan_hier(s3.shape[1], s3.shape[2], s3.shape[3])
    cp = [c.cinp for c in plan.convs]

    def conv(x, q, i, bias=True):
        return conv_model(x, n(q["kernel"]), n(q["bias"]) if bias else None,
                          cp[i], terms)
    a = _gelu(conv(s3, p["stage3_conv_0"], 0))
    a = _gelu(conv(a, p["stage3_conv_2"], 1))
    g = p["stage3_gate"]  # conv1's epilogue, fp32
    hid = _gelu((a @ n(g["gate_0"]["kernel"][0, 0])
                 + n(g["gate_0"]["bias"])).astype(np.float32))
    gs = hid @ n(g["gate_2"]["kernel"][0, 0]) + n(g["gate_2"]["bias"])
    f = (a * _sigmoid(gs)).astype(np.float32)
    r = p["stage3_res"]
    u = _gelu(conv(f, r["block_0"], 2, False))
    f3 = (f + float(r["scale"]) * conv(u, r["block_2"], 3, False)
          + float(p["rw23"]) * s3[..., :32]).astype(np.float32)
    v = _gelu(conv(f3, p["to_rgb_0"], 4))
    return _sigmoid(conv(v, p["to_rgb_2"], 5)).astype(np.float32)


def _conv_tree(rng, k, cin, cout, bias=True, scale=1.0):
    t = {"kernel": torch.from_numpy((scale * rng.normal(size=(k, k, cin, cout))
                                     / np.sqrt(k * k * cin)).astype(np.float32))}
    if bias:
        t["bias"] = torch.from_numpy(
            (0.1 * rng.normal(size=cout)).astype(np.float32))
    return t


def _hier_tree(rng, scale=1.0):
    return {"stage3_conv_0": _conv_tree(rng, 3, 76, 64, scale=scale),
            "stage3_conv_2": _conv_tree(rng, 3, 64, 32, scale=scale),
            "stage3_gate": {"gate_0": _conv_tree(rng, 1, 32, 8),
                            "gate_2": _conv_tree(rng, 1, 8, 1)},
            "stage3_res": {"block_0": _conv_tree(rng, 3, 32, 32, False, scale),
                           "block_2": _conv_tree(rng, 3, 32, 32, False, scale),
                           "scale": torch.tensor(0.7)},
            "rw23": torch.tensor(0.3),
            "to_rgb_0": _conv_tree(rng, 3, 32, 16, scale=scale),
            "to_rgb_2": _conv_tree(rng, 3, 16, 3, scale=scale)}


@pytest.mark.parametrize("nchw", [False, True])
def test_hier_model_matches_reference(nchw):
    """The model of the kernel's arithmetic at B 2, 20 x 36 (three tiles
    across, the last partial; fewer rows than a tile), s3_in NHWC and as an
    NCHW view, within FUSED_REL_TOL of the plain version."""
    rng = np.random.default_rng(19 + nchw)
    p = _hier_tree(rng)
    a = rng.uniform(size=(2, 76, 20, 36) if nchw else (2, 20, 36, 76))
    t = torch.from_numpy(a.astype(np.float32))
    s3 = t.permute(0, 2, 3, 1) if nchw else t
    want = hier_stage3_fused_reference(s3, p).numpy()
    _close(hier_model(np.ascontiguousarray(s3.numpy()), p), want)


# ------------------------------------------------------------ #18's plan


@pytest.mark.parametrize("c,rows,warps,ring", [(64, 64, 8, 4),
                                               (128, 96, 12, 4)])
def test_lka_plan(c, rows, warps, ring):
    """Phase 3's C 64 and phase 4's C 128 at 336x512: the mix's rows,
    warps and ring, shared memory under the limit with the blocks an SM its
    launch bounds ask (two blocks at C 64, one at C 128; the depthwise pass
    two), the weight stream of 5 Cp / 16 stages, and the scratch."""
    h, w = 336, 512
    p = plan_lka(1, h, w, c, 2 * c)
    assert (p.cp, p.rows, p.warps, p.ring) == (c, rows, warps, ring)
    assert p.stages == 5 * c // 16
    assert p.mix_blocks == -(-h * w // rows)
    assert p.mix_smem <= BLOCK_SMEM
    assert (2 if c == 64 else 1) * (p.mix_smem + BLOCK_RESERVED) <= SM_SMEM
    assert 2 * (p.dw_smem + BLOCK_RESERVED) <= SM_SMEM
    assert p.dw_blocks == 11 * 16 * c // 4
    assert p.scratch_floats == 10 * c * c + 5 * c + c * h * w


@pytest.mark.parametrize("c,ch,cp", [(60, 120, 64), (4, 8, 64),
                                     (100, 256, 128)])
def test_lka_plan_pads_other_widths(c, ch, cp):
    assert plan_lka(2, 13, 18, c, ch).cp == cp


@pytest.mark.parametrize("c,ch", [(130, 260), (62, 124), (64, 129)])
def test_lka_plan_refuses(c, ch):
    with pytest.raises(ValueError):
        plan_lka(1, 8, 8, c, ch)


# ------------------------------------------------------ #18's arithmetic


def _lka_tree(rng, c, ch, scale=1.0):
    def t(*shape, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32))

    def bn():
        return {"scale": 1 + t(c, s=0.1), "bias": t(c, s=0.1),
                "mean": t(c, s=0.1),
                "var": torch.from_numpy(rng.uniform(0.5, 1.5, c)
                                        .astype(np.float32))}
    return {"norm1": bn(), "norm2": bn(),
            "lka": {"local_conv": {"kernel": t(5, 5, 1, c, s=0.2)},
                    "h_conv": {"kernel": t(1, 21, 1, c, s=0.2)},
                    "v_conv": {"kernel": t(21, 1, 1, c, s=0.2)},
                    "pw_conv": {"kernel": t(1, 1, c, c, s=scale / c ** 0.5)},
                    "bn": bn()},
            "ffn_0": {"kernel": t(1, 1, c, ch, s=scale / c ** 0.5),
                      "bias": t(ch, s=0.1)},
            "ffn_2": {"kernel": t(1, 1, ch, c, s=scale / ch ** 0.5),
                      "bias": t(c, s=0.1)},
            "scale1": torch.tensor(0.6), "scale2": torch.tensor(0.8)}


def _pad(m, rows, cols):
    out = np.zeros((rows, cols), np.float32)
    out[:m.shape[0], :m.shape[1]] = m
    return out


def lka_model(x, p, terms=3):
    """csrc/lka.cu's arithmetic: the depthwise chain in fp32 (the plain
    version's), then the mix on the padded width Cp with the folded
    weights: x1 from a pw' in 3xTF32, the hidden in two chunks of Cp
    columns, the down product accumulating over both chunks' K in order."""
    b, h, w, c = x.shape
    ch = p["ffn_0"]["kernel"].shape[-1]
    cp = plan_lka(b, h, w, c, ch).cp
    fold = {k: v.numpy() for k, v in fold_lka(p).items()}
    lka = p["lka"]
    xt = torch.from_numpy(x)
    t = xt * fold_lka(p)["s1"] + fold_lka(p)["b1"]
    a = t
    for k in ("local_conv", "h_conv", "v_conv"):
        a = lka_ops._dw(a, lka[k]["kernel"])
    a, t = a.numpy().reshape(-1, c), t.numpy().reshape(-1, c)
    xr = x.reshape(-1, c)
    pre = product(_pad(a, len(a), cp), _pad(fold["pw"], cp, cp), terms)[:, :c]
    x1 = (xr + float(p["scale1"]) * (t * _sigmoid(pre + fold["bbn"]))
          ).astype(np.float32)
    f0 = _pad(fold["f0"], cp, 2 * cp)
    c0 = np.zeros(2 * cp, np.float32)
    c0[:ch] = fold["c0"]
    hid = np.concatenate([
        _gelu((product(_pad(x1, len(x1), cp), f0[:, j * cp:(j + 1) * cp],
                       terms) + c0[j * cp:(j + 1) * cp]).astype(np.float32))
        for j in range(2)], 1)
    f2 = _pad(p["ffn_2"]["kernel"][0, 0].numpy(), 2 * cp, cp)
    f = product(hid, f2, terms)[:, :c]
    out = x1 + float(p["scale2"]) * (f + p["ffn_2"]["bias"].numpy())
    return out.astype(np.float32).reshape(b, h, w, c)


@pytest.mark.parametrize("c", [64, 128])
def test_lka_folding_matches_reference(c):
    """The folded weights in plain fp32 PyTorch (pw' = pw diag(sbn), f0' =
    diag(s2) f0, c0' = c0 + b2 f0) give the block within FUSED_REL_TOL."""
    rng = np.random.default_rng(c)
    p = _lka_tree(rng, c, 2 * c)
    x = torch.from_numpy(rng.normal(size=(2, 12, 20, c)).astype(np.float32))
    fold = fold_lka(p)
    lka = p["lka"]
    t = x * fold["s1"] + fold["b1"]
    a = t
    for k in ("local_conv", "h_conv", "v_conv"):
        a = lka_ops._dw(a, lka[k]["kernel"])
    x1 = x + p["scale1"] * (t * torch.sigmoid(a @ fold["pw"] + fold["bbn"]))
    hid = F.gelu(x1 @ fold["f0"] + fold["c0"])
    out = x1 + p["scale2"] * (hid @ p["ffn_2"]["kernel"][0, 0]
                              + p["ffn_2"]["bias"])
    _close(out.numpy(), lka_block_fused_reference(x, p).numpy())


@pytest.mark.parametrize("c,ch", [(64, 128), (128, 256), (60, 120)])
def test_lka_model_matches_reference(c, ch):
    """The model of the mix's padded 3xTF32 arithmetic on the folded
    weights at phase 3's and phase 4's widths and at C 60 (padded to 64),
    B 2 on a 12 x 20 image, within FUSED_REL_TOL of the plain version."""
    rng = np.random.default_rng(c + 1)
    p = _lka_tree(rng, c, ch)
    x = rng.normal(size=(2, 12, 20, c)).astype(np.float32)
    want = lka_block_fused_reference(torch.from_numpy(x), p).numpy()
    _close(lka_model(x, p), want)


def test_lka_needs_the_lo_products():
    """Large inputs and weights (x 8 + N(0, 1), products 4x their fan-in
    scale): the 3xTF32 model holds FUSED_REL_TOL where hi*hi alone misses
    it, so the card's precision guard can tell the two apart."""
    rng = np.random.default_rng(7)
    p = _lka_tree(rng, 128, 256, scale=4.0)
    x = (8 + rng.normal(size=(1, 8, 12, 128))).astype(np.float32)
    want = lka_block_fused_reference(torch.from_numpy(x), p).numpy()
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    assert np.abs(lka_model(x, p) - want).max() <= tol
    assert np.abs(lka_model(x, p, terms=1) - want).max() > tol
