"""3xTF32 arithmetic and the tile plans of the fused FFN and the CAB
convolutions, on the CPU.

``csrc/fused_mlp.cu`` (TPU kernel #14) and ``csrc/cab.cu`` (#15) compute
their products on the tensor cores in TF32, three products each
(``csrc/tf32_mma.cuh``): x = hi + lo with hi = x rounded to TF32 (to
nearest, ties away from zero, 10 mantissa bits, on the float's bits) and
lo = x - hi, which the tensor core truncates to its top 10 mantissa bits;
a product is lo*hi + hi*lo + hi*hi, summed in fp32 in k8 steps. These
tests hold a numpy model of that rounding to the value it must give, hold
the 3xTF32 sum to float64 at the K the kernels reach (FFN: C up to 308,
Ch up to 976; CAB: 9 x 180 = 1620; NAFBlock: C up to 1024, on
``csrc/tf32_gemm.cuh`` with #11's projections, whose plans and model are
``test_torch_nafblock_plan.py``) inside ``FUSED_REL_TOL`` where one TF32
product misses it, and check the plans ``ops/mlp.py:plan_fused_mlp`` and
``ops/cab.py:plan_cab`` make at the path's shapes: padding of widths that
are 4 mod 8, edge tiles, shared memory under the card's limit, and models
of both kernels' padded arithmetic against the plain versions. The card
tests (``tests/test_torch_kernels_cuda.py``) run the kernels themselves.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from freqfusion_tpu_torch.ops import cab as cab_ops
from freqfusion_tpu_torch.ops import mlp as mlp_ops
from freqfusion_tpu_torch.ops.cab import plan_cab
from freqfusion_tpu_torch.ops.mlp import (fused_mlp_block_reference,
                                          plan_fused_mlp)

# fused kernels against their plain versions: max-abs error relative to
# max(1, max |out|) (chip_smoke.py and the card tests)
FUSED_REL_TOL = 1e-4
# the path's shapes: the FFN at DRCT-L's five widths (pre-norm) and GRL-B's
# (post-norm); the CAB at GRL-B's and MambaIR's widths
FFN_SHAPES = [(180, 720), (212, 848), (244, 976), (276, 276), (308, 308),
              (180, 360)]
CAB_SHAPES = [(180, 45), (180, 60)]
ROWS = 336 * 512  # the 336x512 bucket's tokens


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 as csrc/tf32_mma.cuh:tf32_rna does it: add half
    of the 13 dropped bits to the float's bits, clear them."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_value(x: np.ndarray) -> np.ndarray:
    """The same rounding on the value, in float64: to the nearest multiple
    of 2^(e - 10) for x in [2^e, 2^(e + 1)), halves away from zero."""
    x = np.asarray(x, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.abs(x))) - 10)
    return (np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp).astype(
        np.float32)


def tf32_trunc(x: np.ndarray) -> np.ndarray:
    """x as the tensor core reads a TF32 operand: its top 10 mantissa
    bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    """(hi, lo) as the tensor core sees them."""
    x = np.asarray(x, np.float32)
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def product(a: np.ndarray, b: np.ndarray, terms: int = 3) -> np.ndarray:
    """a @ b in k8 steps, each lo*hi + hi*lo + hi*hi (terms 3) or hi*hi
    alone (terms 1) of the split operands, added to an fp32 sum. The
    products of a step are exact in float64 (10-bit mantissas)."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        ah, al = split(a[:, k0:k0 + 8])
        bh, bl = split(b[k0:k0 + 8])
        pairs = [(al, bh), (ah, bl), (ah, bh)] if terms == 3 else [(ah, bh)]
        for p, q in pairs:
            acc = (acc + p.astype(np.float64) @ q.astype(np.float64)).astype(
                np.float32)
    return acc


def _gelu(v: np.ndarray) -> np.ndarray:
    return F.gelu(torch.from_numpy(np.ascontiguousarray(v))).numpy()


def _layer_norm(v: np.ndarray, s, b, eps: float = 1e-5) -> np.ndarray:
    mu = v.mean(-1, keepdims=True)
    var = ((v - mu) ** 2).mean(-1, keepdims=True)
    return ((v - mu) / np.sqrt(var + eps) * s + b).astype(np.float32)


def _close(got: np.ndarray, want: np.ndarray) -> None:
    tol = FUSED_REL_TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


# ---------------------------------------------------------------- rounding


@pytest.mark.parametrize("bits,want", [
    (0x3F800FFF, 0x3F800000),   # below half an ulp: down
    (0x3F801000, 0x3F802000),   # a tie: away from zero
    (0xBF801000, 0xBF802000),   # a negative tie: away from zero
    (0x3F801001, 0x3F802000),   # above half: up
    (0x3FFFF000, 0x40000000),   # rounding carries into the exponent
])
def test_tf32_rounding_on_the_bits(bits, want):
    x = np.array([bits], np.uint32).view(np.float32)
    assert int(tf32_rna(x).view(np.uint32)[0]) == want


def test_tf32_rounding_matches_the_value():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=20000) * np.exp2(rng.integers(-30, 30, 20000))
         ).astype(np.float32)
    ties = (x.view(np.uint32) & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
    x = np.concatenate([x, ties.view(np.float32)])
    np.testing.assert_array_equal(tf32_rna(x), tf32_value(x))


def test_split_keeps_every_bit():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=20000) * 10.0 ** rng.uniform(-6, 6, 20000)).astype(
        np.float32)
    hi = tf32_rna(x)
    lo = (x - hi).astype(np.float32)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    np.testing.assert_array_equal((hi + lo).astype(np.float32), x)
    assert (np.abs(lo) <= np.abs(x) * 2.0 ** -11).all()


@pytest.mark.parametrize("k", [180, 308, 976, 1024, 1620])
def test_three_products_hold_the_tolerance_one_misses_it(k):
    """Activations near unit scale against fan-in scaled weights, as the
    kernels see them (K 1024: the NAFBlock's widest products): 3xTF32
    stays far inside FUSED_REL_TOL of the float64 sum, one TF32 product a
    step misses it."""
    rng = np.random.default_rng(k)
    a = rng.normal(size=(64, k)).astype(np.float32)
    b = (rng.normal(size=(k, 64)) / np.sqrt(k)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    tol = FUSED_REL_TOL * max(1.0, float(np.abs(want).max()))
    three = float(np.abs(product(a, b, 3) - want).max())
    one = float(np.abs(product(a, b, 1) - want).max())
    assert three <= tol / 20, (three, tol)
    assert one > tol, (one, tol)


# ---------------------------------------------------------------- FFN (#14)


@pytest.mark.parametrize("c,ch", FFN_SHAPES)
def test_ffn_plan_at_path_shapes(c, ch):
    p = plan_fused_mlp(ROWS, c, ch)
    bk, up = mlp_ops.BK, p.upn
    # K past C, hidden past Ch and N past C are zero-padded to whole tiles;
    # widths of 4 mod 8 (every C, and Ch 276, 308) are padded
    assert p.kp1 % bk == 0 and 0 <= p.kp1 - c < bk
    assert p.kp2 % bk == 0 and 0 <= p.kp2 - ch < bk
    assert p.np1 % up == 0 and 0 <= p.np1 - ch < up
    # the up block's width pads Ch least: 128 at 720, 848, 976, 360; 64 at
    # 276 and 308 (320 columns, not 384)
    assert up == (64 if ch in (276, 308) else 128)
    assert p.cp == 32 * p.nt and p.cp >= c
    assert p.nt == min(n for n in mlp_ops.DOWN_TILES if 32 * n >= c)
    if c % 8 == 4:
        assert p.kp1 > c and p.cp > c
    if ch % 8 == 4:
        assert p.kp2 > ch
    # under the card's shared memory a block can have; two up blocks an SM
    # (three of the narrow ones), and two down blocks up to 8 n-tiles a warp
    # (228 KB an SM, 1 KB of it each block's)
    assert max(p.up_smem, p.down_smem) <= mlp_ops.SMEM_LIMIT
    assert (2 if up == 128 else 3) * (p.up_smem + 1024) <= 233472
    if p.nt <= 8:
        assert 2 * (p.down_smem + 1024) <= 233472
    assert p.up_blocks == (p.np1 // up) * -(-ROWS // mlp_ops.UP_ROWS)
    assert p.down_blocks == -(-ROWS // mlp_ops.DOWN_ROWS)
    mp = -(-ROWS // mlp_ops.UP_ROWS) * mlp_ops.UP_ROWS
    assert p.scratch_floats == (2 * p.kp1 * p.np1 + 2 * p.kp2 * p.cp
                                + mp * (p.kp2 + p.kp1))


def test_ffn_plan_rejects_wide_rows():
    plan_fused_mlp(10, mlp_ops.MAX_CHANNELS, 64)
    with pytest.raises(ValueError):
        plan_fused_mlp(10, mlp_ops.MAX_CHANNELS + 1, 64)


def model_fused_mlp(x, w1, b1, w2, b2, s, b, prenorm, res_scale, eps=1e-5):
    """The kernel's arithmetic on its padded extents: T zero-padded to kp1
    columns, W1 to [kp1, np1], H = gelu(T W1 + b1) on all np1 columns (its
    first kp2 kept, as the scratch keeps them), W2 zero-padded to [kp2,
    cp]; both products in 3xTF32; the post-norm LayerNorm over the first
    C columns. Returns (out, H, the down product's padded columns)."""
    m, c = x.shape
    ch = w1.shape[1]
    p = plan_fused_mlp(m, c, ch)
    t = _layer_norm(x, s, b, eps) if prenorm else x
    tp = np.zeros((m, p.kp1), np.float32)
    tp[:, :c] = t
    w1p = np.zeros((p.kp1, p.np1), np.float32)
    w1p[:c, :ch] = w1
    b1p = np.zeros(p.np1, np.float32)
    b1p[:ch] = b1
    h = _gelu(product(tp, w1p) + b1p)[:, :p.kp2]
    w2p = np.zeros((p.kp2, p.cp), np.float32)
    w2p[:ch, :c] = w2
    b2p = np.zeros(p.cp, np.float32)
    b2p[:c] = b2
    y = product(h, w2p) + b2p
    pad = y[:, c:]
    y = y[:, :c]
    if not prenorm:
        y = _layer_norm(y, s, b, eps)
    return (x + res_scale * y).astype(np.float32), h, pad


@pytest.mark.parametrize("c,ch", [(20, 44), (44, 76)])
@pytest.mark.parametrize("prenorm", [True, False])
def test_ffn_model_matches_the_plain_version(c, ch, prenorm):
    """Widths of 4 mod 8 and 70 rows (a ragged tile): the padded model is
    within FUSED_REL_TOL of fused_mlp_block_reference, and the padding
    never reaches the output: H's columns past Ch and the down product's
    columns past C are exactly zero."""
    rng = np.random.default_rng(c + ch + prenorm)
    x = rng.normal(size=(70, c)).astype(np.float32)
    w1 = (rng.normal(size=(c, ch)) / np.sqrt(c)).astype(np.float32)
    w2 = (rng.normal(size=(ch, c)) / np.sqrt(ch)).astype(np.float32)
    b1, b2, lb = (0.1 * rng.normal(size=n) for n in (ch, c, c))
    ls = 1 + 0.1 * rng.normal(size=c)
    args = [a.astype(np.float32) for a in (x, w1, b1, w2, b2, ls, lb)]
    got, h, pad = model_fused_mlp(*args, prenorm, 0.75)
    want = fused_mlp_block_reference(*(torch.from_numpy(a) for a in args),
                                     prenorm, 0.75).numpy()
    _close(got, want)
    assert not h[:, ch:].any()
    assert not pad.any()


# ---------------------------------------------------------------- CAB (#15)


@pytest.mark.parametrize("c,cr", CAB_SHAPES)
@pytest.mark.parametrize("h,w,tiles", [(336, 512, 672), (100, 140, 63),
                                       (8, 12, 1), (5, 3, 1)])
def test_cab_plan(c, cr, h, w, tiles):
    p = plan_cab(h, w, c, cr)
    assert p.tiles == tiles
    # conv1 C -> Cr: K a tap padded to 8; N 45 -> one block of 48, 60 ->
    # two of 32
    assert p.cinp1 % cab_ops.CK == 0 and 0 <= p.cinp1 - c < cab_ops.CK
    assert (p.coutp1, p.nt1) == {45: (48, 6), 60: (64, 4)}[cr]
    assert p.blocks1 == tiles * p.coutp1 // (8 * p.nt1)
    # conv2 Cr -> C: K a tap 45 -> 48 or 60 -> 64, N 180 -> 4 blocks of 48
    assert p.cinp2 == {45: 48, 60: 64}[cr]
    assert (p.coutp2, p.nt2) == (192, 6) and p.blocks2 == 4 * tiles
    # two blocks an SM (228 KB of shared memory, 1 KB of it each block's)
    assert 2 * (max(p.smem1, p.smem2) + 1024) <= 233472
    assert p.scratch_floats == 18 * (p.cinp1 * p.coutp1 + p.cinp2 * p.coutp2)


def test_cab_plan_rejects_wide_channels():
    plan_cab(8, 8, cab_ops.MAX_CHANNELS, 64)
    with pytest.raises(ValueError):
        plan_cab(8, 8, cab_ops.MAX_CHANNELS + 1, 64)


def model_conv3x3(x, k, bias):
    """The conv kernel's implicit GEMM on [H, W, Cin]: the image zero-padded
    by one pixel and its channels to cinp, K = 9 cinp taken tap by tap and
    8 channels a step, each tap's A the padded image shifted by (dy, dx),
    in 3xTF32; N zero-padded to whole blocks. Returns (out, the padded
    output channels)."""
    h, w, cin = x.shape
    cout = k.shape[-1]
    cinp = -(-cin // cab_ops.CK) * cab_ops.CK
    coutp = -(-cout // (8 * cab_ops.conv_tiles(cout))) * 8 * \
        cab_ops.conv_tiles(cout)
    xp = np.zeros((h + 2, w + 2, cinp), np.float32)
    xp[1:-1, 1:-1, :cin] = x
    kp = np.zeros((3, 3, cinp, coutp), np.float32)
    kp[:, :, :cin, :cout] = k
    acc = np.zeros((h * w, coutp), np.float32)
    for c0 in range(0, cinp, cab_ops.CK):  # a stage: 8 channels, 9 taps
        for dy in range(3):
            for dx in range(3):
                a = xp[dy:dy + h, dx:dx + w, c0:c0 + 8].reshape(h * w, 8)
                acc = acc + product(a, kp[dy, dx, c0:c0 + 8])
    out = acc + np.pad(bias, (0, coutp - cout))
    return out[:, :cout].reshape(h, w, cout), out[:, cout:]


@pytest.mark.parametrize("cin,cout", [(180, 45), (45, 180), (60, 180)])
def test_cab_conv_model_matches_conv2d(cin, cout):
    """Both convs' widths (conv1 180 -> 45, conv2 45 or 60 -> 180) on a
    20 x 23 image (neither side a multiple of the 16-pixel tile): the
    model is within FUSED_REL_TOL of F.conv2d, and the padded output
    channels are exactly zero before the bias (which is padded with
    zeros)."""
    rng = np.random.default_rng(cin + cout)
    x = rng.normal(size=(20, 23, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    bias = (0.1 * rng.normal(size=cout)).astype(np.float32)
    got, pad = model_conv3x3(x, k, bias)
    want = cab_ops._conv3x3(torch.from_numpy(x)[None], {
        "kernel": torch.from_numpy(k), "bias": torch.from_numpy(bias)})[0]
    _close(got, want.numpy())
    assert not pad.any()
