"""The bf16 fused FFN (#14) and CAB (#15) on the wgmma kernels, on the CPU,
without JAX: their plans (ops/wgmma.py:plan_ffn_bf16, plan_cab_bf16), the
CAB's tap-major conv layout read back as csrc/cab.cu's producer streams
it, a numpy model of the convs' shifted-descriptor addressing of one
staged halo against an im2col, the FFN's hidden written in the order its
down launch reads, the models handing views of their parameters under the
gates, and the layouts' cache.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from freqfusion_tpu_torch.models import drct, grl
from freqfusion_tpu_torch.ops import wgmma

# DRCT-L's five FFN widths (pre-norm) and GRL-B's (post-norm)
FFN_SHAPES = [(180, 720, True), (212, 848, True), (244, 976, True),
              (276, 276, True), (308, 308, True), (180, 360, False)]
P = 336 * 512


@pytest.mark.parametrize("c,ch,pre", FFN_SHAPES + [(20, 76, False)])
def test_plan_ffn_bf16(c, ch, pre):
    """Two launches: the up launch's chunk pads Ch least (the wider on a
    tie) and two of its 64-row blocks share an SM; the down launch's
    128-row blocks span all of C in chunks of at most 160 sums a thread;
    H's scratch is [Mp][Ch padded to 32] bf16; shared memory fits."""
    p = wgmma.plan_ffn_bf16(P, c, ch)
    assert p.bn1 in (64, 96, 128)
    assert all(-(-ch // p.bn1) * p.bn1 <= -(-ch // bn) * bn
               for bn in (64, 96, 128))
    assert p.nch2 * p.bn2 >= c and p.nch2 * p.bn2 // 2 <= 160
    assert p.nch2 * p.bn2 - c < min(p.bn2, 64) or c <= 64
    assert (p.kp1, p.kp2) == (-(-c // 32) * 32, -(-ch // 32) * 32)
    assert p.scratch_bytes == -(-P // 128) * 128 * p.kp2 * 2
    assert p.blocks == -(-P // 128)
    assert max(p.up_smem, p.down_smem) <= 227 * 1024
    assert p.up_smem + 1024 <= 233472 // 2


def test_ffn_bf16_chunks_on_the_path():
    """The widths chip_smoke.py times: (bn1, bn2, nch2)."""
    got = [wgmma.plan_ffn_bf16(P, c, ch)[:3] for c, ch, _ in FFN_SHAPES]
    assert got == [(128, 96, 2), (96, 128, 2), (128, 128, 2), (96, 96, 3),
                   (64, 64, 5), (128, 96, 2)]


@pytest.mark.parametrize("c", [181, 322, 400])
def test_plan_ffn_bf16_refuses(c):
    with pytest.raises(ValueError):
        wgmma.plan_ffn_bf16(64, c, 4 * c)


def _tiled_off(m, k, kp):
    """csrc/bf16_wgmma.cuh:bw_tiled_off."""
    r, q = m & 127, (k % 32) >> 3
    return (((m >> 7) * (kp // 32) + k // 32) * 8192 + (q >> 1) * 128 * 32
            + (r >> 3) * 256 + (q & 1) * 128 + (r & 7) * 16 + (k & 7) * 2)


@pytest.mark.parametrize("ch", [720, 848, 276, 76])
def test_ffn_hidden_lands_in_the_tiled_order(ch):
    """The up launch's stores of chunk c from a 64-row block (its shared
    tile at (col / 32) 4096 + bw_a_off(row, col % 32 / 8, 64) + col % 8 *
    2; piece i, 2 KB, to H's 128-row tile at (c bn1 / 32 2 + i) 4096, plus
    2048 for the tile's second half; min(bn1, kp2 - c bn1) / 16 pieces)
    put every H element where the down launch's stages read it
    (bw_tiled_off), each once, nothing past kp2."""
    p = wgmma.plan_ffn_bf16(256, 20, ch)
    seen = set()
    for blk in range(4):  # two 128-row tiles, both halves
        m0 = 64 * blk
        h0 = (m0 >> 7) * (p.kp2 // 32) * 8192 + ((m0 >> 6) & 1) * 2048
        for c in range(-(-ch // p.bn1)):
            pieces = 2 * (min(p.bn1, p.kp2 - c * p.bn1) // 32)
            for row in range(0, 64, 5):
                for col in range(0, pieces * 16, 2):
                    q = (col & 31) >> 3
                    tile = ((col >> 5) * 4096 + (q >> 1) * 64 * 32
                            + (row >> 3) * 256 + (q & 1) * 128
                            + (row & 7) * 16 + (col & 7) * 2)
                    i = tile // 2048  # the 2 KB piece holding it
                    assert i < pieces
                    got = (h0 + (c * (p.bn1 // 32) * 2 + i) * 4096
                           + tile % 2048)
                    n = c * p.bn1 + col
                    assert got == _tiled_off(m0 + row, n, p.kp2)
                    seen.add((m0 + row, n))
    assert len(seen) == 4 * len(range(0, 64, 5)) * p.kp2 // 2


@pytest.mark.parametrize("h,w,cr,bn1", [(336, 512, 45, 48),
                                        (336, 512, 60, 64),
                                        (100, 140, 45, 48), (5, 7, 60, 64),
                                        (1, 20, 45, 48)])
def test_plan_cab_bf16(h, w, cr, bn1):
    """conv1 4 rows x 64 columns a block (3 at N 64: 96 sums a thread
    either way), conv2 6 x 64: tiles, the halo's reads a pixel (conv2 at
    most 1.5; conv1 1.55 or 1.72), shared memory, at least two blocks an
    SM, U's scratch."""
    p = wgmma.plan_cab_bf16(h, w, 180, cr, 2)
    r1 = 4 if bn1 == 48 else 3
    assert p.bn1 == bn1 and p.cinp1 == 192 and p.nch2 == 2
    assert p.rows == (r1, 6) and r1 * bn1 // 2 == 96
    assert p.tiles1 == -(-h // r1) * -(-w // 64)
    assert p.tiles2 == -(-h // 6) * -(-w // 64)
    assert p.halo == ((r1 + 2) * 66, 8 * 66)
    assert p.reread[1] <= 1.5
    assert abs(p.reread[0] - (r1 + 2) * 66 / (r1 * 64)) < 1e-12
    assert max(p.smem) <= 227 * 1024
    assert min(p.blocks_per_sm) >= 2
    assert all(s + 1024 <= 233472 // 2 for s in p.smem)
    assert p.scratch_bytes == 2 * h * w * bn1 * 2


@pytest.mark.parametrize("c,cr", [(181, 45), (180, 65), (258, 60)])
def test_plan_cab_bf16_refuses(c, cr):
    with pytest.raises(ValueError):
        wgmma.plan_cab_bf16(8, 8, c, cr)


def _stage_read(flat, cinp, bn, c, kk, tap, g, h, i, e):
    """What the kernels read of conv_layout's flat bf16 elements for chunk
    c, 16-channel slice kk, tap: conv1's stage kk (nine taps, bn x 32
    bytes each) of chunk 0, conv2's stage 3 kk + tap // 3 of chunk c
    (three taps): the same offsets."""
    slice_ = (c * (cinp // 16) + kk) * 9 * bn * 16
    return flat[slice_ + tap * bn * 16 + g * 128 + h * 64 + i * 8 + e]


@pytest.mark.parametrize("cin,cout,bn", [(180, 45, 48), (180, 60, 64),
                                         (48, 180, 96), (64, 180, 96),
                                         (20, 7, 48)])
def test_conv_layout_read_back(cin, cout, bn):
    """Each HWIO element lands once, where the wgmma B descriptor of its
    (chunk, slice, tap) reads it (sbo 256 between 8-column groups, lbo 128
    between K halves); the padding (Cin to 16, Cout to bn) is zero."""
    vals = torch.arange(1, 9 * cin * cout + 1, dtype=torch.float64
                        ).view(3, 3, cin, cout)
    lay = wgmma.conv_layout(vals, bn)
    cinp, coutp = -(-cin // 16) * 16, -(-cout // bn) * bn
    assert tuple(lay.shape) == (coutp // bn, cinp // 16, 9, bn // 8, 2, 8, 8)
    flat = lay.numpy().ravel()
    np.testing.assert_array_equal(np.sort(flat[flat > 0]),
                                  np.arange(1, 9 * cin * cout + 1))
    src = vals.numpy()
    rng = np.random.default_rng(cin + cout)
    for _ in range(4000):
        c, kk = rng.integers(coutp // bn), rng.integers(cinp // 16)
        tap, g = rng.integers(9), rng.integers(bn // 8)
        h, i, e = rng.integers(2), rng.integers(8), rng.integers(8)
        k, n = 16 * kk + 8 * h + e, c * bn + 8 * g + i
        want = src[tap // 3, tap % 3, k, n] if k < cin and n < cout else 0
        assert _stage_read(flat, cinp, bn, c, kk, tap, g, h, i, e) == want


def test_conv_layout_bf16_is_exact():
    w = torch.randn(3, 3, 180, 60).to(torch.bfloat16)
    lay = wgmma.conv_layout(w, 64)
    assert lay.dtype == torch.bfloat16
    back = lay.permute(2, 1, 4, 6, 0, 3, 5).reshape(9, 192, 64)
    assert torch.equal(back[:, :180, :60].reshape(3, 3, 180, 60), w)


def _halo(t, y0, x0, rows):
    """A block's staged halo as the kernels lay it out: [8-channel group]
    [halo pixel][8], (rows + 2) x 66 pixels from (y0 - 1, x0 - 1) of t
    [H, W, Cp] (Cp a multiple of 16), zero outside the image."""
    hh, ww, cp = t.shape
    hw = wgmma.CAB_SEG + 2
    out = np.zeros((cp // 8, (rows + 2) * hw, 8), t.dtype)
    for p in range((rows + 2) * hw):
        y, x = y0 - 1 + p // hw, x0 - 1 + p % hw
        if 0 <= y < hh and 0 <= x < ww:
            out[:, p] = t[y, x].reshape(cp // 8, 8)
    return out.ravel()


def _halo_offset(tap, row):
    """The 16-byte unit at which csrc/cab.cu's A descriptor of tap (tap //
    3, tap % 3) for a block's output row `row` starts in the staged halo
    (rows of 66 pixels): the halo pixel of the m-tile's first output
    pixel, shifted by the tap."""
    return (row + tap // 3) * (wgmma.CAB_SEG + 2) + tap % 3


def _a_read(flat, npx, kk, tap, row):
    """The 64 x 16 A operand wgmma reads through the descriptor of (slice
    kk, tap, output row): start 2 kk groups + _halo_offset 16-byte units in,
    row r at (r // 8) sbo (128 bytes) + (r % 8) 16 bytes, K k at (k // 8)
    lbo (the halo's pixels x 16 bytes) + (k % 8) 2 bytes (bf16 elements)."""
    start = (2 * kk * npx + _halo_offset(tap, row)) * 8
    r = np.arange(64)[:, None]
    k = np.arange(16)[None, :]
    return flat[start + (r // 8) * 64 + (r % 8) * 8 + (k // 8) * npx * 8
                + (k % 8)]


@pytest.mark.parametrize("h,w", [(5, 7), (1, 20), (13, 140)])
@pytest.mark.parametrize("rows", [4, 3, 6])
@pytest.mark.parametrize("ln", [False, True])
def test_shifted_descriptors_match_im2col(h, w, rows, ln):
    """Every tap, output row, 16-channel slice and block of two images: the
    A rows the shifted descriptors read from one staged halo are the
    im2col rows of the conv input (LN'd when `ln`, zero outside the image
    after the LN, channels past C zero), for the block's in-image output
    pixels."""
    rng = np.random.default_rng(h * w + rows)
    c = 20
    cp = 32
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    t = x
    if ln:
        s, b = 1 + 0.1 * rng.normal(size=c), 0.1 * rng.normal(size=c)
        t = F.layer_norm(torch.from_numpy(x), (c,), torch.tensor(s).float(),
                         torch.tensor(b).float(), 1e-5).numpy()
    tp = np.zeros((2, h, w, cp), np.float32)
    tp[..., :c] = t
    # im2col with zero padding: col[b, y, x, tap, ch]
    pad = np.pad(tp, ((0, 0), (1, 1), (1, 1), (0, 0)))
    cols = np.stack([pad[:, dy:dy + h, dx:dx + w] for dy in range(3)
                     for dx in range(3)], 3)
    npx = (rows + 2) * (wgmma.CAB_SEG + 2)
    for b in range(2):
        for y0 in range(0, h, rows):
            for x0 in range(0, w, wgmma.CAB_SEG):
                flat = _halo(tp[b], y0, x0, rows)
                n = min(wgmma.CAB_SEG, w - x0)
                for tap in range(9):
                    for row in range(rows):
                        if y0 + row >= h:
                            continue
                        for kk in range(cp // 16):
                            got = _a_read(flat, npx, kk, tap, row)[:n]
                            want = cols[b, y0 + row, x0:x0 + n, tap,
                                        16 * kk:16 * kk + 16]
                            np.testing.assert_array_equal(got, want)


def _capture(monkeypatch, module, name):
    """Replace module.name by a recorder that returns its first argument."""
    seen = []

    def fake(x, *args, **kwargs):
        seen.append(args)
        return x
    monkeypatch.setattr(module, name, fake)
    return seen


def _is_view_of(t, param):
    return t._base is param and not t.is_inference()


@pytest.mark.parametrize("inference", [False, True])
def test_models_hand_views_of_their_parameters(monkeypatch, inference):
    """DRCT-L's and GRL-B's FFN halves and GRL-B's CAB, gated, in bf16:
    the weights they hand the kernels are views whose root is the
    parameter (so the layouts are built once per module), also under
    torch.inference_mode."""
    for gate in ("FREQFUSION_MLP", "FREQFUSION_CAB"):
        monkeypatch.setenv(gate, "1")
    ffn_drct = _capture(monkeypatch, drct, "fused_mlp_block")
    ffn_grl = _capture(monkeypatch, grl, "fused_mlp_block")
    cab = _capture(monkeypatch, grl, "cab_fused")
    d = drct.DRCT(upscale=4, embed_dim=48, num_layers=1, num_heads=6,
                  window_size=8, gc=8, mlp_ratio=2.0,
                  generator=torch.Generator().manual_seed(1)
                  ).to(torch.bfloat16)
    g = grl.GRL(upscale=4, embed_dim=48, depths=(2,), num_heads_w=3,
                num_heads_s=3, window_size=8,
                generator=torch.Generator().manual_seed(2)
                ).to(torch.bfloat16)
    swin = next(m for m in d.modules()
                if isinstance(m, drct.SwinTransformerBlock))
    block = g.layers[0].blocks[0]
    x = torch.randn(1, 16, 24, 48).to(torch.bfloat16)
    ctx = torch.inference_mode() if inference else torch.no_grad()
    with ctx:
        swin(x)
        block(x)
    for seen, owner in ((ffn_drct, swin.mlp), (ffn_grl, block.mlp)):
        w1, _, w2 = seen[0][:3]
        assert _is_view_of(w1, owner.fc1.weight)
        assert _is_view_of(w2, owner.fc2.weight)
        assert w1.shape == owner.fc1.weight.t().shape
    tree = cab[0][0]
    convs = block.conv.cab
    ca = convs[3].attention
    for key, conv in (("cab_0", convs[0]), ("cab_2", convs[2]),
                      ("ca_1", ca[1]), ("ca_3", ca[3])):
        assert _is_view_of(tree[key]["kernel"], conv.weight)
        assert torch.equal(tree[key]["kernel"],
                           conv.weight.permute(2, 3, 1, 0))


def test_mambair_cab_hands_views(monkeypatch):
    """MambaIR's LN -> CAB -> skip half (VSSBlock's CAB(dim, 3, 30) with
    ln_2 and skip_scale2) goes through the same CAB module: views too."""
    monkeypatch.setenv("FREQFUSION_CAB", "1")
    cab = _capture(monkeypatch, grl, "cab_fused")
    m = grl.CAB(48, 3, 30).to(torch.bfloat16)
    ln = torch.nn.LayerNorm(48).to(torch.bfloat16)
    skip = torch.nn.Parameter(torch.ones(48, dtype=torch.bfloat16))
    with torch.inference_mode():
        m.forward_nhwc(torch.randn(1, 8, 8, 48).to(torch.bfloat16), ln, skip)
    tree = cab[0][0]
    assert _is_view_of(tree["cab_0"]["kernel"], m.cab[0].weight)
    assert _is_view_of(tree["cab_2"]["kernel"], m.cab[2].weight)
    assert tuple(tree["cab_0"]["kernel"].shape) == (3, 3, 48, 16)


def test_conv_layout_cache():
    """Built once, reused while the weight stays; rebuilt after an in-place
    update and (after clear_weight_layouts) a write through .data; keyed
    apart from the GEMM layout of the same view."""
    wgmma.clear_weight_layouts()
    conv = torch.nn.Conv2d(40, 24, 3).to(torch.bfloat16)
    with torch.inference_mode():
        view = conv.weight.permute(2, 3, 1, 0)
        a = wgmma.conv_layouts(view, 48)
        assert wgmma.conv_layouts(conv.weight.permute(2, 3, 1, 0), 48) is a
        assert torch.equal(a, wgmma.conv_layout(view, 48))
    assert wgmma.conv_layouts(view, 64) is not a
    with torch.no_grad():
        conv.weight.mul_(2)
    b = wgmma.conv_layouts(conv.weight.permute(2, 3, 1, 0), 48)
    assert b is not a and torch.equal(b, 2 * a)
    conv.weight.data.copy_(torch.randn(24, 40, 3, 3))
    assert wgmma.conv_layouts(conv.weight.permute(2, 3, 1, 0), 48) is b
    wgmma.clear_weight_layouts()
    c = wgmma.conv_layouts(conv.weight.permute(2, 3, 1, 0), 48)
    assert c is not b and torch.equal(c, wgmma.conv_layout(
        conv.weight.detach().permute(2, 3, 1, 0), 48))
    flat = conv.weight.permute(2, 3, 1, 0)[1, 1]
    assert wgmma.weight_layouts(flat, 64) is not wgmma.conv_layouts(
        conv.weight.permute(2, 3, 1, 0), 48)


def test_ffn_layouts_reused_across_calls():
    """fc1.weight.t() handed twice (as DRCT's block does on every call)
    finds the first call's layout."""
    wgmma.clear_weight_layouts()
    fc = torch.nn.Linear(48, 96).to(torch.bfloat16)
    with torch.inference_mode():
        a = wgmma.weight_layouts(fc.weight.t(), 96)
        assert wgmma.weight_layouts(fc.weight.t(), 96) is a
    assert torch.equal(a, wgmma.weight_layout(fc.weight.detach().t(), 96))
