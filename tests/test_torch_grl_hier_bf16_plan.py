"""The bf16 GRL mixed attention's persistent kernel (#2 bf16, also #12
bf16's attention stage, ``csrc/grl_attention.cu``) and the bf16
hierarchical stage 3 on wgmma (#19 bf16, ``csrc/hier.cu``), on the CPU,
without JAX: #2's plan (ops/attention.py:plan_grl_attention_bf16), numpy
models of its staging (head boxes read from bulk-copied tile rows, anchor
rows at odd C/2 assembled from 16-byte words) and of its mask layout, the
mask table's cast; #19's plan (ops/hier.py:plan_hier_bf16), its conv
layouts read back as the kernel reads them, a numpy model of its halo
(bulk-copied planar rows, zeros outside the image, s3_in gathered from
NCHW) read through shifted descriptors against an im2col, and the
module handing views of its six 3x3 kernels.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from freqfusion_tpu_torch.models.fusion import hierarchical
from freqfusion_tpu_torch.ops import wgmma
from freqfusion_tpu_torch.ops.attention import (grl_mask_layout,
                                                plan_grl_attention_bf16)
from freqfusion_tpu_torch.ops.hier import HIER_BF16_N, plan_hier_bf16
from freqfusion_tpu_torch.ops.window_attention import (device_table,
                                                       shifted_window_mask,
                                                       table_as)

SMEM_BLOCK = 232448   # a block's shared memory at most (227 KB)


# --- #2 bf16 -------------------------------------------------------------

@pytest.mark.parametrize("c2,heads_w,heads_s,masked,hdp,warps", [
    (90, 3, 3, True, 32, 12), (90, 3, 3, False, 32, 12),
    (42, 6, 6, True, 16, 12), (45, 1, 5, False, 48, 8),
    (120, 2, 2, True, 64, 8), (180, 2, 6, True, 96, 8),
    (192, 2, 2, False, 96, 8)])
def test_grl_bf16_plan(c2, heads_w, heads_s, masked, hdp, warps):
    """The head box of the wider head, 12 warps up to box 32 and 8 past
    it, the deepest ring of 2 to 4 stages in 227 KB; a stage: q, k,
    v (64 C/2 bf16 each), then the bf16 mask tile or the anchor rows, a
    pad; the warps keep units (head, 16-row unit) in order."""
    p = plan_grl_attention_bf16(1, 336, 512, c2, heads_w, heads_s, masked)
    assert (p.hdp, p.warps) == (hdp, warps)
    extra = max(8192 if masked else 0, 8 * (-(-4 * c2 // 8) * 8))
    assert p.stage_bytes == -(-(384 * c2 + extra + 256) // 128) * 128
    x1s = 1
    assert p.smem == (128 + p.stages * p.stage_bytes
                      + 2 * -(-128 * c2 // 128) * 128
                      + 48 * x1s * heads_s * hdp)
    assert 2 <= p.stages <= 4 and p.smem <= SMEM_BLOCK
    assert p.stages == 4 or p.smem + p.stage_bytes > SMEM_BLOCK
    assert p.blocks == (66, 66)
    assert p.kept_w == tuple((u // 4, u % 4)
                             for u in range(min(warps, 4 * heads_w)))
    assert p.kept_s2 == tuple((u // 4, u % 4)
                              for u in range(min(warps, 4 * heads_s)))
    assert p.kept_s1 == tuple(w if w < heads_s else None
                              for w in range(warps))


def test_grl_bf16_plan_grl_b():
    """GRL-B at 336x512: every warp keeps one unit's terms (12 units a
    half, 12 warps), warps 0, 4 and 8 stage 1's of heads 0, 1 and 2 too
    (each head's four warps wait only for each other); one block an SM a
    half."""
    p = plan_grl_attention_bf16(1, 336, 512, 90, 3, 3, True)
    assert len(p.kept_w) == len(p.kept_s2) == p.warps == 12
    assert p.kept_s1 == (0, 1, 2) + (None,) * 9
    assert plan_grl_attention_bf16(1, 8, 16, 90, 3, 3, False).blocks == (2, 2)


@pytest.mark.parametrize("c2,heads_w,heads_s,match", [
    (194, 2, 2, "head dim 97 > 96"), (97, 1, 1, "head dim 97 > 96"),
    (400, 5, 5, "shared memory")])
def test_grl_bf16_plan_refuses(c2, heads_w, heads_s, match):
    """Refused past head box 96 and where two stages do not fit."""
    with pytest.raises(ValueError, match=match):
        plan_grl_attention_bf16(1, 8, 8, c2, heads_w, heads_s, True)


def _tile_rows(x: np.ndarray, b: int, ty: int, tx: int) -> np.ndarray:
    """A tile's stage as the producer's bulk copies land it: its 8 pixel
    rows, each 8 C2 contiguous values of the NHWC tensor, one after the
    other: [64, C2]."""
    c2 = x.shape[-1]
    flat = x.reshape(-1)
    h, w = x.shape[1:3]
    rows = [flat[((b * h + 8 * ty + y) * w + 8 * tx) * c2:][:8 * c2]
            for y in range(8)]
    return np.concatenate(rows).reshape(64, c2)


def _fragment_box(stage: np.ndarray, head: int, hd: int, hdp: int
                  ) -> np.ndarray:
    """A head's box as the units read it from the staged rows: lane (g, t)
    of k-step kk reads channels c = 16 kk + 8 e + 2 t and c + 1 of a row at
    the head's first channel (gb_pair), zero past hd."""
    box = np.zeros((stage.shape[0], hdp), stage.dtype)
    flat = stage.reshape(-1)
    c2 = stage.shape[1]
    for r in range(stage.shape[0]):
        for kk in range(hdp // 16):
            for e in range(2):
                for t in range(4):
                    c = 16 * kk + 8 * e + 2 * t
                    for d in (c, c + 1):
                        if d < hd:
                            box[r, d] = flat[r * c2 + head * hd + d]
    return box


@pytest.mark.parametrize("c2,heads", [(90, 3), (42, 6), (45, 3), (96, 1)])
def test_grl_bf16_head_boxes_from_tile_rows(c2, heads):
    """Head boxes rebuilt from the bulk-copied tile rows equal the tile's
    window partition, head by head (zeros past the head dim)."""
    rng = np.random.default_rng(c2)
    x = rng.normal(size=(2, 16, 24, c2)).astype(np.float32)
    hd = c2 // heads
    hdp = next(p for p in (16, 32, 48, 64, 96) if p >= hd)
    for b, ty, tx in ((0, 0, 0), (1, 1, 2), (0, 1, 1)):
        stage = _tile_rows(x, b, ty, tx)
        tile = x[b, 8 * ty:8 * ty + 8, 8 * tx:8 * tx + 8].reshape(64, c2)
        for h in range(heads):
            want = np.zeros((64, hdp), np.float32)
            want[:, :hd] = tile[:, h * hd:(h + 1) * hd]
            np.testing.assert_array_equal(_fragment_box(stage, h, hd, hdp),
                                          want)


def _anchor_rows(mem: np.ndarray, first: int, step: int, c2: int) -> tuple:
    """gb_anchor_rows on the uint16 memory `mem` (element 0 16-byte
    aligned): the four rows of 4 C2 values at element `first` + y `step`,
    into rows of ld = 4 C2 padded to 8, word k (8 values) of a row from
    16-byte loads: one at 8 k where the row is aligned (the last word of
    an odd row an 8-byte load), else the upper half of the aligned word at
    8 k - 4 and the lower half of the one at 8 k + 4 (none past the row);
    the staged rows and the 16-byte words loaded."""
    n = 4 * c2
    ld = -(-n // 8) * 8
    out = np.zeros((4, ld), np.uint16)
    loads = set()
    for y in range(4):
        row = first + y * step
        for k in range(ld // 8):
            if row % 8 == 0:
                if 8 * k + 8 <= n:
                    w = mem[row + 8 * k:row + 8 * k + 8]
                    loads.add((row + 8 * k, 8))
                else:
                    w = np.concatenate([mem[row + 8 * k:row + 8 * k + 4],
                                        np.zeros(4, np.uint16)])
                    loads.add((row + 8 * k, 4))
            else:
                assert row % 8 == 4  # 8 bytes off: odd C2
                lo = mem[row + 8 * k - 4:row + 8 * k + 4]
                loads.add((row + 8 * k - 4, 8))
                if 8 * k + 4 < n:
                    hi = mem[row + 8 * k + 4:row + 8 * k + 12]
                    loads.add((row + 8 * k + 4, 8))
                else:
                    hi = np.zeros(8, np.uint16)
                w = np.concatenate([lo[4:], hi[:4]])
            out[y, 8 * k:8 * k + 8] = w
    return out, loads


@pytest.mark.parametrize("c2", [45, 15, 90])
def test_grl_bf16_anchor_rows_at_odd_c2(c2):
    """At odd C/2 an anchor row (4 pixels, 8 C2 bytes) starts 0 or 8 bytes
    off a 16-byte boundary: the lanes' 16-byte words, shifted by half a
    word where it is off, rebuild every row of every tile, each load
    16-byte aligned and inside the tensor."""
    b, h2, w2 = 2, 4, 12
    rng = np.random.default_rng(c2)
    anchor = rng.integers(1, 60000, (b, h2, w2, c2), dtype=np.uint16)
    mem = anchor.reshape(-1)
    offs = set()
    for bb in range(b):
        for ay in range(0, h2, 4):
            for ax in range(0, w2, 4):
                first = ((bb * h2 + ay) * w2 + ax) * c2
                got, loads = _anchor_rows(mem, first, w2 * c2, c2)
                offs.add(first % 8)
                for a, n in loads:
                    assert a % 8 == 0 and 0 <= a and a + n <= mem.size
                want = anchor[bb, ay:ay + 4, ax:ax + 4].reshape(4, 4 * c2)
                np.testing.assert_array_equal(got[:, :4 * c2], want)
    assert offs == ({0, 4} if c2 % 2 else {0})


def test_grl_mask_layout():
    """Element [w, r, q, hh, g, t, i, e] of the laid-out mask is mask[w,
    16 r + 8 hh + g, 16 q + 8 i + 2 t + e]: lane (g, t) of the warp on unit
    r reads, for n-tiles 2q and 2q + 1 and row g + 8 hh, one 8-byte word
    pair, the warp's 32 pairs contiguous."""
    m = torch.arange(3 * 64 * 64, dtype=torch.float32).view(3, 64, 64)
    lay = grl_mask_layout(m)
    assert lay.shape == (3, 4, 4, 2, 8, 4, 2, 2) and lay.is_contiguous()
    w, r, q, hh, g, t, i, e = np.indices(lay.shape)
    want = m.numpy()[w, 16 * r + 8 * hh + g, 16 * q + 8 * i + 2 * t + e]
    np.testing.assert_array_equal(lay.numpy(), want)
    words = lay.view(3, 4, 4, 2, 32, 2, 2)  # a lane's two words
    assert words[0, 1, 2, 1, 13, 1, 0] == m[0, 16 + 8 + 3, 32 + 8 + 2]


def test_grl_mask_table_cast_once():
    """#2 bf16 takes the mask cast to bf16 (as the JAX wrapper casts it)
    and laid out: a device table's is made once and kept beside it; any
    other tensor is cast and laid out on each call."""
    mask = device_table(shifted_window_mask, 16, 24, 8, 4, device="cpu")
    a = table_as(mask, torch.bfloat16, grl_mask_layout)
    assert a.dtype == torch.bfloat16
    assert table_as(mask, torch.bfloat16, grl_mask_layout) is a
    assert torch.equal(a, grl_mask_layout(mask.to(torch.bfloat16)))
    assert table_as(mask, torch.bfloat16) is not a  # #1's: no layout
    other = torch.rand(6, 64, 64) * 80 - 40
    b = table_as(other, torch.bfloat16, grl_mask_layout)
    assert b is not table_as(other, torch.bfloat16, grl_mask_layout)
    assert torch.equal(b, grl_mask_layout(other.to(torch.bfloat16)))


# --- #19 bf16 ------------------------------------------------------------

def test_hier_bf16_plan():
    """The six convs at the 336x512 bucket's HR (1344x2048): Cin padded to
    16 (76 -> 80), N = Cout padded to wgmma's width, 4 rows a tile at
    conv0 and 8 after (half of them a consumer warpgroup); each block's
    weights (9 cinp N bf16) and two halos ((rows + 2) x 66 x cinp) in 227
    KB; 2048 columns in 32 whole segments of 64."""
    p = plan_hier_bf16(1344, 2048, 76)
    got = [(c.cin, c.cout, c.cinp, c.n, c.rows) for c in p.convs]
    assert got == [(76, 64, 80, 64, 4), (64, 32, 64, 32, 8),
                   (32, 32, 32, 32, 8), (32, 32, 32, 32, 8),
                   (32, 16, 32, 16, 8), (16, 3, 16, 8, 8)]
    for c in p.convs:
        assert c.halo == (c.rows + 2) * 66
        assert c.smem == 128 + 18 * c.cinp * c.n + 4 * c.cinp * c.halo
        assert c.smem <= SMEM_BLOCK
        assert c.tiles == 1344 // c.rows * 32
        assert c.reread == c.halo / (64 * c.rows)
    assert p.convs[0].smem == 219008 and p.convs[1].smem == 205952
    ragged = plan_hier_bf16(13, 18, 76)
    assert [c.tiles for c in ragged.convs] == [4, 2, 2, 2, 2, 2]
    with pytest.raises(ValueError, match="Cin"):
        plan_hier_bf16(8, 8, 96)


@pytest.mark.parametrize("cin,cout", [(76, 64), (64, 32), (32, 32),
                                      (32, 16), (16, 3)])
def test_hier_bf16_conv_layouts(cin, cout):
    """conv_layout at each conv's N: [Cout_p / N][Cin_p / 16][tap][N / 8]
    [2][8][8], read back as the kernel reads a tap's B operand (k16 step
    kk at (kk 9 + tap) N 32 bytes: core matrices of 8 output channels x 8
    input channels, the two halves of the 16 128 bytes apart), equals the
    HWIO weight, zeros past Cin and Cout."""
    n = dict(zip(((76, 64), (64, 32), (32, 32), (32, 16), (16, 3)),
                 (64, 32, 32, 16, 8)))[(cin, cout)]
    assert n in HIER_BF16_N
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)).astype(np.float32))
    lay = wgmma.conv_layout(w, n).reshape(-1).numpy()
    cinp = -(-cin // 16) * 16
    assert lay.size == 9 * cinp * n
    back = np.zeros((3, 3, cinp, n), np.float32)
    for kk in range(cinp // 16):
        for tap in range(9):
            base = (kk * 9 + tap) * n * 16
            for g in range(n // 8):
                for h in range(2):
                    for i in range(8):
                        for e in range(8):
                            back[tap // 3, tap % 3, 16 * kk + 8 * h + e,
                                 8 * g + i] = lay[base + ((g * 2 + h) * 8
                                                          + i) * 8 + e]
    np.testing.assert_array_equal(back[:, :, :cin, :cout], w.numpy())
    assert not back[:, :, cin:].any() and not back[:, :, :, cout:].any()


def _halo_planar(planar: np.ndarray, b: int, hgt: int, wid: int, y0: int,
                 x0: int, rows: int) -> np.ndarray:
    """A tile's halo as the staging warps build it from a group-planar
    tensor [G][B H W][8]: each in-image row of each group one copy of its
    in-image pixels, the lanes' zeros elsewhere: [G][(rows + 2) 66][8]."""
    g = planar.shape[0]
    halo = np.full((g, (rows + 2) * 66, 8), np.nan, np.float32)
    xs, xe = max(x0 - 1, 0), min(x0 + 65, wid)
    for p in range(halo.shape[1]):  # the lanes' zeros first
        y, x = y0 - 1 + p // 66, x0 - 1 + p % 66
        if not (0 <= y < hgt and 0 <= x < wid):
            halo[:, p] = 0.0
    for gg in range(g):
        for y in range(max(y0 - 1, 0), min(y0 + rows + 1, hgt)):
            src = planar[gg, (b * hgt + y) * wid + xs:(b * hgt + y) * wid + xe]
            at = (y - y0 + 1) * 66 + xs - x0 + 1
            halo[gg, at:at + xe - xs] = src
    assert not np.isnan(halo).any()
    return halo


def _halo_gathered(x: np.ndarray, b: int, y0: int, x0: int, rows: int,
                   cinp: int) -> np.ndarray:
    """conv0's halo as its staging warps gather it from s3_in [B, H, W,
    Cin] (an NHWC tensor or the module's NCHW view, read through its
    strides): item (group, pixel), 8 channels, zeros past Cin and outside
    the image."""
    _, hgt, wid, cin = x.shape
    halo = np.zeros((cinp // 8, (rows + 2) * 66, 8), np.float32)
    for q in range(cinp // 8):
        for p in range(halo.shape[1]):
            y, xx = y0 - 1 + p // 66, x0 - 1 + p % 66
            if 0 <= y < hgt and 0 <= xx < wid:
                c = x[b, y, xx, 8 * q:8 * q + 8]
                halo[q, p, :c.size] = c
    return halo


def _taps_through_descriptors(halo: np.ndarray, rows: int) -> np.ndarray:
    """The A operand the wgmmas read: for m-tile r, tap (dy, dx) and k16
    step kk, the descriptor at halo + (2 kk 66 (rows + 2) + (r + dy) 66 +
    dx) 16 bytes, lbo the halo's pixels x 16, sbo 128: row m (pixel x0 +
    m), k (channel 16 kk + k) lies at group 2 kk + k // 8, slot (r + dy) 66
    + dx + m, value k % 8. Returns [rows, 64, 9, Cinp]."""
    g, npx, _ = halo.shape
    flat = halo.reshape(-1)
    out = np.zeros((rows, 64, 9, 8 * g), np.float32)
    for r in range(rows):
        for tap in range(9):
            for kk in range(g // 2):
                start = 2 * kk * npx + (r + tap // 3) * 66 + tap % 3  # slots
                for m in range(64):
                    for k in range(16):
                        core = start + (m // 8) * 8 + (k // 8) * npx
                        out[r, m, tap, 16 * kk + k] = flat[
                            (core + m % 8) * 8 + k % 8]
    return out


def _im2col(x: np.ndarray, b: int, y0: int, x0: int, rows: int,
            cinp: int) -> np.ndarray:
    """[rows, 64, 9, Cinp]: the 3x3 neighbourhoods of output pixels (y0 +
    r, x0 + m) of the zero-padded image, channels past Cin zero."""
    _, hgt, wid, cin = x.shape
    pad = np.zeros((hgt + 2, wid + 2 + 64, cinp), np.float32)
    pad[1:hgt + 1, 1:wid + 1, :cin] = x[b]
    out = np.zeros((rows, 64, 9, cinp), np.float32)
    for r in range(rows):
        if y0 + r >= hgt:
            continue
        for tap in range(9):
            dy, dx = tap // 3, tap % 3
            out[r, :, tap] = pad[y0 + r + dy, x0 + dx:x0 + dx + 64]
    return out


@pytest.mark.parametrize("hgt,wid,y0,x0,rows", [
    (13, 70, 0, 0, 8), (13, 70, 8, 64, 8), (20, 200, 4, 128, 4),
    (9, 64, 8, 0, 8)])
def test_hier_bf16_halo_reads_match_im2col(hgt, wid, y0, x0, rows):
    """A tile's halo, bulk-copied from the group-planar intermediate (and
    for conv0 gathered from s3_in, NHWC or NCHW), read through the shifted
    descriptors, equals an im2col of the zero-padded image at every output
    pixel inside it (rows and columns past the image are not stored)."""
    rng = np.random.default_rng(hgt + wid + y0 + x0)
    b, nb = 1, 2
    x = rng.normal(size=(nb, hgt, wid, 32)).astype(np.float32)
    planar = x.reshape(nb * hgt * wid, 4, 8).transpose(1, 0, 2)
    taps = _taps_through_descriptors(
        _halo_planar(planar, b, hgt, wid, y0, x0, rows), rows)
    want = _im2col(x, b, y0, x0, rows, 32)
    inside = min(64, wid - x0)
    live = min(rows, hgt - y0)
    np.testing.assert_array_equal(taps[:live, :inside], want[:live, :inside])
    s3 = rng.normal(size=(nb, hgt, wid, 76)).astype(np.float32)
    for view in (s3, np.ascontiguousarray(s3.transpose(0, 3, 1, 2)
                                          ).transpose(0, 2, 3, 1)):
        taps = _taps_through_descriptors(
            _halo_gathered(view, b, y0, x0, rows, 80), rows)
        want = _im2col(s3, b, y0, x0, rows, 80)
        np.testing.assert_array_equal(taps[:live, :inside],
                                      want[:live, :inside])


@pytest.mark.parametrize("inference", [False, True])
def test_hier_hands_views_of_its_convs(monkeypatch, inference):
    """The hierarchical fusion, gated (FREQFUSION_HIER), in bf16: the six
    3x3 kernels it hands stage 3 are views of their parameters (HWIO
    permutes, no copy: one made under torch.inference_mode has no version
    counter and would be laid out on every call), also under
    torch.inference_mode; the gate's 1x1 kernels stay copies."""
    seen = []

    def fake(s3_in, p):
        seen.append(p)
        b, h, w, _ = s3_in.shape
        return s3_in.new_zeros(b, h, w, 3)
    monkeypatch.setenv("FREQFUSION_HIER", "1")
    monkeypatch.setattr(hierarchical, "hier_stage3_fused", fake)
    torch.manual_seed(0)
    hm = hierarchical.HierarchicalMultiResolutionFusion(4, 64).to(
        torch.bfloat16)
    outs = {k: torch.rand(1, 3, 16, 24).to(torch.bfloat16)
            for k in ("a", "b", "c", "d")}
    with torch.inference_mode() if inference else torch.no_grad():
        hm(outs)
    (p,) = seen
    convs = {"stage3_conv_0": hm.stage3_conv[0], "stage3_conv_2":
             hm.stage3_conv[2], "to_rgb_0": hm.to_rgb[0],
             "to_rgb_2": hm.to_rgb[2]}
    res = {"block_0": hm.stage3_res.block[0],
           "block_2": hm.stage3_res.block[2]}
    for tree, mods in ((p, convs), (p["stage3_res"], res)):
        for name, conv in mods.items():
            k = tree[name]["kernel"]
            assert k._base is conv.weight and not k.is_inference()
            assert torch.equal(k, conv.weight.permute(2, 3, 1, 0))
    gate0 = p["stage3_gate"]["gate_0"]["kernel"]
    assert gate0._base is None and gate0.is_contiguous()
