"""The bf16 window attention's one-pass wgmma kernel (#1 bf16,
``csrc/window_attention.cu``) and GRL's bf16 qkv projection on the wgmma
GEMM (#12 bf16, ``csrc/grl_attention_qkv.cu``), on the CPU, without JAX:
a numpy model of the kernel's staging (aligned 16-byte words shifted into
place), its plan (ops/attention.py:plan_window_attention_bf16), the
segment-padded weight layout of #12 read back as the kernel streams it,
GRL's MixedAttention handing the kernel a view of its parameter, the
layouts' cache, and the cast of the mask tables.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from freqfusion_tpu_torch.models import grl
from freqfusion_tpu_torch.ops import wgmma
from freqfusion_tpu_torch.ops.attention import plan_window_attention_bf16
from freqfusion_tpu_torch.ops.window_attention import (device_table,
                                                       shifted_window_mask,
                                                       table_as)

# DRCT-L's five block widths and head counts (head dims 30, 53, 122, 46, 77)
DRCT_WIDTHS = [(180, 6), (212, 4), (244, 2), (276, 6), (308, 4)]
SMEM_BLOCK = 232448   # a block's shared memory at most (227 KB)
SM_SMEM = 233472      # an SM's, 1 KB of it reserved a block
M32 = 0xFFFFFFFF


def _stage_row(mem: np.ndarray, a: int, hd: int, hdp: int) -> tuple:
    """The kernel's wa_stage on one pixel row of the byte array `mem`: the
    aligned 16-byte words that cover the hd bf16 at byte `a` (even), as
    little-endian 32-bit words, then each output word (two bf16) taken
    from the words at q and q + 1 past it, funnel-shifted right by 0 or 16
    bits (q = sh / 4, sh = a % 16), zeros past hd; the hdp bf16 staged and
    the addresses of the words it loads."""
    base, sh = a & ~15, a & 15
    kw = hdp // 8 + 1
    words = (sh + 2 * hd + 15) >> 4
    assert words <= kw
    loaded = [base + 16 * u for u in range(words)]
    w = []
    for u in range(kw):
        w += ([int.from_bytes(mem[base + 16 * u + 4 * i:
                                  base + 16 * u + 4 * i + 4].tobytes(),
                              "little") for i in range(4)]
              if u < words else [0] * 4)
    q, bits = sh >> 2, (sh & 2) * 8
    out = []
    for at in range(hdp // 2):
        v = ((w[at + q + 1] << 32 | w[at + q]) >> bits) & M32
        out.append(0 if 2 * at >= hd else
                   v & 0xFFFF if 2 * at + 1 >= hd else v)
    halves = np.array([(v >> s) & 0xFFFF for v in out for s in (0, 16)],
                      np.uint16)
    return halves, loaded


@pytest.mark.parametrize("c,heads", DRCT_WIDTHS + [(60, 6), (154, 2),
                                                   (256, 2)])
def test_staging_rebuilds_each_head_slice(c, heads):
    """For each head and pixel rows at each alignment a row start takes
    (C bf16 a row: 8 mod 16 bytes at every DRCT-L width), the aligned words
    the kernel loads, shifted, give the head's channels exactly, zeros
    past hd up to the head box; every word loaded overlaps the slice, so
    none lies past the tensor."""
    hd = c // heads
    hdp = -(-hd // 16) * 16
    rows = 4
    rng = np.random.default_rng(c)
    vals = rng.integers(1, 2 ** 16, size=rows * c, dtype=np.uint16)
    mem = np.concatenate([vals.view(np.uint8), np.zeros(64, np.uint8)])
    for head in range(heads):
        ch0 = head * hd
        for p in range(rows):
            lo, hi = 2 * (p * c + ch0), 2 * (p * c + ch0 + hd)
            got, loaded = _stage_row(mem, lo, hd, hdp)
            assert all(w < hi and w + 16 > lo for w in loaded)
            want = np.zeros(hdp, np.uint16)
            want[:hd] = vals[p * c + ch0:p * c + ch0 + hd]
            np.testing.assert_array_equal(got, want)


def test_key_permutation():
    """K and V are staged with their keys permuted within each 32-key
    block (csrc/window_attention.cu:wa_perm: key 8 a + 2 b + e at row 8 b
    + 2 a + e), so that a thread's logits of four n-tiles (columns 8 j + 2
    t + e, j < 4) are keys 8 t .. 8 t + 7: one 16-byte load of the bias
    and of the mask. A permutation of each block, its own inverse."""
    def perm(r):
        return (r & ~31) | ((r & 6) << 2) | ((r >> 2) & 6) | (r & 1)
    rows = [perm(r) for r in range(256)]
    assert sorted(rows) == list(range(256))
    assert all(perm(perm(r)) == r and perm(r) // 32 == r // 32
               for r in range(256))
    for t in range(4):
        cols = [8 * j + 2 * t + e for j in range(4) for e in range(2)]
        assert sorted(perm(c) for c in cols) == list(range(8 * t, 8 * t + 8))
        assert [perm(c) for c in cols] == list(range(8 * t, 8 * t + 8))


@pytest.mark.parametrize("n,hd", [(256, hd) for hd in (30, 53, 122, 46, 77)]
                         + [(16, 10), (64, 10), (144, 77), (256, 128),
                            (64, 30), (16, 106)])
def test_plan_window_attention_bf16(n, hd):
    """q, k and v staged whole in a block (keys padded to one or two
    128-key halves, queries to 64-row tiles), an output tile a warpgroup
    and the rows' pixel offsets:
    within a block's 227 KB; two warpgroups a block where the head box
    passes 64 (one block an SM), else one (three blocks an SM up to head
    box 32, two above); the registers a thread may take at that occupancy
    hold a tile's logits over 256 keys (128) with room beside them."""
    p = plan_window_attention_bf16(n, hd)
    assert p.hdp == -(-hd // 16) * 16 and p.hdp % 16 == 0
    assert p.nk == (128 if n <= 128 else 256) and p.nq == -(-n // 64) * 64
    assert p.warpgroups == (2 if p.hdp > 64 else 1)
    assert p.smem == (2 * p.hdp * (p.nq + 2 * p.nk)
                      + p.warpgroups * 64 * (p.hdp + 8) * 2 + 4 * n)
    assert p.smem <= SMEM_BLOCK
    assert p.blocks_per_sm == (1 if p.warpgroups == 2 else
                               3 if p.hdp <= 32 else 2)
    assert p.blocks_per_sm * (p.smem + 1024) <= SM_SMEM
    assert p.regs * 128 * p.warpgroups * p.blocks_per_sm <= 65536
    assert p.regs >= 128 + 32


@pytest.mark.parametrize("n,hd", [(8, 30), (272, 30), (256, 129), (40, 30)])
def test_plan_window_attention_bf16_refuses(n, hd):
    with pytest.raises(ValueError, match="window_attention_nhwc"):
        plan_window_attention_bf16(n, hd)


@pytest.mark.parametrize("cin,c2", [(180, 90), (48, 24), (128, 64),
                                    (250, 120)])
def test_segment_layout_reads_back(cin, c2):
    """#12's weight [Cin, 6 C2] in the segment layout: chunk s (of
    segment_cols(C2) columns) holds wqkv's columns s C2 .. (s + 1) C2
    exactly in bf16, zeros past C2 and past Cin, read back as the kernel's
    producer streams it ([chunk][k16][n8][2][8][8])."""
    rng = np.random.default_rng(cin)
    w = torch.from_numpy(rng.standard_normal((cin, 6 * c2)).astype(
        np.float32)).to(torch.bfloat16)
    bn = wgmma.segment_cols(c2)
    assert bn in (48, 64, 96, 128) and bn >= c2
    assert all(b < c2 for b in (48, 64, 96, 128) if b < bn)
    lay = wgmma.segment_layout(w, 6)
    kp = -(-cin // 32) * 32
    assert lay.shape == (6, kp // 16, bn // 8, 2, 8, 8)
    # [chunk][k][n]: k = 16 kk + 8 h + e, n = 8 g + i
    back = lay.permute(0, 1, 3, 5, 2, 4).reshape(6, kp, bn)
    for s in range(6):
        assert torch.equal(back[s, :cin, :c2], w[:, s * c2:(s + 1) * c2])
        assert not back[s, :, c2:].any() and not back[s, cin:].any()


def _tiny_mixed_attention(dtype=torch.bfloat16):
    torch.manual_seed(0)
    return grl.MixedAttention(48, 3, 3, 8, True, (8, 8), 2).to(dtype)


@pytest.mark.parametrize("inference", [False, True])
def test_grl_hands_a_view_of_wqkv(monkeypatch, inference):
    """GRL's MixedAttention, gated (FREQFUSION_GRL_QKV), in bf16: the
    weight it hands #12 is the view wqkv.t() of its parameter (no copy:
    one made under torch.inference_mode has no version counter), also
    under torch.inference_mode."""
    seen = []

    def fake(x, x_rolled, anchor, wqkv, *args):
        seen.append(wqkv)
        b, h, w, c = x.shape
        return (x.new_zeros(b, h, w, c // 2),) * 2
    monkeypatch.setenv("FREQFUSION_GRL_QKV", "1")
    monkeypatch.setattr(grl, "grl_mixed_attention_qkv_nhwc", fake)
    att = _tiny_mixed_attention()
    x = torch.randn(1, 16, 24, 48).to(torch.bfloat16)
    with torch.inference_mode() if inference else torch.no_grad():
        att(x)
    weight = att.qkv.body.weight
    (wqkv,) = seen
    assert wqkv._base is weight and not wqkv.is_inference()
    assert wqkv.shape == (48, 144) and torch.equal(wqkv, weight.t())


def test_segment_layout_cache():
    """Built on first use, found while the weight stays (also under
    torch.inference_mode, for the module's view), built anew after an
    in-place update and, after clear_weight_layouts, after a write
    through .data (which no version counter sees)."""
    wgmma.clear_weight_layouts()
    weight = _tiny_mixed_attention().qkv.body.weight
    with torch.inference_mode():
        a = wgmma.segment_layouts(weight.t(), 6)
        assert wgmma.segment_layouts(weight.t(), 6) is a
    assert torch.equal(a, wgmma.segment_layout(weight.detach().t(), 6))
    assert sum(len(t) for t in wgmma._LAYOUTS.values()) == 1
    with torch.no_grad():
        weight.mul_(-1)
    b = wgmma.segment_layouts(weight.t(), 6)
    assert b is not a and torch.equal(b, -a)
    weight.data.copy_(torch.randn(144, 48).to(torch.bfloat16))
    assert wgmma.segment_layouts(weight.t(), 6) is b  # not seen
    wgmma.clear_weight_layouts()
    c = wgmma.segment_layouts(weight.t(), 6)
    assert c is not b and torch.equal(
        c, wgmma.segment_layout(weight.detach().t(), 6))


def test_mask_table_cast_once():
    """The bf16 routes of #1 and #11 hand their kernel the mask in bf16,
    as the JAX wrappers cast it: a device table's cast is made once and
    kept beside it; any other tensor is cast on each call; bf16 in, the
    same tensor out."""
    mask = device_table(shifted_window_mask, 16, 24, 8, 4, device="cpu")
    a = table_as(mask, torch.bfloat16)
    assert a.dtype == torch.bfloat16 and table_as(mask, torch.bfloat16) is a
    assert torch.equal(a.float(), mask)  # 0 and -100: exact in bf16
    assert table_as(a, torch.bfloat16) is a and table_as(None, a.dtype) is None
    other = torch.rand(6, 64, 64) * 80 - 40
    b = table_as(other, torch.bfloat16)
    assert b is not table_as(other, torch.bfloat16)
    assert torch.equal(b, other.to(torch.bfloat16))
