"""The wgmma GEMM's weight layouts, their cache and the bf16 plans of #11
and #16 (ops/wgmma.py), on the CPU, without JAX.

The layout is read back element by element as csrc/bf16_wgmma.cuh's
kernels address it (a stage of 32 of K a bulk copy, wgmma's K-major core
matrices within it); the NAFBlock's pass A is modelled tile by tile (the
halo's rows, u zero outside the image, the pool's per-tile sums) against
the plain version's g and pool.
"""

from __future__ import annotations

import gc
import weakref

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from freqfusion_tpu_torch.ops import wgmma
from freqfusion_tpu_torch.ops.nafblock import EPS


def _kernel_read(flat: np.ndarray, kp: int, bn: int, c: int, s: int,
                 k: int, g: int, h: int, i: int, e: int) -> float:
    """The value the GEMM's wgmma reads for chunk c, stage s (bulk copy
    (c kp / 32 + s) of bn x 64 bytes), k16 step k of the stage (bn x 32
    bytes in), 8-column group g (256 bytes a group: sbo), K half h (128:
    lbo), core-matrix row i (16 bytes), value e: in bf16 elements."""
    stage = (c * (kp // 32) + s) * bn * 32
    return flat[stage + k * bn * 16 + g * 128 + h * 64 + i * 8 + e]


@pytest.mark.parametrize("k,n,bn,interleave", [
    (180, 540, 96, False), (212, 212, 128, False), (36, 72, 64, True),
    (64, 128, 128, True), (100, 96, 96, False), (40, 200, 64, True)])
def test_weight_layout_read_back(k, n, bn, interleave):
    """Each weight element lands exactly once, where the kernel reads
    (column n's gate halves side by side with `interleave`); the padding
    (K to 32, N to whole chunks) is zero."""
    vals = torch.arange(1, k * n + 1, dtype=torch.float64).view(k, n)
    lay = wgmma.weight_layout(vals, bn, interleave)
    kp, np_ = -(-k // 32) * 32, -(-n // bn) * bn
    assert tuple(lay.shape) == (np_ // bn, kp // 16, bn // 8, 2, 8, 8)
    flat = lay.numpy().ravel()
    seen = np.sort(flat[flat > 0])
    np.testing.assert_array_equal(seen, np.arange(1, k * n + 1))
    src = vals.numpy()
    for c in range(np_ // bn):
        for s in range(kp // 32):
            for kk in range(2):
                for g in range(bn // 8):
                    for h in range(2):
                        for i in range(8):
                            col = c * bn + 8 * g + i
                            if interleave and col < n:
                                col = col // 2 + (col % 2) * (n // 2)
                            for e in range(8):
                                row = 32 * s + 16 * kk + 8 * h + e
                                want = (src[row, col] if row < k and
                                        c * bn + 8 * g + i < n else 0)
                                assert _kernel_read(flat, kp, bn, c, s, kk,
                                                    g, h, i, e) == want


def test_weight_layout_bf16_is_exact():
    w = torch.randn(180, 540).to(torch.bfloat16)
    lay = wgmma.weight_layout(w, 96)
    assert lay.dtype == torch.bfloat16
    back = lay.permute(0, 2, 4, 1, 3, 5).reshape(576, 192)[:540, :180]
    assert torch.equal(back.t(), w)


@pytest.mark.parametrize("n,want", [
    (540, 96), (636, 64), (732, 96), (828, 64), (924, 96),  # 3C
    (180, 96), (212, 64), (244, 64), (276, 96), (308, 64),  # C
    (64, 64), (128, 64), (2048, 64), (72, 96), (40, 64), (96, 96)])
def test_chunk_cols(n, want):
    assert wgmma.chunk_cols(n) == want
    for bn in wgmma.CHUNKS:
        assert -(-n // want) * want <= -(-n // bn) * bn


@pytest.mark.parametrize("c", [180, 212, 244, 276, 308])
def test_plan_qkv_bf16(c):
    """DRCT-L's widths: no pad or rows pass left, 20 C bytes a pixel (x,
    q | k | v out and back, the attention's output out and back, out)."""
    m = 336 * 512
    p = wgmma.plan_qkv_bf16(m, c, c)
    assert p.bytes_per_pixel == 20 * c
    assert p.scratch_bytes == 4 * (-(-2 * m * c // 256) * 256)
    assert (p.bn_qkv, p.bn_proj) == (wgmma.chunk_cols(3 * c),
                                     wgmma.chunk_cols(c))


@pytest.mark.parametrize("cin,c", [(181, 180), (180, 181), (660, 660)])
def test_plan_qkv_bf16_refuses(cin, c):
    with pytest.raises(ValueError):
        wgmma.plan_qkv_bf16(64, cin, c)


LEVELS = [(64, 1344, 2048), (128, 672, 1024), (256, 336, 512),
          (512, 168, 256), (1024, 84, 128)]


@pytest.mark.parametrize("c,h,w", LEVELS)
def test_plan_nafblock_bf16_levels(c, h, w):
    """NAFNet's five levels at 336x512: <= 20 C bytes a pixel where bytes
    bind (C <= 256: two launches, the halo tile and its conv1 rows), the
    nine launches' bytes above, the scratch (g; above C 256 also y, two A
    operands in the tiled order and u)."""
    p = wgmma.plan_nafblock_bf16(h, w, c)
    m = h * w
    g = -(-4 * m * c // 256) * 256
    if c <= 256:
        assert p.fused and p.out_tile == (6, 14)
        assert p.bytes_per_pixel == 14 * c <= 20 * c
        assert p.scratch_bytes == g
        assert abs(p.conv1_rows - 128 / 84) < 1e-12
    else:
        assert not p.fused and p.out_tile == (8, 8) and p.conv1_rows == 1
        assert p.bytes_per_pixel == 58 * c
        tiled = 2 * (-(-m // 128) * 128) * c  # C a multiple of 32 here
        assert p.scratch_bytes == (2 * g + 2 * (-(-tiled // 256) * 256)
                                   + -(-8 * m * c // 256) * 256)
    oh, ow = p.out_tile
    assert p.tiles == -(-h // oh) * -(-w // ow)
    assert p.bn == (64 if c == 64 else 128) and p.bn1 == 128


@pytest.mark.parametrize("c", [35, 1026])
def test_plan_nafblock_bf16_refuses(c):
    with pytest.raises(ValueError):
        wgmma.plan_nafblock_bf16(8, 8, c)


def _naf_tree(rng, c):
    def conv(cin, cout, k=1):
        return {"kernel": torch.tensor(rng.normal(size=(k, k, 1 if k == 3
                                                         else cin, cout))
                                       / np.sqrt(cin), dtype=torch.float32),
                "bias": torch.tensor(0.1 * rng.normal(size=cout),
                                     dtype=torch.float32)}
    return {"norm1": {"scale": torch.tensor(1 + 0.1 * rng.normal(size=c),
                                            dtype=torch.float32),
                      "bias": torch.tensor(0.1 * rng.normal(size=c),
                                           dtype=torch.float32)},
            "conv1": conv(c, 2 * c), "conv2": conv(2 * c, 2 * c, 3)}


def _gate_by_tiles(x, w, plan):
    """Pass A as naf_gate_wgmma_kernel runs it, tile by tile, in fp32:
    the halo's rows (8 x (out width + 2)) through LN1 and conv1, u zero
    outside the image, the depthwise 3x3 and SimpleGate on the tile's
    outputs, each tile's channel sums."""
    b, h, wd, c = x.shape
    assert plan.fused
    oh, ow = plan.out_tile
    th, tw = oh + 2, ow + 2
    g = torch.full_like(x, float("nan"))
    parts = torch.zeros(b, plan.tiles, c)
    tiles_x = -(-wd // ow)
    k = w["conv2"]["kernel"][:, :, 0]  # [3, 3, 2C]
    for bi in range(b):
        for t in range(plan.tiles):
            y0, x0 = (t // tiles_x) * oh, (t % tiles_x) * ow
            u = torch.zeros(th, tw, 2 * c)
            for hy in range(th):
                for hx in range(tw):
                    yy, xx = y0 - 1 + hy, x0 - 1 + hx
                    if 0 <= yy < h and 0 <= xx < wd:
                        xn = F.layer_norm(x[bi, yy, xx], (c,),
                                          w["norm1"]["scale"],
                                          w["norm1"]["bias"], EPS)
                        u[hy, hx] = (xn @ w["conv1"]["kernel"][0, 0]
                                     + w["conv1"]["bias"])
            for oy in range(oh):
                for ox in range(ow):
                    yy, xx = y0 + oy, x0 + ox
                    if yy >= h or xx >= wd:
                        continue
                    s = (u[oy:oy + 3, ox:ox + 3] * k).sum((0, 1)) + \
                        w["conv2"]["bias"]
                    g[bi, yy, xx] = s[:c] * s[c:]
                    parts[bi, t] += g[bi, yy, xx]
    return g, parts


@pytest.mark.parametrize("c,h,w", [(8, 13, 17), (256, 7, 9), (4, 6, 14)])
def test_gate_tiles_cover_the_image(c, h, w):
    """Every output pixel once (odd sides: the last tiles' halos cross the
    image's edge), g and the pool as the plain version computes them."""
    rng = np.random.default_rng(c)
    x = torch.tensor(rng.normal(size=(2, h, w, c)), dtype=torch.float32)
    tree = _naf_tree(rng, c)
    plan = wgmma.plan_nafblock_bf16(h, w, c, 2)
    g, parts = _gate_by_tiles(x, tree, plan)
    xn = F.layer_norm(x, (c,), tree["norm1"]["scale"], tree["norm1"]["bias"],
                      EPS)
    u = xn @ tree["conv1"]["kernel"][0, 0] + tree["conv1"]["bias"]
    u = F.conv2d(u.permute(0, 3, 1, 2),
                 tree["conv2"]["kernel"].permute(3, 2, 0, 1),
                 tree["conv2"]["bias"], padding=1, groups=2 * c
                 ).permute(0, 2, 3, 1)
    want = u[..., :c] * u[..., c:]
    assert not torch.isnan(g).any()
    torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(parts.sum(1), want.sum((1, 2)), rtol=1e-4,
                               atol=1e-3)


def test_layout_cache_reuse_and_invalidation():
    """Keyed as chain_proj_operands keys its weights: reused while the
    weight stays; rebuilt after an in-place update, a dtype cast, a .data
    swap and (after clear_weight_layouts) a write through .data; views of
    one root keyed apart; no graph kept."""
    wgmma.clear_weight_layouts()
    p = torch.nn.Parameter(torch.randn(1, 1, 40, 80).to(torch.bfloat16))
    view = p[0, 0]
    a = wgmma.weight_layouts(view, 64, True)
    assert wgmma.weight_layouts(p[0, 0], 64, True) is a
    assert a.grad_fn is None and not a.requires_grad
    assert wgmma.weight_layouts(view, 128, True) is not a
    assert not torch.equal(wgmma.weight_layouts(view, 64), a)
    with torch.no_grad():
        p.mul_(2)
    b = wgmma.weight_layouts(p[0, 0], 64, True)
    assert b is not a and torch.equal(b, wgmma.weight_layout(
        p[0, 0].detach(), 64, True))
    p.data = p.data.float()
    c = wgmma.weight_layouts(p[0, 0], 64, True)
    assert c.dtype == torch.float32
    p.data = p.data.clone()
    assert wgmma.weight_layouts(p[0, 0], 64, True) is not c
    d = wgmma.weight_layouts(p[0, 0], 64, True)
    p.data.copy_(torch.randn(1, 1, 40, 80))
    assert wgmma.weight_layouts(p[0, 0], 64, True) is d  # not seen
    wgmma.clear_weight_layouts()
    e = wgmma.weight_layouts(p[0, 0], 64, True)
    assert e is not d and torch.equal(e, wgmma.weight_layout(
        p[0, 0].detach(), 64, True))
    halves = (p[0, 0, :20], p[0, 0, 20:])
    assert not torch.equal(wgmma.weight_layouts(halves[0], 64),
                           wgmma.weight_layouts(halves[1], 64))


def test_layout_cache_drops_with_the_weight():
    wgmma.clear_weight_layouts()
    w = torch.randn(32, 64)
    lay = weakref.ref(wgmma.weight_layouts(w, 64))
    gc.collect()
    assert lay() is not None
    del w
    gc.collect()
    assert lay() is None and len(wgmma._LAYOUTS) == 0


def test_layout_cache_under_inference_mode():
    """Serving runs under torch.inference_mode: a view of a parameter made
    there keeps its counter and its entry (the models hand such views), a
    tensor made there has no counter and is laid out anew each call."""
    wgmma.clear_weight_layouts()
    conv = torch.nn.Conv2d(40, 80, 1).to(torch.bfloat16)
    with torch.inference_mode():
        a = wgmma.weight_layouts(conv.weight.permute(2, 3, 1, 0)[0, 0], 128,
                                 True)
        assert wgmma.weight_layouts(conv.weight.permute(2, 3, 1, 0)[0, 0],
                                    128, True) is a
        copy = conv.weight.permute(2, 3, 1, 0).contiguous()[0, 0]
        assert copy.is_inference()
        b = wgmma.weight_layouts(copy, 128, True)
        assert b is not a and torch.equal(b, a)
    with torch.no_grad():
        conv.weight.mul_(2)
    with torch.inference_mode():
        c = wgmma.weight_layouts(conv.weight.permute(2, 3, 1, 0)[0, 0], 128,
                                 True)
    assert c is not a and torch.equal(c, 2 * a)
