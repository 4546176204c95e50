"""The Laplacian edge kernels' 3xTF32 plans and arithmetic, on the CPU.

``csrc/edge.cu`` runs the EdgeRefineBlock (TPU kernel #20) and the edge
fuse (#21) as chains of 3x3 convolutions on ``csrc/conv3x3_tf32.cuh``:
each conv's sources padded to 8 channels one by one (so a stage never
mixes two tensors), K taken stage by stage and tap by tap, three TF32
products an fp32 one; refine's 1x1 projection as the centre tap of
conv3's second source, its squeeze in conv3's epilogue and its gate in
the attention conv's; fuse's level weights folded into fusion_0's rows,
(sr, edge) as edge_gate_0's two sources, the gate, strength, residual and
clip in edge_gate_2's epilogue. These tests check the plans that
``ops/edge.py:plan_edge`` makes at the path's shapes, and hold numpy
models of both kernels' padded, multi-source, lw-scaled 3xTF32 arithmetic
to the plain versions. The rounding model is ``test_torch_tf32_gemm.py``'s
and the conv model ``test_torch_fusion_eval_plan.py``'s; the card tests
(``tests/test_torch_kernels_cuda.py``) run the kernels themselves.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from freqfusion_tpu_torch.ops import edge as edge_ops
from freqfusion_tpu_torch.ops.edge import (edge_fuse_fused_reference,
                                           edge_refine_fused_reference,
                                           plan_edge)
from freqfusion_tpu_torch.ops.hier import TILE_W, conv3x3
from test_torch_fusion_eval_plan import (BLOCK_RESERVED, BLOCK_SMEM,
                                         BORDER_SHAPES, SM_SMEM, _conv_tree,
                                         _sigmoid, conv_model)
from test_torch_tf32_gemm import FUSED_REL_TOL, _close, _gelu

# the three pyramid levels of the 336x512 bucket's 1344x2048 HR size
LEVELS = [(1344, 2048), (672, 1024), (336, 512)]


def _check_convs(plan, h, w, tiles):
    for c, (nt, mt) in zip(plan.convs, tiles):
        assert (c.nt, c.mt) == (nt, mt)
        assert c.tiles == -(-h // (8 * mt)) * -(-w // TILE_W)
        assert c.blocks == c.tiles * c.coutp // (8 * nt)
        assert c.coutp % (8 * nt) == 0 and c.coutp >= c.cout
        assert c.smem <= BLOCK_SMEM
        assert 2 * (c.smem + BLOCK_RESERVED) <= SM_SMEM
    assert plan.scratch_floats == 18 * sum(c.cinp * c.coutp
                                           for c in plan.convs)


# ------------------------------------------------------------ the plans


@pytest.mark.parametrize("hw", [*LEVELS, *BORDER_SHAPES])
def test_refine_plan(hw):
    """conv1 3 -> 32 (3 channels padded to 8: one stage), conv2 32 -> 32,
    conv3 over (h, lap) 32 + 3 padded to 32 + 8, all at 4 n-tiles (the
    block holds all 32 channels, as the squeeze needs) on 24-row tiles;
    the attention conv 8 -> 1 padded to one n-tile on 32-row tiles."""
    h, w = hw
    p = plan_edge(h, w)
    assert p.sources == ((8,), (32,), (32, 8), (8,))
    assert [c[:4] for c in p.convs] == [(3, 32, 8, 32), (32, 32, 32, 32),
                                        (35, 32, 40, 32), (8, 1, 8, 8)]
    _check_convs(p, h, w, edge_ops.REFINE_TILES)
    assert p.scratch_floats == 18 * (8 * 32 + 32 * 32 + 40 * 32 + 8 * 8)


@pytest.mark.parametrize("hw", [LEVELS[0], *BORDER_SHAPES])
def test_fuse_plan(hw):
    """fusion_0 over (f0, f1, f2), 3 x 32 channels with no padding, at 4
    n-tiles on 24-row tiles; fusion_2 32 -> 3 padded to one n-tile;
    edge_gate_0 over (sr, edge) 3 + 3 padded to 8 + 8, 2 n-tiles;
    edge_gate_2 16 -> 1; the last three on 32-row tiles."""
    h, w = hw
    p = plan_edge(h, w, 3, 32, fuse=True)
    assert p.sources == ((32, 32, 32), (32,), (8, 8), (16,))
    assert [c[:4] for c in p.convs] == [(96, 32, 96, 32), (32, 3, 32, 8),
                                        (6, 16, 16, 16), (16, 1, 16, 8)]
    _check_convs(p, h, w, edge_ops.FUSE_TILES)


def test_plan_pads_other_widths():
    """A 5-channel level pads to 8 on its own in conv1 and in conv3's
    second source; fuse levels of 20 channels pad each to 24."""
    assert plan_edge(20, 36, 5).sources == ((8,), (32,), (32, 8), (8,))
    assert plan_edge(20, 36, 3, 20, fuse=True).sources[0] == (24, 24, 24)


# ------------------------------------------------------- the arithmetic


def _stack(xs, ws, pads):
    """Sources padded to their own widths and concatenated, the weights'
    rows likewise: the input and K order of a multi-source conv."""
    xo, wo = [], []
    for x, w, p in zip(xs, ws, pads):
        xp = np.zeros(x.shape[:3] + (p,), np.float32)
        xp[..., :x.shape[-1]] = x
        wp = np.zeros((3, 3, p, w.shape[-1]), np.float32)
        wp[:, :, :w.shape[2]] = w
        xo.append(xp)
        wo.append(wp)
    return np.concatenate(xo, -1), np.concatenate(wo, 2)


def _n(t):
    return t.numpy()


def refine_model(lap, p, terms=3):
    """csrc/edge.cu's refine on plan_edge's padded sources: conv1, conv2,
    conv3 over (h, lap) with the projection at the centre tap and the two
    biases summed, the squeeze gelu(hid A0 + a0) in fp32 (conv3's
    epilogue), the attention conv and hid times its gate."""
    cin = lap.shape[-1]
    src = plan_edge(lap.shape[1], lap.shape[2], cin).sources

    def conv(x, q, i):
        return conv_model(x, _n(q["kernel"]), _n(q["bias"]), src[i][0],
                          terms)
    a = _gelu(conv(lap, p["conv1"], 0))
    hh = _gelu(conv(a, p["conv2"], 1))
    proj = np.zeros((3, 3, cin, 32), np.float32)
    proj[1, 1] = _n(p["proj"]["kernel"])[0, 0]
    x, w = _stack([hh, lap], [_n(p["conv3"]["kernel"]), proj], src[2])
    bias = (_n(p["conv3"]["bias"]) + _n(p["proj"]["bias"])).astype(np.float32)
    hid = conv_model(x, w, bias, sum(src[2]), terms)
    sq = _gelu((hid @ _n(p["attn_0"]["kernel"])[0, 0]
                + _n(p["attn_0"]["bias"])).astype(np.float32))
    gate = _sigmoid(conv(sq, p["attn_2"], 3))
    return (hid * gate).astype(np.float32)


def fuse_model(sr, fs, lw, k, p, terms=3):
    """csrc/edge.cu's fuse on plan_edge's padded sources: fusion_0 over
    (f0, f1, f2) with level l's rows scaled by lw[l] in fp32, fusion_2,
    edge_gate_0 over (sr, edge), edge_gate_2, then clip(sr + (k gate)
    edge). Returns the output, the edge and the gate."""
    h, w, f = fs[0].shape[1:]
    src = plan_edge(h, w, 3, f, fuse=True).sources
    k0 = _n(p["fusion_0"]["kernel"])
    x, wc = _stack(fs, [(k0[:, :, f * i:f * (i + 1)] * lw[i])
                        .astype(np.float32) for i in range(3)], src[0])
    e1 = _gelu(conv_model(x, wc, _n(p["fusion_0"]["bias"]), sum(src[0]),
                          terms))
    edge = conv_model(e1, _n(p["fusion_2"]["kernel"]),
                      _n(p["fusion_2"]["bias"]), src[1][0], terms)
    g0 = _n(p["edge_gate_0"]["kernel"])
    x, wc = _stack([sr, edge], [g0[:, :, :3], g0[:, :, 3:]], src[2])
    g = _gelu(conv_model(x, wc, _n(p["edge_gate_0"]["bias"]), sum(src[2]),
                         terms))
    gate = _sigmoid(conv_model(g, _n(p["edge_gate_2"]["kernel"]),
                               _n(p["edge_gate_2"]["bias"]), src[3][0],
                               terms)).astype(np.float32)
    out = np.clip(sr + (np.float32(k) * gate) * edge, 0.0, 1.0)
    return out.astype(np.float32), edge, gate


def _refine_tree(rng):
    return {"proj": _conv_tree(rng, 1, 3, 32),
            "conv1": _conv_tree(rng, 3, 3, 32),
            "conv2": _conv_tree(rng, 3, 32, 32),
            "conv3": _conv_tree(rng, 3, 32, 32),
            "attn_0": _conv_tree(rng, 1, 32, 8),
            "attn_2": _conv_tree(rng, 3, 8, 1)}


def _fuse_tree(rng):
    return {"fusion_0": _conv_tree(rng, 3, 96, 32),
            "fusion_2": _conv_tree(rng, 3, 32, 3),
            "edge_gate_0": _conv_tree(rng, 3, 6, 16),
            "edge_gate_2": _conv_tree(rng, 3, 16, 1)}


def _image(rng, shape, nchw, offset=0.0):
    """[B, H, W, C] float32 as numpy, drawn NHWC or NCHW (then viewed)."""
    b, h, w, c = shape
    a = offset + rng.normal(size=(b, c, h, w) if nchw else shape)
    t = torch.from_numpy(a.astype(np.float32))
    return t.permute(0, 2, 3, 1) if nchw else t


@pytest.mark.parametrize("nchw", [False, True])
def test_refine_model_matches_reference(nchw):
    """The model of the refine chain at B 2, 20 x 36 (three tiles across,
    the last partial; fewer rows than a tile), lap NHWC and as an NCHW
    view, within FUSED_REL_TOL of the plain version."""
    rng = np.random.default_rng(20 + nchw)
    p = _refine_tree(rng)
    lap = _image(rng, (2, 20, 36, 3), nchw)
    want = edge_refine_fused_reference(lap, p).numpy()
    _close(refine_model(np.ascontiguousarray(lap.numpy()), p), want)


def _fuse_inputs(rng, nchw, shape=(2, 20, 36)):
    p = _fuse_tree(rng)
    sr = torch.from_numpy(np.clip(0.5 + 0.1 * rng.normal(size=shape + (3,)),
                                  0, 1).astype(np.float32))
    if nchw:
        sr = sr.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    fs = [_image(rng, shape + (32,), nchw) for _ in range(3)]
    lw = torch.softmax(torch.from_numpy(rng.normal(size=3)
                                        .astype(np.float32)), 0)
    return p, sr, fs, lw


@pytest.mark.parametrize("nchw", [False, True])
def test_fuse_model_matches_reference(nchw):
    """The model of the fuse chain at B 2, 20 x 36, the inputs NHWC and as
    NCHW views, strength 1.5, within FUSED_REL_TOL of the plain
    version."""
    rng = np.random.default_rng(21 + nchw)
    p, sr, fs, lw = _fuse_inputs(rng, nchw)
    k = torch.tensor(1.5)
    want = edge_fuse_fused_reference(sr, *fs, lw, k, p).numpy()
    got, _, _ = fuse_model(np.ascontiguousarray(sr.numpy()),
                           [np.ascontiguousarray(f.numpy()) for f in fs],
                           lw.numpy(), 1.5, p)
    _close(got, want)


def _miss(got, want):
    """The max-abs error in units of FUSED_REL_TOL's tolerance."""
    tol = FUSED_REL_TOL * max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) / tol


def test_refine_needs_the_lo_products():
    """lap 8 + N(0, 1) (the card's precision guard's inputs): the 3xTF32
    model holds FUSED_REL_TOL with a wide margin, where one TF32 product a
    conv misses it (~8x here), so the guard can tell the two apart."""
    rng = np.random.default_rng(20)
    p = _refine_tree(rng)
    lap = (8 + rng.normal(size=(1, 24, 40, 3))).astype(np.float32)
    want = edge_refine_fused_reference(torch.from_numpy(lap), p).numpy()
    assert _miss(refine_model(lap, p), want) < 0.1
    assert _miss(refine_model(lap, p, terms=1), want) > 2


def centre_edge(p, fs, lw):
    """fusion_2's bias set to minus the mean of its conv over the image:
    an edge of large terms that cancel to a moderate value, so an error
    of the terms' size shows through a gate that keeps the output
    unclipped (the card's precision guard does the same)."""
    allf = torch.cat([f * lw[i] for i, f in enumerate(fs)], -1)
    e = conv3x3(F.gelu(conv3x3(allf, p["fusion_0"])),
                {"kernel": p["fusion_2"]["kernel"]})
    p["fusion_2"]["bias"] = -e.mean((0, 1, 2))


def test_fuse_needs_the_lo_products():
    """Levels 8 + N(0, 1), sr 0.5 + 0.1 N(0, 1), strength 1, the edge
    centred (centre_edge) and the gate held near 0.2 (edge_gate_2's kernel
    at a tenth, its bias log(0.25)): under 10% of the outputs clip (~1%
    here), the 3xTF32 model holds FUSED_REL_TOL with a wide margin, and
    one TF32 product a conv misses it (~5x here)."""
    rng = np.random.default_rng(21)
    p, sr, fs, lw = _fuse_inputs(rng, False, (1, 24, 40))
    fs = [f + 8 for f in fs]
    p["edge_gate_2"]["kernel"] *= 0.1
    p["edge_gate_2"]["bias"] = torch.full((1,), float(np.log(0.25)))
    centre_edge(p, fs, lw)
    k = torch.tensor(1.0)
    want = edge_fuse_fused_reference(sr, *fs, lw, k, p).numpy()
    args = (sr.numpy(), [f.numpy() for f in fs], lw.numpy(), 1.0, p)
    got, edge, gate = fuse_model(*args)
    pre = sr.numpy() + gate * edge
    assert float(((pre < 0) | (pre > 1)).mean()) < 0.1
    assert _miss(got, want) < 0.1
    assert _miss(fuse_model(*args, terms=1)[0], want) > 2
