"""The per-pixel token attention's plan, weight layout and 3xTF32
arithmetic, on the CPU.

``csrc/token_attention.cu`` (TPU kernel #13) runs in two launches: one
lays the weights out (per head its q | k | v columns, each head dim padded
to 16 and the 1/sqrt(hd) q-scale folded in, then its rows of Wout, all in
mma.sync's fragment order, as pieces a block bulk-copies whole), then a
persistent kernel walks tiles of whole pixels head by head: q_h | k_h |
v_h in 3xTF32 on the tensor cores, the softmax on the fp32 cores (exp2 of
log2(e)-scaled logits), out += o_h Wout_h in 3xTF32, the sum over heads
kept in registers. These tests check the plans
``ops/token_attention.py:plan_token_attention`` makes at the path's
shapes and others, lay the weights out in numpy as the layout launch does
and read them back as the kernel's lanes do, and hold a numpy model of the
kernel's arithmetic (hi/lo splits, lo*hi + hi*lo + hi*hi in fp32 k8 steps,
head by head) to the plain version within ``FUSED_REL_TOL``, where one
TF32 product misses it on the card's precision-guard inputs. The rounding
model is ``test_torch_tf32_gemm.py``'s; the card tests
(``tests/test_torch_kernels_cuda.py``) run the kernel itself. Last, the
gated module against the JAX package, handing the kernel its weights as
views.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from freqfusion_tpu.models.fusion.lka import (
    TokenMultiheadAttention as JaxTokenAttention)
from freqfusion_tpu_torch.models.fusion import lka as lka_mod
from freqfusion_tpu_torch.models.fusion.lka import TokenMultiheadAttention
from freqfusion_tpu_torch.ops import token_attention as ta_ops
from freqfusion_tpu_torch.ops.tf32_gemm import SMEM_LIMIT
from freqfusion_tpu_torch.ops.token_attention import (
    plan_token_attention, token_attention_reference)
from test_torch_harness import MODEL_TOL, perturb
from test_torch_tf32_gemm import FUSED_REL_TOL, _close, split

P_PATH = 336 * 512  # the 336x512 bucket's pixels
# phase 3 (9 bands, E 64, 4 heads) and phase 4 (4 experts, E 128, 8 heads)
GEOMETRIES = [(9, 64, 4), (4, 128, 8)]
LOG2E = np.float32(1.4426950408889634)


# ------------------------------------------------------------ the plans


@pytest.mark.parametrize("t,e,nh", GEOMETRIES)
@pytest.mark.parametrize("p", [P_PATH, 5, 7, 14000, P_PATH - 1])
def test_plan(t, e, nh, p):
    """Tiles of whole pixels in two teams (7 pixels a team at T 9, 16 at
    T 4: 63 and 64 of a team's 64 rows), rows padded to whole m-tiles of
    the warps' 32-row groups, tiles covering P, shared memory within a
    block's limit and the scratch (the laid-out weights and the biases).
    T 9: 8 warps, a head a group, a ring of three 64 x 48 pieces, two
    blocks an SM; T 4: 16 warps, two heads a group, a ring of two 128 x 96
    pieces, one block."""
    plan = plan_token_attention(p, t, e, nh)
    wc = {9: 2, 4: 4}[t]
    assert (plan.wc, plan.heads, plan.stages) == (wc, wc // 2,
                                                  {9: 3, 4: 2}[t])
    assert plan.teams == 2 and plan.pixels == {9: 7, 4: 16}[t]
    assert plan.rows == plan.pixels * t <= plan.rows_pad == 64
    assert plan.rows_pad - plan.rows < t
    tile = plan.teams * plan.pixels
    assert (plan.tiles - 1) * tile < p <= plan.tiles * tile
    assert (plan.hdq, plan.kp, plan.np) == (16, e, e)
    assert plan.groups * plan.heads == nh and plan.chunks == 1
    assert plan.piece_floats == 24 * wc * e
    gw = 16 * plan.heads
    assert plan.smem == 4 * (plan.stages * plan.piece_floats
                             + 2 * 64 * (e + 8 + 3 * gw + 8)) \
        + 16 * plan.stages
    assert plan.smem <= SMEM_LIMIT
    assert plan.smem == {9: 102448, 4: 221216}[t]
    assert plan.blocks_per_sm == {9: 2, 4: 1}[t]
    assert plan.weight_floats == nh * 16 * 4 * e == 4 * e * e
    assert plan.scratch_floats == plan.weight_floats + 3 * e + e
    assert plan.l2_weight_bytes == 16 * e * e * plan.tiles


def test_plan_l2_weight_bytes_at_the_path():
    """A call at 336x512 streams 64 KB of weights a tile at T 9 (12,288
    tiles) and 256 KB at T 4 (5,376 tiles): 0.81 and 1.41 GB from L2."""
    assert plan_token_attention(P_PATH, 9, 64, 4).l2_weight_bytes == \
        65536 * 12288
    assert plan_token_attention(P_PATH, 4, 128, 8).l2_weight_bytes == \
        262144 * 5376


@pytest.mark.parametrize("t,e,nh,wc,teams,rows_pad", [
    (16, 160, 1, 2, 1, 32), (16, 160, 2, 2, 2, 32), (9, 160, 10, 4, 2, 32),
    (9, 96, 6, 4, 2, 64), (1, 4, 1, 2, 2, 64), (3, 12, 4, 2, 2, 64)])
def test_plan_other_geometries(t, e, nh, wc, teams, rows_pad):
    """Heads wider than 16 pad to whole 16s, take a group each and shrink
    the teams' rows until the shared memory fits (E 160 in two heads: two
    teams of 32 rows; in one: one team of 32); heads of 16 or less go two
    a group on 16 warps at E > 64 (E 160: teams of 32 rows; six heads at
    E 96: three groups); E 4 and E 12 pad K to 8 and the out product to
    its 64 columns."""
    plan = plan_token_attention(1000, t, e, nh)
    assert (plan.wc, plan.teams, plan.rows_pad) == (wc, teams, rows_pad)
    assert plan.smem <= SMEM_LIMIT
    assert plan.rows == plan.pixels * t <= plan.rows_pad
    assert plan.hdq == -(-(e // nh) // 16) * 16
    assert plan.groups == -(-nh // plan.heads)
    assert plan.chunks * 8 * wc == plan.heads * plan.hdq
    assert plan.kp == -(-e // 8) * 8 and plan.np >= e


# ------------------------------------------------ the layout, in numpy


def layout(win, bin_, wout, bout, nh):
    """The layout launch's output. A group's columns are [q | k | v],
    each heads hdq wide (head i of the group at i hdq, hd real, q scaled);
    its pieces: `chunks` q|k|v pieces (kp x 24 wc: [k8 block][3 wc
    n-tiles][32 lanes][2]), then `chunks` out pieces (8 wc rows of the
    group's Wout rows x np: [wc k8 blocks][np / 8 n-tiles][32][2]), lane
    (g, t) of a unit holding W[8 kb + 2t][8 nt + g] and W[8 kb + 2t +
    1][8 nt + g]; then the biases (per group q|k|v, q scaled; bout padded
    to np)."""
    e = win.shape[0]
    plan = plan_token_attention(1, 1, e, nh)
    hd, hdq, kp, np_, wc = e // nh, plan.hdq, plan.kp, plan.np, plan.wc
    gw = plan.heads * hdq
    scale = np.float32(1) / np.sqrt(np.float32(hd))
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    stream, biases = [], []
    for grp in range(plan.groups):
        # the group's [kp, 3 gw] q|k|v block and [gw, np] Wout rows
        wq = np.zeros((kp, 3 * gw), np.float32)
        bq = np.zeros(3 * gw, np.float32)
        wo = np.zeros((gw, np_), np.float32)
        for i in range(plan.heads):
            h = grp * plan.heads + i
            if h >= nh:
                continue
            for part in range(3):
                cols = part * e + h * hd + np.arange(hd)
                s = scale if part == 0 else np.float32(1)
                at = part * gw + i * hdq
                wq[:e, at:at + hd] = win[:, cols] * s
                bq[at:at + hd] = bin_[cols] * s
            wo[i * hdq:i * hdq + hd, :e] = wout[h * hd:(h + 1) * hd]
        for c in range(plan.chunks):
            w = wq[:, 24 * wc * c:24 * wc * (c + 1)]
            k = 8 * np.arange(kp // 8)[:, None, None] + 2 * t
            n = 8 * np.arange(3 * wc)[None, :, None] + g
            stream.append(np.stack([w[k, n], w[k + 1, n]], -1).ravel())
        for c in range(plan.chunks):
            w = wo[8 * wc * c:8 * wc * (c + 1)]
            k = 8 * np.arange(wc)[:, None, None] + 2 * t
            n = 8 * np.arange(np_ // 8)[None, :, None] + g
            stream.append(np.stack([w[k, n], w[k + 1, n]], -1).ravel())
        biases.append(bq)
    bo = np.zeros(np_, np.float32)
    bo[:e] = bout
    out = np.concatenate(stream + biases + [bo])
    assert out.size == plan.scratch_floats
    return out


def read_piece(piece, k8s, ntiles):
    """A piece as the kernel's lanes read it: lane (g, t)'s float2 of
    unit (kb, nt) holds fragment rows t and t + 4, i.e. K rows 2t and 2t
    + 1 of the k8 block, column g of the n-tile."""
    u = piece.reshape(k8s, ntiles, 8, 4, 2)  # kb, nt, g, t, e
    return u.transpose(0, 3, 4, 1, 2).reshape(8 * k8s, 8 * ntiles)


def mma_steps(acc, a, b, terms=3):
    """acc += a b in k8 steps, each lo*hi + hi*lo + hi*hi (terms 3) or
    hi*hi alone (terms 1) of the split operands, into an fp32 sum."""
    for k0 in range(0, a.shape[1], 8):
        ah, al = split(a[:, k0:k0 + 8])
        bh, bl = split(b[k0:k0 + 8])
        pairs = [(al, bh), (ah, bl), (ah, bh)] if terms == 3 else [(ah, bh)]
        for p, q in pairs:
            acc = (acc + p.astype(np.float64) @ q.astype(np.float64)).astype(
                np.float32)
    return acc


def kernel_model(x, scratch, nh, terms=3):
    """csrc/token_attention.cu's arithmetic on the laid-out weights: a
    tile's rows (zero-padded to kp columns), group by group the q|k|v
    pieces (bias added in fp32), each head's softmax as exp2 of
    log2(e)-scaled logits, the group's o (padded to hdq a head) times the
    out pieces into the one fp32 sum over groups, then bout."""
    p, t, e = x.shape
    plan = plan_token_attention(p, t, e, nh)
    hdq, kp, np_, wc = plan.hdq, plan.kp, plan.np, plan.wc
    gw = plan.heads * hdq
    rows = np.zeros((p * t, kp), np.float32)
    rows[:, :e] = x.reshape(-1, e)
    bias = scratch[plan.weight_floats:]
    acc = np.zeros((p * t, np_), np.float32)
    off = 0
    for grp in range(plan.groups):
        qkv = np.zeros((p * t, 3 * gw), np.float32)
        for c in range(plan.chunks):
            w = read_piece(scratch[off:off + 24 * wc * kp], kp // 8, 3 * wc)
            off += 24 * wc * kp
            qkv[:, 24 * wc * c:24 * wc * (c + 1)] = mma_steps(
                np.zeros((p * t, 24 * wc), np.float32), rows, w, terms)
        qkv = (qkv + bias[3 * grp * gw:3 * (grp + 1) * gw]).astype(
            np.float32)
        o = np.zeros((p, t, gw), np.float32)
        for i in range(plan.heads):
            q, k, v = (qkv[:, part * gw + i * hdq:part * gw + (i + 1) * hdq]
                       .reshape(p, t, hdq) for part in range(3))
            s = np.einsum("pid,pjd->pij", q, k).astype(np.float32) * LOG2E
            s = np.exp2(s - s.max(-1, keepdims=True)).astype(np.float32)
            o[..., i * hdq:(i + 1) * hdq] = (
                np.einsum("pij,pjd->pid", s, v).astype(np.float32)
                / s.sum(-1, keepdims=True))
        o = o.reshape(-1, gw)
        for c in range(plan.chunks):
            w = read_piece(scratch[off:off + 8 * wc * np_], wc, np_ // 8)
            off += 8 * wc * np_
            acc = mma_steps(acc, o[:, 8 * wc * c:8 * wc * (c + 1)], w, terms)
    assert off == plan.weight_floats
    out = acc + bias[3 * plan.groups * gw:]
    return out[:, :e].astype(np.float32).reshape(p, t, e)


def _inputs(rng, p, t, e, offset=0.0):
    x = (offset + rng.normal(size=(p, t, e))).astype(np.float32)
    win = (rng.normal(size=(e, 3 * e)) / np.sqrt(e)).astype(np.float32)
    wout = (rng.normal(size=(e, e)) / np.sqrt(e)).astype(np.float32)
    bin_ = (0.1 * rng.normal(size=3 * e)).astype(np.float32)
    bout = (0.1 * rng.normal(size=e)).astype(np.float32)
    return [x, win, bin_, wout, bout]


def _reference(args, nh):
    return token_attention_reference(
        *(torch.from_numpy(a) for a in args), nh).numpy()


OTHER = [(5, 24, 2), (3, 36, 1), (2, 72, 6), (6, 120, 10)]


@pytest.mark.parametrize("t,e,nh", GEOMETRIES + OTHER)
def test_layout_reads_back(t, e, nh):
    """The pieces, read as the kernel's lanes read them, give back the
    weights: head 0's q scaled by 1/sqrt(hd) (0.25 at hd 16, exact), its
    columns padded to hdq with zeros, the last group's Wout rows (with a
    zero head where the heads do not fill it: E 120 in ten heads of 12)."""
    rng = np.random.default_rng(t + e)
    _, win, bin_, wout, bout = _inputs(rng, 1, t, e)
    scratch = layout(win, bin_, wout, bout, nh)
    plan = plan_token_attention(1, t, e, nh)
    hd, hdq, kp, wc = e // nh, plan.hdq, plan.kp, plan.wc
    scale = np.float32(1) / np.sqrt(np.float32(hd))
    q0 = read_piece(scratch[:24 * wc * kp], kp // 8, 3 * wc)
    np.testing.assert_array_equal(q0[:e, :min(hd, 16)],
                                  win[:, :min(hd, 16)] * scale)
    assert not q0[e:].any() and not q0[:, hd:16].any()
    group = plan.weight_floats // plan.groups
    out_rows = np.concatenate([
        read_piece(scratch[group * (plan.groups - 1) + off:][:8 * wc
                                                             * plan.np],
                   wc, plan.np // 8)
        for off in range(24 * wc * kp * plan.chunks, group,
                         8 * wc * plan.np)])
    first = (plan.groups - 1) * plan.heads
    for i in range(plan.heads):
        got = out_rows[i * hdq:(i + 1) * hdq]
        if first + i < nh:
            np.testing.assert_array_equal(
                got[:hd, :e], wout[(first + i) * hd:(first + i + 1) * hd])
            assert not got[hd:].any()
        else:
            assert not got.any()
    assert not out_rows[:, e:].any()


@pytest.mark.parametrize("t,e,nh", GEOMETRIES + OTHER)
def test_model_matches_reference(t, e, nh):
    """The model on the laid-out weights, at 37 pixels (a tile holds 14
    at T 9: a partial third), within FUSED_REL_TOL of the plain
    version; also at head dims 12 and 36 (padded to 16 and 48, a head a
    group) and 12 in two heads a group (E 72, E 120 with a zero head)."""
    rng = np.random.default_rng(3 * t + e)
    args = _inputs(rng, 37, t, e)
    scratch = layout(*args[1:], nh)
    _close(kernel_model(args[0], scratch, nh), _reference(args, nh))


def guard_inputs(rng, p, t, e, nh):
    """The card's precision-guard inputs: x 2 + N(0, 1), out_b centred
    (minus the mean over rows of the output it would give), so the output
    is a moderate difference of larger terms."""
    args = _inputs(rng, p, t, e, offset=2.0)
    args[4] = (args[4] - _reference(args, nh).reshape(-1, e).mean(0)
               ).astype(np.float32)
    return args


def _miss(got, want):
    """The max-abs error in units of FUSED_REL_TOL's tolerance."""
    tol = FUSED_REL_TOL * max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) / tol


@pytest.mark.parametrize("t,e,nh", GEOMETRIES)
def test_one_tf32_product_misses(t, e, nh):
    """On the guard inputs the 3xTF32 model holds FUSED_REL_TOL with a
    wide margin (~0.015 of it), where the same kernel with one TF32
    product (hi*hi) misses it (~13x here), so the card's guard can tell
    the two apart."""
    rng = np.random.default_rng(t + 13)
    args = guard_inputs(rng, 200, t, e, nh)
    want = _reference(args, nh)
    scratch = layout(*args[1:], nh)
    assert _miss(kernel_model(args[0], scratch, nh), want) < 0.1
    assert _miss(kernel_model(args[0], scratch, nh, terms=1), want) > 4


# ------------------------------------------- the gated module against JAX


def test_gated_module_hands_views(monkeypatch):
    """With FREQFUSION_TOKEN_ATTN=1 the module hands the kernel's wrapper
    the transposed views of in_proj_weight and out_proj.weight (their
    storage, strides (1, E)), not copies, and still matches the JAX
    package's gated module (phase 4's geometry over [1, 3, 5] pixels)."""
    monkeypatch.setenv("FREQFUSION_TOKEN_ATTN", "1")
    monkeypatch.setenv("FREQFUSION_PALLAS", "1")
    t, e, nh = 4, 128, 8
    mod = TokenMultiheadAttention(e, nh)
    with torch.no_grad():
        mod.reset_extra(torch.Generator().manual_seed(40))
    perturb(mod, 41)
    seen = []

    def spy(x, in_w, in_b, out_w, out_b, heads):
        seen.append((in_w, out_w))
        return ta_ops.token_attention(x, in_w, in_b, out_w, out_b, heads)
    monkeypatch.setattr(lka_mod, "token_attention", spy)
    params = {"params": {
        "in_proj_weight": mod.in_proj_weight.detach().numpy().T,
        "in_proj_bias": mod.in_proj_bias.detach().numpy(),
        "out_proj": {"kernel": mod.out_proj.weight.detach().numpy().T,
                     "bias": mod.out_proj.bias.detach().numpy()}}}
    x = np.random.default_rng(42).standard_normal((1, 3, 5, t, e)).astype(
        np.float32)
    want = JaxTokenAttention(nh).apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    (in_w, out_w), = seen
    assert in_w.data_ptr() == mod.in_proj_weight.data_ptr()
    assert out_w.data_ptr() == mod.out_proj.weight.data_ptr()
    assert in_w.stride() == out_w.stride() == (1, e)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
