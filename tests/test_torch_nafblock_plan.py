"""The NAFBlock's and the qkv window attention's 3xTF32 GEMM plans and
arithmetic, on the CPU.

``csrc/nafblock.cu`` (TPU kernel #16) and ``csrc/window_attention_qkv.cu``
(#11's two projections) run their products on ``csrc/tf32_gemm.cuh``'s
GEMM: A tiled with K padded to 16 and each image's rows padded to 128, the
weight split into hi/lo fragment order and zero-padded to blocks of 64 or
128 columns, three TF32 products an fp32 one. These tests check the plans
that ``ops/nafblock.py:plan_nafblock`` and
``ops/attention.py:plan_qkv_projections`` make at the path's shapes
(padding, edge tiles, shared memory under the card's limit, the scratch),
and hold a numpy model of the NAFBlock kernel's padded arithmetic (conv4's
gate halves interleaved by n-tile, conv3's rows scaled by each image's SCA
vector) to ``nafblock_fused_reference`` with two images. The rounding
model and the 3xTF32 sum at K = 1024 are in ``test_torch_tf32_gemm.py``;
the card tests (``tests/test_torch_kernels_cuda.py``) run the kernels.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from freqfusion_tpu_torch.ops import tf32_gemm
from freqfusion_tpu_torch.ops.attention import plan_qkv_projections
from freqfusion_tpu_torch.ops.nafblock import (nafblock_fused_reference,
                                               plan_nafblock)
from test_torch_tf32_gemm import _close, _layer_norm, product

# NAFNet-SIDD-64's five levels at the 1344x2048 HR size: C, H, W
NAF_LEVELS = [(64, 1344, 2048), (128, 672, 1024), (256, 336, 512),
              (512, 168, 256), (1024, 84, 128)]
SM_SMEM = 233472  # bytes of shared memory an SM has for blocks (228 KB)


def _round_up(v, m):
    return -(-v // m) * m


def _check_gemm(p, rows, k, n):
    """A GemmPlan of `rows` A rows: K and N padded to whole tiles, the
    block width the one padding N less (128 on a tie), shared memory under
    the limit with the blocks an SM the kernel's launch bounds ask for."""
    assert p.kp % tf32_gemm.BK == 0 and 0 <= p.kp - k < tf32_gemm.BK
    pads = {c: _round_up(n, c) for c in tf32_gemm.COLS}
    assert p.cols == (64 if pads[64] < pads[128] else 128)
    assert p.np == pads[p.cols] and p.np % p.cols == 0
    assert p.smem <= tf32_gemm.SMEM_LIMIT
    assert tf32_gemm.BLOCKS_PER_SM[p.cols] * (p.smem + 1024) <= SM_SMEM
    assert p.blocks == -(-rows // tf32_gemm.ROWS) * (p.np // p.cols)
    assert p.split_floats == 2 * p.kp * p.np


@pytest.mark.parametrize("c,h,w,batch", [*((c, h, w, 1)
                                           for c, h, w in NAF_LEVELS),
                                         (20, 13, 18, 2), (36, 5, 7, 2)])
def test_nafblock_plan(c, h, w, batch):
    """NAFNet's five levels (K = C, no padding; C 64's conv3/conv5 on
    64-column blocks, every other product on 128) and two narrow widths of
    4 mod 16 with two ragged images."""
    m = h * w
    p = plan_nafblock(m, c, batch)
    rows = batch * p.mpi
    assert p.kp == _round_up(c, 16) and p.mpi == _round_up(m, 128)
    _check_gemm(p.conv1, rows, c, 2 * c)
    _check_gemm(p.conv3, rows, c, c)
    _check_gemm(p.conv4, rows, c, 2 * p.kp)  # both halves, interleaved
    if c % 64 == 0:
        assert p.kp == c and p.conv4.np == 2 * c
        assert p.conv3.cols == (64 if c == 64 else 128)
        assert p.conv1.cols == p.conv4.cols == 128
    assert p.scratch_floats == (p.conv1.split_floats + p.conv4.split_floats
                                + (1 + batch) * p.conv3.split_floats
                                + 2 * rows * p.kp + 2 * batch * m * c)
    # nine launches: 72 C bytes a pixel at kp = C, against the bound's 8 C
    assert p.bytes_per_pixel == 4 * (10 * c + 8 * p.kp)
    assert p.bound_bytes_per_pixel == 8 * c


def test_nafblock_plan_rejects_wide_rows():
    plan_nafblock(10, 2048)
    with pytest.raises(ValueError):
        plan_nafblock(10, 2049)


@pytest.mark.parametrize("c,cols_qkv,cols_proj", [
    (180, 64, 64), (212, 128, 128), (244, 128, 128), (276, 64, 64),
    (308, 64, 64), (60, 64, 64), (106, 64, 128)])
def test_qkv_projection_plan(c, cols_qkv, cols_proj):
    """#11 at DRCT-L's five widths on the 336x512 bucket (172,032 rows)
    and at C 60 and 106 on a 16 x 24 image (384 rows): K = C padded to 16
    (every width here is 4 mod 8 or narrower than a stage), 3C and C
    padded to the block width that pads less, x and the attention's output
    sharing one tiled A."""
    m = 172032 if c >= 180 else 16 * 24
    p = plan_qkv_projections(m, c, c)
    assert p.mp == _round_up(m, 128)
    _check_gemm(p.qkv, p.mp, c, 3 * c)
    _check_gemm(p.proj, p.mp, c, c)
    assert (p.qkv.cols, p.proj.cols) == (cols_qkv, cols_proj)
    assert p.qkv.kp > c
    assert p.scratch_floats == (p.qkv.split_floats + p.proj.split_floats
                                + p.mp * max(p.qkv.kp, p.proj.kp))


def interleave_gate(w4: np.ndarray, kp: int, np_: int) -> np.ndarray:
    """conv4's weight [C, 2C] as csrc/tf32_gemm.cuh:gemm_split_kernel
    splits it for the gated epilogue, zero-padded to [kp, np_]: virtual
    n-tile 2i holds columns 8i..8i + 7 of the a half, 2i + 1 the same
    columns of the b half."""
    c = w4.shape[0]
    out = np.zeros((kp, np_), np.float32)
    for v in range(np_):
        nt = v // 8
        col = 8 * (nt // 2) + v % 8
        if col < c:
            out[:c, v] = w4[:, col + (nt % 2) * c]
    return out


def _tiled(rows: np.ndarray, b: int, mpi: int, kp: int) -> np.ndarray:
    """[B, P, C] rows as the GEMM's A: [B mpi, kp], padding zeros."""
    a = np.zeros((b, mpi, kp), np.float32)
    a[:, :rows.shape[1], :rows.shape[2]] = rows
    return a.reshape(b * mpi, kp)


def _padded(w: np.ndarray, kp: int, np_: int) -> np.ndarray:
    out = np.zeros((kp, np_), np.float32)
    out[:w.shape[0], :w.shape[1]] = w
    return out


def model_nafblock(x, w, same_w3=False):
    """csrc/nafblock.cu's arithmetic on its padded extents: LN1 into A
    (rows padded to 128 an image, K to 16), conv1 in 3xTF32, the depthwise
    conv and gate (fp32), the SCA vector s from g's mean, conv3 with W3's
    rows scaled by s_b per image (or image 0's for both: `same_w3`), the
    beta residual, LN2, conv4 on the interleaved weight with the gate in
    its epilogue, conv5 and the gamma residual. Returns (out, g2 as the
    gated epilogue writes it, [B mpi, kp])."""
    b, h, w_, c = x.shape
    hw = h * w_
    p = plan_nafblock(hw, c, b)
    kp, mpi = p.kp, p.mpi

    def mat(n):
        return w[n]["kernel"][0, 0]

    def real(a, n):  # A's real rows, first n columns -> [B, hw, n]
        return a.reshape(b, mpi, -1)[:, :hw, :n]

    xr = x.reshape(b, hw, c)
    t1 = _tiled(_layer_norm(xr, w["norm1"]["scale"], w["norm1"]["bias"],
                            1e-6), b, mpi, kp)
    u = real(product(t1, _padded(mat("conv1"), kp, p.conv1.np)), 2 * c) \
        + w["conv1"]["bias"]
    u = F.conv2d(torch.from_numpy(u.reshape(b, h, w_, 2 * c)).permute(
        0, 3, 1, 2), torch.from_numpy(w["conv2"]["kernel"]).permute(
        3, 2, 0, 1), torch.from_numpy(w["conv2"]["bias"]), padding=1,
        groups=2 * c).permute(0, 2, 3, 1).numpy().reshape(b, hw, 2 * c)
    g = u[..., :c] * u[..., c:]
    s = g.mean(1) @ mat("sca") + w["sca"]["bias"]
    a3 = _tiled(g, b, mpi, kp).reshape(b, mpi, kp)
    x3 = np.stack([product(a3[i], _padded(
        mat("conv3") * s[0 if same_w3 else i][:, None], kp, p.conv3.np)
    )[:hw, :c] for i in range(b)])
    y = xr + w["beta"] * (x3 + w["conv3"]["bias"])
    t2 = _tiled(_layer_norm(y, w["norm2"]["scale"], w["norm2"]["bias"],
                            1e-6), b, mpi, kp)
    acc = product(t2, interleave_gate(mat("conv4"), kp, p.conv4.np))
    g2 = np.zeros((b * mpi, kp), np.float32)
    for col in range(c):  # a half at virtual 16 (col // 8) + col % 8
        va = 16 * (col // 8) + col % 8
        g2[:, col] = ((acc[:, va] + w["conv4"]["bias"][col])
                      * (acc[:, va + 8] + w["conv4"]["bias"][c + col]))
    o = real(product(g2, _padded(mat("conv5"), kp, p.conv3.np)), c)
    out = y + w["gamma"] * (o + w["conv5"]["bias"])
    return out.reshape(b, h, w_, c).astype(np.float32), g2


def _naf_tree(rng, c):
    def conv(cin, cout):
        return {"kernel": (rng.normal(size=(1, 1, cin, cout))
                           / np.sqrt(cin)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=cout)).astype(np.float32)}

    def norm():
        return {"scale": (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=c)).astype(np.float32)}
    return {"norm1": norm(), "conv1": conv(c, 2 * c),
            "conv2": {"kernel": (0.3 * rng.normal(size=(3, 3, 1, 2 * c))
                                 ).astype(np.float32),
                      "bias": (0.1 * rng.normal(size=2 * c)).astype(
                          np.float32)},
            "sca": conv(c, c), "conv3": conv(c, c),
            "beta": (0.5 * rng.normal(size=c)).astype(np.float32),
            "norm2": norm(), "conv4": conv(c, 2 * c), "conv5": conv(c, c),
            "gamma": (0.5 * rng.normal(size=c)).astype(np.float32)}


def _torch_tree(w):
    return {k: ({n: torch.from_numpy(t) for n, t in v.items()}
                if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in w.items()}


@pytest.mark.parametrize("c,h,w", [(20, 5, 7), (36, 6, 11), (64, 9, 4)])
def test_nafblock_model_matches_the_plain_version(c, h, w):
    """Two images of ragged size (35 to 66 pixels, padded to 128 rows
    each), widths 4 mod 16 (K padded to 32 and 48) and 64: the padded,
    interleaved, s-folded model is within FUSED_REL_TOL of
    nafblock_fused_reference; g2's padding columns are exactly zero; and
    the two images' SCA vectors differ enough that giving both image 0's
    scaled W3 misses the tolerance (one W3 copy an image is needed)."""
    rng = np.random.default_rng(c + h)
    wt = _naf_tree(rng, c)
    x = rng.uniform(size=(2, h, w, c)).astype(np.float32)
    x[1] = 3 * x[1] - 1  # the second image's SCA vector differs
    want = nafblock_fused_reference(torch.from_numpy(x),
                                    _torch_tree(wt)).numpy()
    got, g2 = model_nafblock(x, wt)
    _close(got, want)
    assert not g2[:, c:].any()
    shared, _ = model_nafblock(x, wt, same_w3=True)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(shared - want).max()) > tol


def test_gate_interleave_holds_each_column_once():
    """Every real column j of both halves lands in exactly one virtual
    column, a's at 16 (j // 8) + j % 8 and b's 8 further on, in the same
    lane position (g = column % 8) of adjacent n-tiles."""
    c, kp = 20, 32
    w4 = np.arange(c * 2 * c, dtype=np.float32).reshape(c, 2 * c) + 1
    inter = interleave_gate(w4, kp, 2 * kp)
    for j in range(c):
        va = 16 * (j // 8) + j % 8
        np.testing.assert_array_equal(inter[:c, va], w4[:, j])
        np.testing.assert_array_equal(inter[:c, va + 8], w4[:, c + j])
    assert np.count_nonzero(inter.any(0)) == 2 * c
    assert not inter[c:].any()
