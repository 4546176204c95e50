"""The bf16 chain_proj kernel's operands and softplus, on the CPU.

``ops/selective_scan.py:chain_proj_operands`` builds what the bf16 #3/#4
kernel takes of one SS2D direction's parameters (the composed weight in
the wgmma projection's order, D and the dt bias in fp32) once, and reuses
it while the parameters stay as they were. These tests hold it bit-equal
to what the wrapper built on every call before (:func:`composed_weight`
and the fp32 casts), reused across calls, and
rebuilt after an in-place update, ``load_state_dict``, a dtype cast and
a ``.data`` swap (and, after a write through ``.data``, which no version
counter sees, by ``clear_chain_proj_operands``), dropped with their
parameters; the weight's layout read back in the kernel's order; and numpy models of
the bf16 passes' softplus and of pass 1's exponentials on the FMA pipe
(``softplus_fma`` and ``ex2_fma`` in ``csrc/selective_scan.cu``, their
coefficients read from the source) against ``F.softplus`` and 2^x; and
``chip_smoke.py``'s operations term of the scan bounds, which shares the
exponentials between the SFU and the fp32 lanes."""

import gc
import importlib.util
import re
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from freqfusion_tpu_torch.models.mambair import SS2D
from freqfusion_tpu_torch.ops import selective_scan as ss

CSRC = (Path(__file__).resolve().parent.parent / "freqfusion_tpu_torch" /
        "csrc" / "selective_scan.cu")


def _ss2d(dtype=torch.float32, seed=0) -> SS2D:
    torch.manual_seed(seed)
    m = SS2D(d_model=12, d_state=4)  # d_inner 24, dt_rank 1
    with torch.no_grad():
        for p in m.parameters():
            p.normal_()
    return m.to(dtype)


def _direction(m: SS2D, k: int):
    """The views SS2D.forward hands the scan for direction k."""
    d = m.d_inner
    return (m.x_proj_weight[k], m.dt_projs_weight[k], m.Ds.view(4, d)[k],
            m.dt_projs_bias[k])


def _operands(m: SS2D, k: int):
    return ss.chain_proj_operands(*_direction(m, k), m.d_state)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _composed(m: SS2D, k: int) -> torch.Tensor:
    """What the wrapper built on every call: composed_weight, laid out."""
    xpw, dtw, _, _ = _direction(m, k)
    return ss.weight_layout(ss.composed_weight(xpw, dtw, m.d_state))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_operands_bit_equal_to_the_per_call_build(dtype):
    """The cached weight is composed_weight's in the kernel's order, D and
    the bias their fp32 casts, bit for bit, for bf16 (the bf16 experts) and
    fp32 parameters."""
    m = _ss2d(dtype)
    for k in range(4):
        xpw, dtw, D, bias = _direction(m, k)
        ops = _operands(m, k)
        assert ops.wl.dtype == torch.bfloat16
        assert torch.equal(_bits(ops.wl), _bits(_composed(m, k)))
        assert torch.equal(_bits(ops.D), _bits(D.float().contiguous()))
        assert torch.equal(_bits(ops.bias), _bits(bias.float().contiguous()))


def test_operands_reused_across_calls():
    """Fresh views of unchanged parameters (as each forward makes them)
    find the same entry: no composition and no cast on later calls."""
    m = _ss2d(torch.bfloat16)
    first = [_operands(m, k) for k in range(4)]
    again = [_operands(m, k) for k in range(4)]
    assert all(a is b for a, b in zip(first, again))
    assert len({id(o) for o in first}) == 4  # one entry a direction


@pytest.mark.parametrize("which", ["x_proj_weight", "dt_projs_weight", "Ds",
                                   "dt_projs_bias"])
def test_operands_rebuilt_after_in_place_update(which):
    """An in-place update of any one parameter rebuilds the entry, which
    then matches the new parameters bit for bit."""
    m = _ss2d(torch.bfloat16)
    old = _operands(m, 1)
    with torch.no_grad():
        getattr(m, which).mul_(2)
    new = _operands(m, 1)
    assert new is not old
    _, _, D, bias = _direction(m, 1)
    assert torch.equal(_bits(new.wl), _bits(_composed(m, 1)))
    assert torch.equal(_bits(new.D), _bits(D.float()))
    assert torch.equal(_bits(new.bias), _bits(bias.float()))
    changed = (not torch.equal(_bits(new.wl), _bits(old.wl)),
               not torch.equal(_bits(new.D), _bits(old.D)),
               not torch.equal(_bits(new.bias), _bits(old.bias)))
    assert changed == {"x_proj_weight": (True, False, False),
                       "dt_projs_weight": (True, False, False),
                       "Ds": (False, True, False),
                       "dt_projs_bias": (False, False, True)}[which]


def test_operands_rebuilt_after_load_state_dict():
    """load_state_dict copies in place: the entry is rebuilt from the
    loaded values, for every direction."""
    m = _ss2d(torch.bfloat16, seed=0)
    before = [_operands(m, k) for k in range(4)]
    m.load_state_dict(_ss2d(torch.bfloat16, seed=1).state_dict())
    for k in range(4):
        got = _operands(m, k)
        assert got is not before[k]
        _, _, _, bias = _direction(m, k)
        assert torch.equal(_bits(got.wl), _bits(_composed(m, k)))
        assert torch.equal(_bits(got.bias), _bits(bias.float()))


def test_operands_rebuilt_after_dtype_cast():
    """The pipeline's cast replaces each parameter's data: the fp32
    module's entry is not taken for the bf16 one."""
    m = _ss2d(torch.float32)
    fp32 = _operands(m, 2)
    m.to(torch.bfloat16)
    bf16 = _operands(m, 2)
    assert bf16 is not fp32
    _, _, D, _ = _direction(m, 2)
    assert torch.equal(_bits(bf16.wl), _bits(_composed(m, 2)))
    assert torch.equal(_bits(bf16.D), _bits(D.float()))


def test_operands_rebuilt_after_a_data_swap():
    """Assigning a parameter's ``.data`` moves its address: the entry is
    rebuilt from the new values, though the version counter stays."""
    m = _ss2d(torch.bfloat16)
    old = _operands(m, 3)
    m.x_proj_weight.data = m.x_proj_weight.data * 2
    new = _operands(m, 3)
    assert new is not old
    assert torch.equal(_bits(new.wl), _bits(_composed(m, 3)))


def test_clear_after_a_write_through_data():
    """A write through ``.data`` bumps no version counter, so it needs
    ``clear_chain_proj_operands``; after it every direction is rebuilt
    from the written values."""
    m = _ss2d(torch.bfloat16)
    old = [_operands(m, k) for k in range(4)]
    m.dt_projs_weight.data.mul_(3)
    m.dt_projs_bias.data.add_(1)
    ss.clear_chain_proj_operands()
    for k in range(4):
        got = _operands(m, k)
        assert got is not old[k]
        _, _, _, bias = _direction(m, k)
        assert torch.equal(_bits(got.wl), _bits(_composed(m, k)))
        assert torch.equal(_bits(got.bias), _bits(bias.float()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_operands_dropped_with_their_parameters(dtype):
    """The operands hold no autograd graph and no reference to the
    parameters: when the module goes, its entries and their laid-out
    weights go with it."""
    m = _ss2d(dtype)
    ops = [_operands(m, k) for k in range(4)]
    assert not any(t.requires_grad for o in ops for t in o)
    assert ss._root(m.x_proj_weight[0]) in ss._OPERANDS
    gone = [weakref.ref(o.wl) for o in ops]
    key = weakref.ref(m.x_proj_weight)
    del m, ops
    gc.collect()
    assert key() is None and all(r() is None for r in gone)


@pytest.mark.parametrize("d,n,dtr", [(360, 16, 12), (60, 8, 4), (24, 4, 1)])
def test_weight_layout_reads_back_in_the_kernels_order(d, n, dtr):
    """wl[c, s, j, h, r, e] is wt[104 c + 8 j + r, 16 s + 8 h + e], zero
    past D + 2N columns and past D: each k16 slice of a 104-column chunk
    is one contiguous 3328-byte piece, core matrices of 8 rows x 16 bytes
    with the 8-row groups 256 bytes apart and the two halves of the k16
    step 128 apart, as the wgmma descriptors read them."""
    rng = np.random.default_rng(d)
    wt = torch.tensor(rng.normal(size=(d + 2 * n, d)),
                      dtype=torch.float32).to(torch.bfloat16)
    wl = ss.weight_layout(wt)
    nch, nk = -(-(d + 2 * n) // 104), -(-d // 16)
    assert wl.shape == (nch, nk, 13, 2, 8, 8) and wl.is_contiguous()
    flat = wl.reshape(-1)
    for c, s, j, h, r, e in rng.integers(0, [nch, nk, 13, 2, 8, 8],
                                         size=(400, 6)):
        byte = ((c * nk + s) * 3328 + j * 256 + h * 128 + r * 16 + e * 2)
        col, k = 104 * c + 8 * j + r, 16 * s + 8 * h + e
        want = wt[col, k] if col < d + 2 * n and k < d else 0.0
        assert flat[byte // 2] == want


def _softplus_fma_model(x: np.ndarray) -> np.ndarray:
    """csrc/selective_scan.cu's softplus_fma in float32 numpy: z =
    2^(-log2(e) |x|), q by Horner over the source's coefficients (each
    step rounded to float32 once, as an FMA rounds), max(x, 0) + z q."""
    src = CSRC.read_text()
    body = src[src.index("float softplus_fma(float x)"):]
    body = body[:body.index("return")]
    coef = [float(c.rstrip("f")) for c in re.findall(
        r"(-?\d+\.\d+(?:e-?\d+)?f)", body)]
    assert len(coef) == 9, coef
    x = x.astype(np.float32)
    z = np.exp2((-np.float32(1.4426950408889634) * np.abs(x)).astype(
        np.float64)).astype(np.float32)
    q = np.float32(coef[0])
    for c in coef[1:]:
        q = (q.astype(np.float64) * z + c).astype(np.float32)
    return (np.maximum(x, 0) + (z.astype(np.float64) * q)).astype(np.float32)


def test_softplus_polynomial_matches_softplus():
    """The FMA-only log1p keeps the present softplus's 2e-6 of F.softplus,
    relative to max(1, |softplus|) (small values keep their relative
    accuracy: z q(z) factors z out), over the dt bias range of the S6
    init and far beyond it."""
    x = np.concatenate([np.linspace(-30, 30, 200001),
                        -np.logspace(-6, 1.5, 5001),
                        np.logspace(-6, 1.5, 5001)]).astype(np.float32)
    got = _softplus_fma_model(x).astype(np.float64)
    want = F.softplus(torch.tensor(x, dtype=torch.float64)).numpy()
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= 2e-6
    small = want < 1.0
    assert (np.abs(got - want)[small] / want[small]).max() <= 2e-6


def _ex2_fma_model(x: np.ndarray) -> np.ndarray:
    """csrc/selective_scan.cu's ex2_fma in float32 numpy: the clamp at
    -126, k = rint(x) by the 1.5 * 2^23 shift, the degree-5 polynomial of
    2^f by Horner (each step rounded once, as an FMA rounds) and k added
    to the exponent bits."""
    src = CSRC.read_text()
    body = src[src.index("float ex2_fma(float x)"):]
    body = body[body.index("float p ="):body.index("return")]
    coef = [float(c.rstrip("f")) for c in re.findall(
        r"(-?\d+\.\d+(?:e-?\d+)?f)", body)]
    assert len(coef) == 6, coef
    x = np.maximum(x.astype(np.float32), np.float32(-126))
    t = (x + np.float32(12582912.0)).astype(np.float32)
    f = (x - (t - np.float32(12582912.0)).astype(np.float32)).astype(
        np.float32)
    p = np.float32(coef[0])
    for c in coef[1:]:
        p = (p.astype(np.float64) * f + c).astype(np.float32)
    return (p.view(np.int32) + (t.view(np.int32) << 23)).view(np.float32)


def test_ex2_polynomial_matches_exp2():
    """Pass 1's exponentials on the FMA pipe: within 3e-7 relative of 2^x
    over the scan's range (x = delta A log2(e) <= 0, down to the clamp),
    about ex2.approx.ftz's own 2^-22.5; below -126 a value under 2^-126,
    where ex2.approx.ftz flushes to zero (2^-126 times p(0), 1 + 1e-7)."""
    x = np.concatenate([np.linspace(-126, 0, 1000001),
                        -np.logspace(-8, 2, 10001)]).astype(np.float32)
    x = x[x >= -126]
    got = _ex2_fma_model(x).astype(np.float64)
    want = np.exp2(x.astype(np.float64))
    assert (np.abs(got - want) / want).max() <= 3e-7
    low = _ex2_fma_model(np.array([-127.5, -200.0, -1e6], np.float32))
    assert (0 <= low).all() and (low <= (1 + 2e-7) * 2.0 ** -126).all()


def _chip_smoke():
    path = CSRC.parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [0, 2 * 56],
                         ids=["passes", "chain_proj fp32"])
def test_scan_bound_shares_the_exponentials(extra):
    """The scans' operations term at the main shapes (four directions of
    L 172,032, D 360, N 16): below the SFU's time for all the
    exponentials and above the fp32 lanes' own work, at the share of
    exponentials on the SFU where both units take the same time, each
    moved one costing ex2_fma's 11 lane instructions."""
    cs = _chip_smoke()
    pd, n = 4 * 172032 * 360, 16
    flops, sfu = pd * (8.0 * n + 8 + extra), pd * n
    ms, sfu_ms = cs.operations_ms(flops, sfu_ops=sfu)
    f = 1e3 * flops / cs.PEAK_FLOPS
    assert sfu_ms == pytest.approx(1e3 * sfu / (16 * 132 * 1.98e9))
    assert f < ms < sfu_ms
    x = ms / sfu_ms  # the share on the SFU
    lanes = f + (1 - x) * 1e3 * sfu * 2 * 11 / cs.PEAK_FLOPS
    assert lanes == pytest.approx(ms, rel=1e-12)
    # no exponentials, or fewer than the lanes' work hides: unchanged
    assert cs.operations_ms(flops) == (f, 0.0)
    assert cs.operations_ms(flops, sfu_ops=sfu / 8)[0] == f
