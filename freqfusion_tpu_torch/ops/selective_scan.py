"""Selective scan (Mamba S6 recurrence): the CUDA kernel and its plain version.

Counterpart of ``freqfusion_tpu/ops/selective_scan.py``. Recurrence per
batch b, channel d, state n, over sequence position t:

    delta = softplus(dt + dt_bias)
    h_t   = exp(delta_t * A) * h_{t-1} + delta_t * B_t * u_t      (fp32)
    y_t   = sum_n C_t[n] * h_t[n] + D * u_t

``selective_scan`` is the plain PyTorch version over [B, L, D]. The
entries take the JAX scan kernels' contracts and layouts:

- ``selective_scan_chain_proj`` (chain_fused / chain_proj, TPU kernels
  #3/#4): pre-silu xc [B, T, R, D], projections inside;
- ``selective_scan_chain`` (chain, #5): u, dt, B, C given, [B, T, R, D],
  whose scanned sequence is chain 0, then chain 1, ... (position r * T + t);
- ``selective_scan_flat`` (#6): [B, L, D];
- ``selective_scan_dirs`` (#7): K directions [K, B, L, D], each with its
  own A, D and bias;
- ``selective_scan_bidir`` (#8): SS2D's four directions from two unflipped
  sequences, the last two scanned backward;
- ``selective_scan_spatial`` (#9): one direction over [B, R, T, D], the
  NHWC rows in sequence order (position r * T + t).

``reverse=True`` scans from the last position down; y stays in natural
order. Every entry returns fp32 y unless told otherwise. In the bf16
expert mode:

- ``selective_scan_chain_proj`` on a bf16 xc returns bf16 y: its bf16
  kernel (counted as ``selective_scan.bf16``) and plain version round
  where the JAX kernel's bf16 run does (u = silu(xc) rounded to bf16, one
  product with the composed projection weight rounded to bf16 once,
  dt/B/C, the softplus and the state in fp32, y rounded to bf16); the
  kernel's operands of each direction's parameters (the composed weight
  in its order, D and the bias in fp32) are built once
  (:func:`chain_proj_operands`);
- ``selective_scan_chain``, ``_spatial`` and ``_bidir`` take a bf16 u
  with dt, B and C in bf16 (#5, #9) or fp32 (#8), as SS2D's chainv5,
  spatial and bidir routes hand them, A, D and the bias of any float
  dtype (cast to fp32, as the JAX wrappers cast them), and return y in
  ``out_dtype`` (chain and spatial; default fp32, bf16 only with bf16
  dt) or fp32 (bidir). Their bf16 kernels count as
  ``<entry>.bf16``; the plain versions upcast the operands, scan in fp32
  and round y to ``out_dtype`` once.

``selective_scan_flat`` and ``_dirs`` (#6, #7, on no path) take fp32 only
and refuse bf16 (:func:`cuda.fp32_only`). A CPU tensor goes to the plain
version (``*_reference``); a CUDA tensor goes to
``csrc/selective_scan.cu`` or the call raises. All entries share one
strided CUDA scan: a persistent grid of blocks, each scanning (sequence,
chunk, 128-channel tile) items out of an asynchronous shared-memory ring,
in two passes around a parallel compose of the chunk carries;
:func:`plan_scan` sizes the chunks so that the items fill the card's
resident blocks once. The bf16 kernels' passes are fed by a producer
warp's bulk copies, and the bf16 chain_proj kernel projects on wgmma. The approximate
per-chain init and the 360 -> 384 channel padding of the TPU kernels are
not carried over: the port is exact for any D and L.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils import weak

from . import cuda

__all__ = ["selective_scan", "selective_scan_chain",
           "selective_scan_chain_reference", "selective_scan_chain_proj",
           "selective_scan_chain_proj_reference", "selective_scan_flat",
           "selective_scan_flat_reference", "selective_scan_dirs",
           "selective_scan_dirs_reference", "selective_scan_bidir",
           "selective_scan_bidir_reference", "selective_scan_spatial",
           "selective_scan_spatial_reference", "ScanPlan", "plan_scan",
           "dbl_width", "composed_weight", "weight_layout",
           "ChainProjOperands", "chain_proj_operands",
           "clear_chain_proj_operands"]

# csrc/selective_scan.cu: channels one block scans (one a thread), and
# scan steps one stage of its shared-memory ring holds
_TILE = 128
_SUB = 16
# csrc/selective_scan.cu's scan_project_wgmma_kernel: columns of one chunk
# (one m64n104k16), and the K step
_PW_COLS = 104
_PW_K = 16


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   D: Optional[torch.Tensor] = None,
                   delta_bias: Optional[torch.Tensor] = None,
                   delta_softplus: bool = True,
                   chunk: int = 128) -> torch.Tensor:
    """Plain scan over [B, L, D] / [B, L, N] (A [D, N], already negative).

    The sequence runs in chunks; inside a chunk the linear recurrence
    h_t = a_t h_{t-1} + b_t is an inclusive scan by recursive doubling,
    and the carry enters through the chunk's cumulative decay. fp32 y."""
    b, l, d = u.shape
    u = u.float()
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()
    if delta_softplus:
        delta = F.softplus(delta)
    A = A.float()
    h = u.new_zeros(b, d, A.shape[-1])
    ys = []
    for s0 in range(0, l, chunk):
        dt = delta[:, s0:s0 + chunk]
        a = torch.exp(dt[..., None] * A)                       # [b, c, d, n]
        bu = (dt * u[:, s0:s0 + chunk])[..., None] * \
            B[:, s0:s0 + chunk, None, :].float()
        s = 1
        while s < a.shape[1]:
            bu = torch.cat([bu[:, :s], a[:, s:] * bu[:, :-s] + bu[:, s:]], 1)
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], 1)
            s *= 2
        hs = a * h[:, None] + bu
        ys.append(torch.einsum("bln,bldn->bld",
                               C[:, s0:s0 + chunk].float(), hs))
        h = hs[:, -1]
    y = torch.cat(ys, 1)
    if D is not None:
        y = y + u * D.float()
    return y


def _seq_scan(u, delta, A, B, C, D, delta_bias, reverse: bool
              ) -> torch.Tensor:
    """Plain scan over [B, L, *], backward when `reverse` (flip, scan,
    flip back)."""
    if not reverse:
        return selective_scan(u, delta, A, B, C, D, delta_bias=delta_bias)
    u, delta, B, C = (x.flip(1) for x in (u, delta, B, C))
    return selective_scan(u, delta, A, B, C, D,
                          delta_bias=delta_bias).flip(1)


def _to_seq(x: torch.Tensor) -> torch.Tensor:
    """[B, T, R, F] -> [B, R*T, F] in sequence order."""
    b, t, r, f = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, r * t, f)


def selective_scan_chain_reference(u, delta, A, B, C, D, delta_bias,
                                   reverse: bool = False,
                                   out_dtype: Optional[torch.dtype] = None
                                   ) -> torch.Tensor:
    """Plain version of :func:`selective_scan_chain`: the scan in fp32 on
    the upcast operands, y rounded to `out_dtype` (default fp32) once."""
    b, t, r, d = u.shape
    y = _seq_scan(_to_seq(u), _to_seq(delta), A, _to_seq(B), _to_seq(C), D,
                  delta_bias, reverse)
    y = y.reshape(b, r, t, d).permute(0, 2, 1, 3)
    return y.to(out_dtype or torch.float32).contiguous()


def composed_weight(x_proj_w: torch.Tensor, dt_proj_w: torch.Tensor,
                    n: int) -> torch.Tensor:
    """The bf16 projection weight [D + 2N, D] of the chain_proj contract,
    as the JAX kernel composes its ``wf``: the dt rows dt_proj_w @
    x_proj_w[:dt_rank] composed in fp32, then x_proj_w's B and C rows, all
    rounded to bf16 once."""
    dtr = x_proj_w.shape[0] - 2 * n
    w = torch.cat([dt_proj_w.float() @ x_proj_w[:dtr].float(),
                   x_proj_w[dtr:].float()])
    return w.to(torch.bfloat16).contiguous()


def weight_layout(wt: torch.Tensor) -> torch.Tensor:
    """The composed weight [D + 2N, D] in the order the bf16 projection
    kernel's wgmma reads it from shared memory and bulk-copies it a slice
    at a time: [chunks, k16, 13, 2, 8, 8], chunk c holding columns (rows of
    wt) 104 c .. 104 c + 103 in 13 groups of 8, k16 the 16-wide steps of K
    (D padded to 16 with zeros), each group's two 8-wide halves of the step
    8 x 8 values (8 rows of 16 bytes, a core matrix) apart."""
    k, d = wt.shape
    kp = -(-d // _PW_K) * _PW_K
    nch = -(-k // _PW_COLS)
    w = wt.new_zeros(nch * _PW_COLS, kp)
    w[:k, :d] = wt
    return w.view(nch, _PW_COLS // 8, 8, kp // _PW_K, 2, 8).permute(
        0, 3, 1, 4, 2, 5).contiguous()


class ChainProjOperands(NamedTuple):
    """What the bf16 chain_proj kernel takes of one direction's parameters,
    built once by :func:`chain_proj_operands`: the composed weight
    (:func:`composed_weight`) in the kernel's order (:func:`weight_layout`),
    D and the dt bias in fp32."""
    wl: torch.Tensor
    D: torch.Tensor
    bias: torch.Tensor


# the bf16 chain_proj operands: a table for each x_proj weight (the tensor
# a direction's view is cut from), dropped when that tensor dies
_OPERANDS = weak.WeakIdKeyDictionary()


def _root(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


def chain_proj_operands(x_proj_w: torch.Tensor, dt_proj_w: torch.Tensor,
                        D: torch.Tensor, delta_bias: torch.Tensor,
                        n: int) -> ChainProjOperands:
    """The bf16 chain_proj operands of these parameters, built on first use
    and reused while the parameters stay as they were.

    The entries of one x_proj weight live in a table keyed by that tensor
    (the one its direction views are cut from) and go with it. An entry is
    found by the views' offsets, shapes and strides, and taken only if
    each tensor's address, dtype, device and version counter are as when
    it was built: an in-place update (``load_state_dict`` copies in place)
    bumps a counter, a dtype cast or ``.data`` swap moves the address. The
    entry holds the four tensors' storages, so no other tensor can take
    their memory while it lives. A write that bypasses the version counter
    (through ``.data``, or another tensor made on the same memory) is not
    seen: call :func:`clear_chain_proj_operands` after one."""
    src = (x_proj_w, dt_proj_w, D, delta_bias)
    table = _OPERANDS.get(_root(x_proj_w))
    if table is None:
        table = _OPERANDS[_root(x_proj_w)] = {}
    key = tuple((t.storage_offset(), tuple(t.shape), t.stride())
                for t in src) + (n,)
    state = tuple((t.data_ptr(), t.dtype, t.device, t._version) for t in src)
    hit = table.get(key)
    if hit is not None and hit[1] == state:
        return hit[2]
    xw, dw, dv, bv = (t.detach() for t in src)  # no graph to the sources
    ops = ChainProjOperands(weight_layout(composed_weight(xw, dw, n)),
                            dv.float().contiguous(), bv.float().contiguous())
    table[key] = (tuple(t.untyped_storage() for t in src), state, ops)
    return ops


def clear_chain_proj_operands() -> None:
    """Drop every cached chain_proj operand: the next call of each
    direction builds its own anew. Needed only after a write that bypasses
    the parameters' version counters (``p.data.copy_(...)``)."""
    _OPERANDS.clear()


def _chain_proj_bf16_reference(xc, x_proj_w, dt_proj_w, A, D, delta_bias,
                               reverse: bool) -> torch.Tensor:
    """bf16 xc: u = silu(xc) in fp32 rounded to bf16, one product with the
    composed weight (fp32 sums of bf16 values), the scan in fp32, y
    rounded to bf16."""
    n, d = A.shape[-1], xc.shape[-1]
    u = F.silu(xc.float()).to(torch.bfloat16).float()
    proj = u @ composed_weight(x_proj_w, dt_proj_w, n).float().t()
    return selective_scan_chain_reference(
        u, proj[..., :d], A, proj[..., d:d + n], proj[..., d + n:],
        D.float(), delta_bias.float(), reverse, torch.bfloat16)


def selective_scan_chain_proj_reference(xc, x_proj_w, dt_proj_w, A, D,
                                        delta_bias, reverse: bool = False
                                        ) -> torch.Tensor:
    """Plain version of :func:`selective_scan_chain_proj`: silu, the x_proj
    and dt_proj einsums (as SS2D's XLA route runs them), then the scan; for
    a bf16 xc, :func:`_chain_proj_bf16_reference`."""
    if xc.dtype == torch.bfloat16:
        return _chain_proj_bf16_reference(xc, x_proj_w, dt_proj_w, A, D,
                                          delta_bias, reverse)
    n = A.shape[-1]
    dtr = x_proj_w.shape[0] - 2 * n
    u = F.silu(xc)
    dbl = torch.einsum("btrd,kd->btrk", u, x_proj_w)
    dt = torch.einsum("btrk,dk->btrd", dbl[..., :dtr], dt_proj_w)
    return selective_scan_chain_reference(
        u, dt, A, dbl[..., dtr:dtr + n], dbl[..., dtr + n:], D, delta_bias,
        reverse)


def selective_scan_flat_reference(u, delta, A, B, C, D, delta_bias
                                  ) -> torch.Tensor:
    """Plain version of :func:`selective_scan_flat`."""
    return selective_scan(u, delta, A, B, C, D, delta_bias=delta_bias)


def selective_scan_dirs_reference(u, delta, A, B, C, D, delta_bias
                                  ) -> torch.Tensor:
    """Plain version of :func:`selective_scan_dirs`."""
    return torch.stack([
        selective_scan(u[k], delta[k], A[k], B[k], C[k], D[k],
                       delta_bias=delta_bias[k]) for k in range(u.shape[0])])


def selective_scan_bidir_reference(u, delta, A, B, C, D, delta_bias):
    """Plain version of :func:`selective_scan_bidir`."""
    ys = [_seq_scan(u[k % 2], delta[k], A[k], B[k], C[k], D[k],
                    delta_bias[k], k >= 2) for k in range(4)]
    return torch.stack(ys[:2]), torch.stack(ys[2:])


def selective_scan_spatial_reference(u, delta, A, B, C, D, delta_bias,
                                     reverse: bool = False,
                                     out_dtype: Optional[torch.dtype] = None
                                     ) -> torch.Tensor:
    """Plain version of :func:`selective_scan_spatial`: the scan in fp32
    on the upcast operands, y rounded to `out_dtype` (default fp32)."""
    b, r, t, d = u.shape

    def seq(x):
        return x.reshape(b, r * t, x.shape[-1])
    y = _seq_scan(seq(u), seq(delta), A, seq(B), seq(C), D, delta_bias,
                  reverse)
    return y.reshape(b, r, t, d).to(out_dtype or torch.float32)


class ScanPlan(NamedTuple):
    """How one launch of the CUDA scan cuts its work: sequences of
    `chunk`-step chunks (`nchunk` a sequence, the last one ragged) and
    `tiles` 128-channel tiles make `items` = sequences x nchunk x tiles
    (sequence, chunk, tile) items, walked by `grid` persistent blocks."""
    chunk: int
    nchunk: int
    tiles: int
    items: int
    grid: int


@functools.lru_cache(maxsize=256)
def plan_scan(length: int, d: int, seqs: int, slots: int) -> ScanPlan:
    """Plan a launch over `seqs` sequences of `length` positions and `d`
    channels on a card that holds `slots` blocks of the scan at once.

    The chunk is as long as lets the items fill the slots once (one wave:
    ``slots // (tiles * seqs)`` chunks a sequence), a whole number of ring
    stages, and at least one stage. Where the sequences and tiles alone
    outnumber the slots, a chunk is the whole sequence and each block
    walks several items."""
    tiles = -(-d // _TILE)
    per_seq = max(1, slots // (tiles * seqs))
    chunk = -(-length // per_seq)
    chunk = -(-chunk // _SUB) * _SUB
    nchunk = -(-length // chunk)
    items = seqs * nchunk * tiles
    return ScanPlan(chunk, nchunk, tiles, items, min(items, slots))


def dbl_width(n: int, dt_rank: int) -> int:
    """Floats of one x_dbl row on the projection contract: dt_low, B and
    C, each padded to a multiple of 4 so the scan copies 16 bytes at a
    time."""
    return -(-dt_rank // 4) * 4 + 2 * (-(-n // 4) * 4)


_slots: dict = {}

# the explicit contract's codes with a bf16 u (csrc/selective_scan.cu:
# mix_of), by the dtypes of (dt, B and C; y): #5's, #9's and #8's
_BF16_CONTRACTS = {(torch.bfloat16, torch.bfloat16): 3,
                   (torch.bfloat16, torch.float32): 4,
                   (torch.float32, torch.float32): 5}


def _plan(x: torch.Tensor, proj: int, length: int, d: int, n: int,
          dt_rank: int, seqs: int) -> ScanPlan:
    """:func:`plan_scan` with the card's resident blocks of the scan's
    passes (SMs x blocks an SM holds), asked of the library at first use
    for each contract (`proj`: 0 explicit, 1 projection, 2 the bf16
    projection contract, 3-5 the explicit bf16 contracts of
    ``_BF16_CONTRACTS``), N and dt_rank."""
    key = (x.device.index, proj, n, dt_rank)
    if key not in _slots:
        got = cuda.library().ff_selective_scan_slots(int(proj), n, dt_rank)
        if got <= 0:
            raise RuntimeError(f"selective scan: occupancy query failed "
                               f"(CUDA error {-got})")
        _slots[key] = got
    return plan_scan(length, d, seqs, _slots[key])


def _scratch(x: torch.Tensor, seqs: int, plan: ScanPlan, d: int, n: int):
    """Pass 1's outputs, which the compose turns into each chunk's initial
    state: the sum of delta over each chunk [seqs, nchunk, D] and the
    chunk end states [seqs, nchunk, D, N] (about 5 MB a direction at the
    336x512 bucket's one-wave plan), two views of one allocation."""
    cells = seqs * plan.nchunk * d
    buf = torch.empty(cells * (n + 1), device=x.device, dtype=torch.float32)
    return (buf[:cells].view(seqs, plan.nchunk, d),
            buf[cells:].view(seqs, plan.nchunk, d, n))


def _require_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def _launch(name: str, u, delta, A, B, C, D, delta_bias, u_lead: tuple,
            lead: tuple, group: tuple, t: int, r: int, st: int, sr: int,
            rev_mask: int, out_dtype: Optional[torch.dtype] = None
            ) -> torch.Tensor:
    """Check the operands of an explicit-contract entry and run the strided
    scan kernel over them. delta, B, C and y are [*lead, D or N], u is
    [*u_lead, D]: sequences of L = t * r positions, position i * t + j
    (j < t) at row j * st + i * sr of its sequence. `group` is () for one
    parameter group (A [D, N], D and delta_bias [D]) or (G,), when
    lead[0] = G indexes the groups (A [G, D, N], D and delta_bias [G, D])
    and u_lead[0] u's groups (group g reads u group g % u_lead[0]). Group
    g scans backward when bit g of `rev_mask` is set. An fp32 u takes
    fp32 operands and gives fp32 y (``ff_selective_scan``); a bf16 u takes
    dt, B and C of one dtype and y in `out_dtype` at the mixes of
    ``_BF16_CONTRACTS`` (``ff_selective_scan_bf16``, counted as
    ``<name>.bf16``), A, D and delta_bias cast to fp32."""
    out_dtype = out_dtype or torch.float32
    d, n = u.shape[-1], A.shape[-1]
    dev = u.device
    contract = 0
    if u.dtype == torch.bfloat16:
        contract = _BF16_CONTRACTS.get((delta.dtype, out_dtype))
        if contract is None:
            raise ValueError(
                f"{name}: a bfloat16 u takes dt, B and C in bfloat16 with y "
                f"in bfloat16 or float32, or all in float32; got dt "
                f"{delta.dtype} and out_dtype {out_dtype}")
        A, D, delta_bias = (v.float().contiguous() for v in (A, D, delta_bias))
    elif out_dtype != torch.float32:
        raise ValueError(f"{name}: out_dtype {out_dtype} needs a bfloat16 u")
    cuda.require(u, "u", u_lead + (d,), dev,
                 torch.bfloat16 if contract else torch.float32)
    cuda.require(delta, "delta", lead + (d,), dev,
                 delta.dtype if contract else torch.float32)
    cuda.require(A, "A", group + (d, n), dev)
    cuda.require(B, "B", lead + (n,), dev, delta.dtype)
    cuda.require(C, "C", lead + (n,), dev, delta.dtype)
    cuda.require(D, "D", group + (d,), dev)
    cuda.require(delta_bias, "delta_bias", group + (d,), dev)
    groups, u_groups = (group[0], u_lead[0]) if group else (1, 1)
    seqs = delta.numel() // (t * r * d)
    y = torch.empty(lead + (d,), device=dev, dtype=out_dtype)
    plan = _plan(u, contract, t * r, d, n, 0, seqs)
    sdt, Hc = _scratch(u, seqs, plan, d, n)
    ptrs = (cuda.ptr(x) for x in (u, delta, A, B, C, D, delta_bias, y, sdt,
                                  Hc))
    dims = (groups, u_groups, seqs // groups, t, r, st, sr, d, n, rev_mask)
    if contract:
        err = cuda.library().ff_selective_scan_bf16(
            *ptrs, *dims, contract, plan.chunk, plan.grid, cuda.stream(u))
        name += ".bf16"
    else:
        err = cuda.library().ff_selective_scan(
            *ptrs, *dims, plan.chunk, plan.grid, cuda.stream(u))
    cuda.check(err, name)
    cuda.launch_counts[name] += 1
    return y


def selective_scan_chain(u: torch.Tensor, delta: torch.Tensor,
                         A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                         D: torch.Tensor, delta_bias: torch.Tensor,
                         reverse: bool = False,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Chain contract (TPU kernel #5): u, delta [B, T, R, D]; B, C
    [B, T, R, N]; A [D, N]; D, delta_bias [D]. Returns y [B, T, R, D] in
    `out_dtype` (default fp32; bf16 for a bf16 u with bf16 dt, B and C,
    as SS2D's chainv5 route runs it in bf16)."""
    if u.device.type == "cpu":
        return selective_scan_chain_reference(u, delta, A, B, C, D,
                                              delta_bias, reverse, out_dtype)
    _require_cuda(u, "selective_scan_chain")
    b, t, r, _ = u.shape
    return _launch("selective_scan_chain", u, delta, A, B, C, D, delta_bias,
                   (b, t, r), (b, t, r), (), t, r, r, 1, int(reverse),
                   out_dtype)


def selective_scan_flat(u: torch.Tensor, delta: torch.Tensor,
                        A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                        D: torch.Tensor, delta_bias: torch.Tensor
                        ) -> torch.Tensor:
    """Flat contract (TPU kernel #6): u, delta [B, L, D]; B, C [B, L, N];
    A [D, N]; D, delta_bias [D]. Returns fp32 y [B, L, D]."""
    if u.device.type == "cpu":
        return selective_scan_flat_reference(u, delta, A, B, C, D, delta_bias)
    _require_cuda(u, "selective_scan_flat")
    cuda.fp32_only("selective_scan_flat", u, delta)
    b, l, _ = u.shape
    return _launch("selective_scan_flat", u, delta, A, B, C, D, delta_bias,
                   (b, l), (b, l), (), l, 1, 1, l, 0)


def selective_scan_dirs(u: torch.Tensor, delta: torch.Tensor,
                        A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                        D: torch.Tensor, delta_bias: torch.Tensor
                        ) -> torch.Tensor:
    """K-direction contract (TPU kernel #7): u, delta [K, B, L, D]; B, C
    [K, B, L, N]; A [K, D, N]; D, delta_bias [K, D]; every direction
    forward. Returns fp32 y [K, B, L, D]."""
    if u.device.type == "cpu":
        return selective_scan_dirs_reference(u, delta, A, B, C, D, delta_bias)
    _require_cuda(u, "selective_scan_dirs")
    cuda.fp32_only("selective_scan_dirs", u, delta)
    k, b, l, _ = u.shape
    return _launch("selective_scan_dirs", u, delta, A, B, C, D, delta_bias,
                   (k, b, l), (k, b, l), (k,), l, 1, 1, l, 0)


def selective_scan_bidir(u: torch.Tensor, delta: torch.Tensor,
                         A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                         D: torch.Tensor, delta_bias: torch.Tensor):
    """SS2D's four directions from unflipped sequences (TPU kernel #8).

    u [2, B, L, D] (row-major, column-major); delta [4, B, L, D] and B, C
    [4, B, L, N] for the directions (row-fwd, col-fwd, row-bwd, col-bwd),
    all computed from the unflipped sequences; A [4, D, N]; D, delta_bias
    [4, D]. Direction k reads u[k % 2]; directions 2 and 3 run the suffix
    recurrence. Returns (y_fwd, y_bwd), each fp32 [2, B, L, D] in natural
    order, from one launch. A bf16 u takes fp32 or bf16 delta, B and C
    (fp32 on SS2D's bidir route in bf16)."""
    if u.device.type == "cpu":
        return selective_scan_bidir_reference(u, delta, A, B, C, D,
                                              delta_bias)
    _require_cuda(u, "selective_scan_bidir")
    _, b, l, _ = u.shape
    y = _launch("selective_scan_bidir", u, delta, A, B, C, D, delta_bias,
                (2, b, l), (4, b, l), (4,), l, 1, 1, l, 0b1100)
    return y[:2], y[2:]


def selective_scan_spatial(u: torch.Tensor, delta: torch.Tensor,
                           A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                           D: torch.Tensor, delta_bias: torch.Tensor,
                           reverse: bool = False,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """One direction over a spatial layout (TPU kernel #9): u, delta
    [B, R, T, D], R rows of T positions in sequence order (row-major: the
    NHWC tensor itself; column-major: its [B, W, H, D] transpose); B, C
    [B, R, T, N]; A [D, N]; D, delta_bias [D]. ``reverse=True`` runs the
    suffix recurrence over the same layout. Returns y [B, R, T, D] in
    `out_dtype` (default fp32, which SS2D's spatial route keeps in bf16
    too)."""
    if u.device.type == "cpu":
        return selective_scan_spatial_reference(u, delta, A, B, C, D,
                                                delta_bias, reverse,
                                                out_dtype)
    _require_cuda(u, "selective_scan_spatial")
    b, r, t, _ = u.shape
    return _launch("selective_scan_spatial", u, delta, A, B, C, D,
                   delta_bias, (b, r, t), (b, r, t), (), t, r, 1, t,
                   int(reverse), out_dtype)


def selective_scan_chain_proj(xc: torch.Tensor, x_proj_w: torch.Tensor,
                              dt_proj_w: torch.Tensor, A: torch.Tensor,
                              D: torch.Tensor, delta_bias: torch.Tensor,
                              reverse: bool = False) -> torch.Tensor:
    """chain_fused / chain_proj contract: xc [B, T, R, D] is the PRE-silu
    depthwise-conv output; x_proj_w [dt_rank + 2N, D]; dt_proj_w
    [D, dt_rank]; A [D, N]; D, delta_bias [D]. u = silu(xc), dt/B/C are
    projected from u inside. Returns fp32 y [B, T, R, D], or bf16 y for a
    bf16 xc (the bf16 kernel; A fp32, the weights, D and delta_bias of any
    float dtype)."""
    if xc.device.type == "cpu":
        return selective_scan_chain_proj_reference(
            xc, x_proj_w, dt_proj_w, A, D, delta_bias, reverse)
    _require_cuda(xc, "selective_scan_chain_proj")
    if xc.dtype == torch.bfloat16:
        return _chain_proj_bf16(xc, x_proj_w, dt_proj_w, A, D, delta_bias,
                                reverse)
    b, t, r, d = xc.shape
    n = A.shape[-1]
    k = x_proj_w.shape[0]
    dtr = k - 2 * n
    dev = xc.device
    cuda.require(xc, "xc", (b, t, r, d), dev)
    cuda.require(x_proj_w, "x_proj_w", (k, d), dev)
    cuda.require(dt_proj_w, "dt_proj_w", (d, dtr), dev)
    cuda.require(A, "A", (d, n), dev)
    cuda.require(D, "D", (d,), dev)
    cuda.require(delta_bias, "delta_bias", (d,), dev)
    if n > 16 or not 0 < dtr <= 16:
        raise ValueError(f"selective_scan_chain_proj: N={n} and "
                         f"dt_rank={dtr} must be <= 16")
    x_dbl = torch.empty(b * t * r, dbl_width(n, dtr), device=dev,
                        dtype=torch.float32)
    y = torch.empty_like(xc)
    plan = _plan(xc, True, t * r, d, n, dtr, b)
    sdt, Hc = _scratch(xc, b, plan, d, n)
    err = cuda.library().ff_selective_scan_proj(
        *(cuda.ptr(x) for x in (xc, x_proj_w, dt_proj_w, A, D, delta_bias,
                                x_dbl, y, sdt, Hc)),
        b, t, r, d, n, dtr, int(reverse), plan.chunk, plan.grid,
        cuda.stream(xc))
    cuda.check(err, "selective_scan_chain_proj")
    cuda.launch_counts["selective_scan"] += 1
    return y


def _chain_proj_bf16(xc, x_proj_w, dt_proj_w, A, D, delta_bias,
                     reverse: bool) -> torch.Tensor:
    """The bf16 kernel of :func:`selective_scan_chain_proj`: the projection
    with :func:`composed_weight` on the bf16 tensor cores (wgmma) into
    scratch: u = silu(xc) rounded to bf16 [rows, D], fp32 delta =
    softplus(dt + bias) [rows, D] and B, C [rows, N]; then the bf16 passes
    over u, y written as bf16. The weight in the kernel's order, D and delta_bias in
    fp32 come from :func:`chain_proj_operands`, built once: a call launches
    the projection and the passes only."""
    b, t, r, d = xc.shape
    n = A.shape[-1]
    dev = xc.device
    cuda.require(xc, "xc", (b, t, r, d), dev, torch.bfloat16)
    cuda.require(A, "A", (d, n), dev)
    if n > 16 or x_proj_w.shape != (x_proj_w.shape[0], d) or \
            dt_proj_w.shape != (d, x_proj_w.shape[0] - 2 * n):
        raise ValueError(f"selective_scan_chain_proj (bf16): N={n} must be "
                         f"<= 16, x_proj_w {tuple(x_proj_w.shape)} and "
                         f"dt_proj_w {tuple(dt_proj_w.shape)} of D={d}")
    ops = chain_proj_operands(x_proj_w, dt_proj_w, D, delta_bias, n)
    cuda.require(ops.wl, "weight", (-(-(d + 2 * n) // _PW_COLS),
                                    -(-d // _PW_K), _PW_COLS // 8, 2, 8, 8),
                 dev, torch.bfloat16)
    cuda.require(ops.D, "D", (d,), dev)
    cuda.require(ops.bias, "delta_bias", (d,), dev)
    rows = b * t * r
    u = torch.empty(rows, d, device=dev, dtype=torch.bfloat16)
    delta = torch.empty(rows, d, device=dev, dtype=torch.float32)
    Bm = torch.empty(rows, n, device=dev, dtype=torch.float32)
    Cm = torch.empty(rows, n, device=dev, dtype=torch.float32)
    y = torch.empty_like(xc)
    plan = _plan(xc, 2, t * r, d, n, 0, b)
    sdt, Hc = _scratch(xc, b, plan, d, n)
    err = cuda.library().ff_selective_scan_proj_bf16(
        *(cuda.ptr(x) for x in (xc, ops.wl, A, ops.D, ops.bias, u, delta,
                                Bm, Cm, y, sdt, Hc)),
        b, t, r, d, n, int(reverse), plan.chunk, plan.grid, cuda.stream(xc))
    cuda.check(err, "selective_scan_chain_proj (bf16)")
    cuda.launch_counts["selective_scan.bf16"] += 1
    return y
