"""Selective scan (Mamba S6 recurrence): the CUDA kernel and its plain version.

Counterpart of ``freqfusion_tpu/ops/selective_scan.py``. Recurrence per
batch b, channel d, state n, over sequence position t:

    delta = softplus(dt + dt_bias)
    h_t   = exp(delta_t * A) * h_{t-1} + delta_t * B_t * u_t      (fp32)
    y_t   = sum_n C_t[n] * h_t[n] + D * u_t

``selective_scan`` is the plain PyTorch version over [B, L, D]. The chain
functions take the JAX chain kernels' layout, [B, T, R, D], whose scanned
sequence is chain 0, then chain 1, ... (position r * T + t), and scan it
forward or, with ``reverse=True``, from the last position down; y stays
in natural order. ``selective_scan_chain_proj`` is the
chain_fused/chain_proj contract (pre-silu xc, projections inside),
``selective_scan_chain`` the chain contract (u, dt, B, C given). A CPU
tensor goes to the plain version; a CUDA tensor goes to
``csrc/selective_scan.cu`` or the call raises. The approximate per-chain
init and the 360 -> 384 channel padding of the TPU kernels are not
carried over: the port is exact for any D and L.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda

__all__ = ["selective_scan", "selective_scan_chain",
           "selective_scan_chain_reference", "selective_scan_chain_proj",
           "selective_scan_chain_proj_reference"]

_CHUNK = 256  # scan steps per CUDA block (csrc/selective_scan.cu)


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


def _to_seq(x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """[B, T, R, F] -> [B, R*T, F] in scan order."""
    b, t, r, f = x.shape
    s = x.permute(0, 2, 1, 3).reshape(b, r * t, f)
    return s.flip(1) if reverse else s


def _from_seq(y: torch.Tensor, t: int, r: int, reverse: bool) -> torch.Tensor:
    if reverse:
        y = y.flip(1)
    b, _, f = y.shape
    return y.reshape(b, r, t, f).permute(0, 2, 1, 3).contiguous()


def selective_scan_chain_reference(u, delta, A, B, C, D, delta_bias,
                                   reverse: bool = False) -> torch.Tensor:
    """Plain version of :func:`selective_scan_chain`."""
    _, t, r, _ = u.shape
    y = selective_scan(_to_seq(u, reverse), _to_seq(delta, reverse), A,
                       _to_seq(B, reverse), _to_seq(C, reverse), D,
                       delta_bias=delta_bias)
    return _from_seq(y, t, r, reverse)


def selective_scan_chain_proj_reference(xc, x_proj_w, dt_proj_w, A, D,
                                        delta_bias, reverse: bool = False
                                        ) -> torch.Tensor:
    """Plain version of :func:`selective_scan_chain_proj`: silu, the x_proj
    and dt_proj einsums (as SS2D's XLA route runs them), then the scan."""
    n = A.shape[-1]
    dtr = x_proj_w.shape[0] - 2 * n
    u = F.silu(xc)
    dbl = torch.einsum("btrd,kd->btrk", u, x_proj_w)
    dt = torch.einsum("btrk,dk->btrd", dbl[..., :dtr], dt_proj_w)
    return selective_scan_chain_reference(
        u, dt, A, dbl[..., dtr:dtr + n], dbl[..., dtr + n:], D, delta_bias,
        reverse)


def _scratch(x: torch.Tensor, d: int, n: int):
    b, t, r, _ = x.shape
    nchunk = -(-(t * r) // _CHUNK)
    return (torch.empty(b, nchunk, d, n, device=x.device, dtype=torch.float32),
            torch.empty(b, nchunk, d, n, device=x.device, dtype=torch.float32))


def _require_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def selective_scan_chain(u: torch.Tensor, delta: torch.Tensor,
                         A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                         D: torch.Tensor, delta_bias: torch.Tensor,
                         reverse: bool = False) -> torch.Tensor:
    """Chain contract: u, delta [B, T, R, D]; B, C [B, T, R, N]; A [D, N];
    D, delta_bias [D]. Returns fp32 y [B, T, R, D]."""
    if u.device.type == "cpu":
        return selective_scan_chain_reference(u, delta, A, B, C, D,
                                              delta_bias, reverse)
    _require_cuda(u, "selective_scan_chain")
    b, t, r, d = u.shape
    n = A.shape[-1]
    dev = u.device
    cuda.require(u, "u", (b, t, r, d), dev)
    cuda.require(delta, "delta", (b, t, r, d), dev)
    cuda.require(A, "A", (d, n), dev)
    cuda.require(B, "B", (b, t, r, n), dev)
    cuda.require(C, "C", (b, t, r, n), dev)
    cuda.require(D, "D", (d,), dev)
    cuda.require(delta_bias, "delta_bias", (d,), dev)
    y = torch.empty_like(u)
    P, Hc = _scratch(u, d, n)
    err = cuda.library().ff_selective_scan(
        *(cuda.ptr(x) for x in (u, delta, A, B, C, D, delta_bias, y, P, Hc)),
        b, t, r, d, n, int(reverse), _CHUNK, cuda.stream(u))
    cuda.check(err, "selective_scan_chain")
    cuda.launch_counts["selective_scan"] += 1
    return y


def selective_scan_chain_proj(xc: torch.Tensor, x_proj_w: torch.Tensor,
                              dt_proj_w: torch.Tensor, A: torch.Tensor,
                              D: torch.Tensor, delta_bias: torch.Tensor,
                              reverse: bool = False) -> torch.Tensor:
    """chain_fused / chain_proj contract: xc [B, T, R, D] is the PRE-silu
    depthwise-conv output; x_proj_w [dt_rank + 2N, D]; dt_proj_w
    [D, dt_rank]; A [D, N]; D, delta_bias [D]. u = silu(xc), dt/B/C are
    projected from u inside. Returns fp32 y [B, T, R, D]."""
    if xc.device.type == "cpu":
        return selective_scan_chain_proj_reference(
            xc, x_proj_w, dt_proj_w, A, D, delta_bias, reverse)
    _require_cuda(xc, "selective_scan_chain_proj")
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
    x_dbl = torch.empty(b * t * r, k, device=dev, dtype=torch.float32)
    y = torch.empty_like(xc)
    P, Hc = _scratch(xc, d, n)
    err = cuda.library().ff_selective_scan_proj(
        *(cuda.ptr(x) for x in (xc, x_proj_w, dt_proj_w, A, D, delta_bias,
                                x_dbl, y, P, Hc)),
        b, t, r, d, n, dtr, int(reverse), _CHUNK, cuda.stream(xc))
    cuda.check(err, "selective_scan_chain_proj")
    cuda.launch_counts["selective_scan"] += 1
    return y
