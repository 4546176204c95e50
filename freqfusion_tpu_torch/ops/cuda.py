"""Build, load and call the port's hand-written CUDA kernels.

All sources under ``freqfusion_tpu_torch/csrc/*.cu`` are compiled with
``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started together,
and linked into one shared library with a plain C interface, loaded
through ctypes (no PyTorch headers, so a build takes seconds); the
``*.cuh`` headers hold device code that two sources share. The library is
built at first use into ``build/freqfusion_tpu_torch/<hash>/``
beside the package (``FREQFUSION_TORCH_BUILD_DIR`` overrides the root),
keyed by a hash of the sources, headers and flags, so a checkout builds
everything it needs by itself. A missing ``nvcc`` or a failed build
raises with the compiler's output.

``launch_counts`` counts, per kernel wrapper, the calls that launched the
kernel, so a run can show that the main path went through it. The scan's
entries count apart: ``selective_scan`` (chain_proj, TPU kernels #3/#4),
``selective_scan_chain`` (#5), ``selective_scan_flat``, ``_dirs``,
``_bidir`` and ``_spatial`` (#6-#9); ``window_attention_nhwc`` (#1) and
``window_attention`` (#10, window-major) count apart too. A kernel with a
bf16 version counts that version under its name with ``.bf16`` added
(``window_attention_nhwc.bf16``, ``grl_mixed_attention_nhwc.bf16``,
``selective_scan.bf16``, ``selective_scan_chain.bf16``,
``selective_scan_spatial.bf16``, ``selective_scan_bidir.bf16``,
``fused_mlp_block.bf16``, ``cab_fused.bf16``,
``nafblock_fused.bf16``, ``dwconv3x3.bf16``, ``lka_block_fused.bf16``,
``hier_stage3_fused.bf16``, ``edge_refine_fused.bf16``,
``edge_fuse_fused.bf16``, ``window_attention_qkv_nhwc.bf16``,
``grl_mixed_attention_qkv_nhwc.bf16``, ``token_attention.bf16``), so a run
shows which of the two ran. A kernel takes the dtypes :func:`require` is
given; handed a bf16 tensor, an fp32-only kernel raises naming itself
(:func:`fp32_only`), and nothing is cast around it. The fp32-only kernels
are #6, #7 and #10 (the flat and K-direction scans and the window-major
attention), which lie on no path.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

__all__ = ["library", "build", "check", "ptr", "stream", "require",
           "fp32_only", "nhwc_layout", "require_layout", "empty_nhwc",
           "launch_counts", "reset_launch_counts"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

launch_counts: "collections.Counter[str]" = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "ff_window_attention_nhwc": [_P] * 6 + [_I] * 6 + [_F, _I, _I, _P],
    "ff_window_attention_nhwc_bf16": [_P] * 6 + [_I] * 6 + [_F, _P],
    "ff_window_attention_bf16_smem": [_I, _I],
    "ff_window_attention_bf16_occupancy": [_I, _I],
    "ff_window_attention": [_P] * 6 + [_I] * 5 + [_F, _I, _I, _P],
    "ff_grl_mixed_attention_nhwc": [_P] * 16 + [_I] * 8 + [_P],
    "ff_grl_mixed_attention_nhwc_bf16": [_P] * 16 + [_I] * 8 + [_P],
    "ff_grl_attention_bf16_plan": [_I] * 4 + [_P],
    "ff_selective_scan_slots": [_I] * 3,
    "ff_selective_scan_proj": [_P] * 10 + [_I] * 9 + [_P],
    "ff_selective_scan_proj_bf16": [_P] * 12 + [_I] * 8 + [_P],
    "ff_selective_scan": [_P] * 10 + [_I] * 12 + [_P],
    "ff_selective_scan_bf16": [_P] * 10 + [_I] * 13 + [_P],
    "ff_fused_mlp_scratch_floats": [_I] * 3,
    "ff_fused_mlp": [_P] * 9 + [_L] + [_I] * 4 + [_F, _F, _P],
    "ff_fused_mlp_bf16_scratch_bytes": [_L, _I, _I],
    "ff_fused_mlp_bf16_smem": [_I] * 3,
    "ff_fused_mlp_bf16": [_P] * 9 + [_L, _L] + [_I] * 5 + [_F, _F, _P],
    "ff_cab_tiles": [_I] * 3,
    "ff_cab_scratch_floats": [_I] * 2,
    "ff_cab_pool": [_P] * 11 + [_L] + [_I] * 5 + [_F, _P],
    "ff_cab_apply": [_P] * 5 + [_I] * 4 + [_P],
    "ff_cab_bf16_scratch_bytes": [_L, _I, _I],
    "ff_cab_bf16_tiles": [_I] * 2,
    "ff_cab_bf16_smem": [_I] * 3,
    "ff_cab_pool_bf16": [_P] * 10 + [_L] + [_I] * 5 + [_F, _P],
    "ff_cab_apply_bf16": [_P] * 5 + [_I] * 4 + [_P],
    "ff_nafblock_tiles": [_I] * 2,
    "ff_nafblock_scratch_floats": [_I] * 3,
    "ff_nafblock_gate": [_P] * 11 + [_L] + [_I] * 4 + [_F, _P],
    "ff_nafblock_apply": [_P] * 12 + [_L] + [_I] * 4 + [_F, _P],
    "ff_nafblock_bf16_scratch_bytes": [_L, _I],
    "ff_nafblock_bf16_tiles": [_I] * 3,
    "ff_nafblock_gate_bf16": [_P] * 9 + [_L] + [_I] * 4 + [_F, _P],
    "ff_nafblock_apply_bf16": [_P] * 14 + [_L] + [_I] * 4 + [_F, _P],
    "ff_dwconv3x3": [_P] * 4 + [_I] * 4 + [_P],
    "ff_dwconv3x3_bf16": [_P] * 4 + [_I] * 4 + [_P],
    "ff_window_attention_qkv_scratch_floats": [_L, _I, _I],
    "ff_window_attention_qkv_nhwc": [_P] * 11 + [_L] + [_I] * 7
                                    + [_F, _I, _I, _P],
    "ff_window_attention_qkv_bf16_scratch_bytes": [_L, _I, _I],
    "ff_window_attention_qkv_nhwc_bf16": [_P] * 9 + [_L] + [_I] * 7
                                         + [_F, _I, _I, _P],
    "ff_grl_qkv_scratch_floats": [_L, _I, _I],
    "ff_grl_qkv_bf16_scratch_bytes": [_L, _I, _I],
    "ff_grl_mixed_attention_qkv_nhwc_bf16": [_P] * 15 + [_L] + [_I] * 10
                                            + [_P],
    "ff_grl_mixed_attention_qkv_nhwc": [_P] * 15 + [_L] + [_I] * 9 + [_P],
    "ff_token_attention_scratch_floats": [_L] + [_I] * 3,
    "ff_token_attention": [_P, _P, _L, _L, _P, _P, _L, _L] + [_P] * 3
                          + [_L, _L] + [_I] * 3 + [_P],
    "ff_token_attention_bf16_scratch_bytes": [_L, _I, _I],
    "ff_token_attention_bf16": [_P, _P, _L, _L, _P, _P, _L, _L] + [_P] * 3
                               + [_L, _L] + [_I] * 3 + [_F, _P],
    "ff_lka_scratch_floats": [_L, _I, _I],
    "ff_lka_bf16_scratch_floats": [_L, _I, _I],
    "ff_lka_block_bf16": [_P] * 13 + [_P, _I, _I] * 5 + [_P] + [_P, _I, _I]
                         + [_P] * 4 + [_L, _P] + [_I] * 5 + [_P],
    "ff_hier_bf16_plan": [_I, _P],
    "ff_hier_stage3_bf16": [_P, _I] + [_P] * 20 + [_I] * 5 + [_P],
    "ff_edge_bf16_scratch_floats": [_I] * 3,
    "ff_edge_refine_bf16": [_P, _I] + ([_P] + [_I] * 4 + [_P]) * 6
                           + [_P] * 5 + [_L, _P] + [_I] * 5 + [_P],
    "ff_edge_fuse_bf16": [_P] * 4 + [_I] + [_P] * 2
                         + ([_P] + [_I] * 4 + [_P]) * 4 + [_P] * 7
                         + [_L, _P] + [_I] * 4 + [_P],
    "ff_lka_block": [_P] * 13 + [_P, _I, _I] * 5 + [_P] + [_P, _I, _I]
                    + [_P] * 4 + [_L, _P] + [_I] * 5 + [_P],
    "ff_hier_scratch_floats": [_I] * 2,
    "ff_hier_stage3": [_P, _I] + [_P] * 19 + [_L, _P] + [_I] * 5 + [_P],
    "ff_edge_scratch_floats": [_I] * 3,
    "ff_edge_refine": [_P, _I] + ([_P] + [_I] * 4 + [_P]) * 6 + [_P] * 3
                      + [_L, _P] + [_I] * 5 + [_P],
    "ff_edge_fuse": [_P] * 4 + [_I] + [_P] * 2 + ([_P] + [_I] * 4 + [_P]) * 4
                    + [_P] * 4 + [_L, _P] + [_I] * 4 + [_P],
    "ff_layernorm": [_P] * 4 + [_I] * 3 + [_F, _P],
}
# entries that return a count of 64 bits (the rest return an int)
_RETURNS_LONG = ("ff_fused_mlp_scratch_floats", "ff_cab_scratch_floats",
                 "ff_nafblock_scratch_floats",
                 "ff_fused_mlp_bf16_scratch_bytes",
                 "ff_cab_bf16_scratch_bytes",
                 "ff_nafblock_bf16_scratch_bytes",
                 "ff_window_attention_qkv_scratch_floats",
                 "ff_grl_qkv_scratch_floats", "ff_hier_scratch_floats",
                 "ff_lka_scratch_floats", "ff_edge_scratch_floats",
                 "ff_lka_bf16_scratch_floats", "ff_edge_bf16_scratch_floats",
                 "ff_token_attention_scratch_floats",
                 "ff_window_attention_qkv_bf16_scratch_bytes",
                 "ff_grl_qkv_bf16_scratch_bytes",
                 "ff_token_attention_bf16_scratch_bytes")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log = ""


def reset_launch_counts() -> None:
    launch_counts.clear()


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def _build_root() -> Path:
    env = os.environ.get("FREQFUSION_TORCH_BUILD_DIR")
    return Path(env) if env else _PKG.parent / "build" / "freqfusion_tpu_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       f"({home}); the port's CUDA kernels cannot be built")


def build(ptxas_verbose: bool = False) -> Path:
    """Compile the kernels (if not already built) and return the .so path.
    ``ptxas_verbose`` adds ptxas's per-kernel register/spill report to
    ``build_log``."""
    global build_seconds, build_log
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if ptxas_verbose else [])
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())  # -v changes no code
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = _build_root() / h.hexdigest()[:16]
    lib_path = out_dir / "libfreqfusion_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"tmp-{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}-{tag}.o"
        cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{logs[-1]}")
    tmp = out_dir / f"{tag}.so"
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{logs[-1]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _L if name in _RETURNS_LONG else ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry returned a CUDA error (refused launch etc.)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, shape, device,
            dtype: torch.dtype = torch.float32,
            contiguous: bool = True) -> None:
    """Validate a tensor handed to a kernel: of `dtype` (the one the kernel
    takes for it), contiguous (unless the kernel reads it only through a
    layout built from it, ``contiguous=False``), on `device`, of
    `shape`."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fp32_only(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """Refuse a bf16 tensor handed to a kernel that has only an fp32
    version: raise naming `kernel`; nothing is cast around it."""
    for t in tensors:
        if t is not None and t.dtype == torch.bfloat16:
            raise ValueError(f"{kernel}: got a bfloat16 tensor; this "
                             "kernel's bf16 version is not ported yet (it "
                             "takes float32)")


def nhwc_layout(t: torch.Tensor) -> int:
    """The layout of a [B, H, W, C] tensor for the kernels that take two:
    0 when it is contiguous (NHWC), 1 when it is an NCHW-contiguous tensor
    viewed as NHWC (``u.permute(0, 2, 3, 1)``); any other layout raises."""
    if t.is_contiguous():
        return 0
    if t.permute(0, 3, 1, 2).is_contiguous():
        return 1
    raise ValueError(f"tensor of shape {tuple(t.shape)} and strides "
                     f"{t.stride()} is neither NHWC- nor NCHW-contiguous")


def require_layout(t: torch.Tensor, name: str, shape, device,
                   nchw: int, dtype: torch.dtype = torch.float32) -> None:
    """:func:`require` for a [B, H, W, C] tensor in the layout `nchw`
    names (see :func:`nhwc_layout`)."""
    require(t.permute(0, 3, 1, 2) if nchw else t, name,
            (shape[0], shape[3], shape[1], shape[2]) if nchw else shape,
            device, dtype)


def empty_nhwc(b: int, h: int, w: int, c: int, nchw: int, device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """An uninitialised [B, H, W, C] tensor in the layout `nchw` names."""
    if nchw:
        return torch.empty(b, c, h, w, device=device,
                           dtype=dtype).permute(0, 2, 3, 1)
    return torch.empty(b, h, w, c, device=device, dtype=dtype)
