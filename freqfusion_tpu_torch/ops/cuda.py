"""Build, load and call the port's hand-written CUDA kernels.

All sources under ``freqfusion_tpu_torch/csrc/*.cu`` are compiled with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface,
loaded through ctypes (no PyTorch headers, so a build takes seconds). The
library is built at first use into ``build/freqfusion_tpu_torch/<hash>/``
beside the package (``FREQFUSION_TORCH_BUILD_DIR`` overrides the root),
keyed by a hash of the sources and flags, so a checkout builds everything
it needs by itself. A missing ``nvcc`` or a failed build raises with the
compiler's output.

``launch_counts`` counts, per kernel wrapper, the calls that launched the
kernel, so a run can show that the main path went through it.
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
           "launch_counts", "reset_launch_counts"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

launch_counts: "collections.Counter[str]" = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ff_window_attention_nhwc": [_P] * 6 + [_I] * 6 + [ctypes.c_float, _P],
    "ff_grl_mixed_attention_nhwc": [_P] * 16 + [_I] * 8 + [_P],
    "ff_selective_scan_proj": [_P] * 10 + [_I] * 8 + [_P],
    "ff_selective_scan": [_P] * 10 + [_I] * 7 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log = ""


def reset_launch_counts() -> None:
    launch_counts.clear()


def _sources():
    return sorted(CSRC.glob("*.cu"))


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
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = _build_root() / h.hexdigest()[:16]
    lib_path = out_dir / "libfreqfusion_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"tmp-{os.getpid()}.so"
    cmd = [_nvcc(), *flags, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{build_log}")
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
                fn.restype = ctypes.c_int
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


def require(t: torch.Tensor, name: str, shape, device) -> None:
    """Validate a tensor handed to a kernel: fp32, contiguous, on `device`,
    of `shape`."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
