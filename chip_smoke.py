"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failed check raises and the script
exits non-zero without the final ok line):

1. device: the card's name and power limit, the nvcc build of every CUDA
   kernel from ``freqfusion_tpu_torch/csrc`` (seconds, ptxas report),
   TF32 off for matmuls and convolutions;
2. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (336x512 LR bucket), max-abs error against the
   stated tolerance, and both times (CUDA events, median of 5 after
   warm-up);
3. serving: seeded full-width random checkpoints under the reference file
   names, three LR PNGs (128x128, 100x140, 336x512) through
   ``freqfusion_tpu_torch.interface.io.main(..., device="cuda")``, output
   checks, the kernels' launch counts and the seconds per request;
4. card against CPU: the same weights on one 32x48 LR image through the
   kernels on the card and the plain versions on the CPU; PSNR >= 60 dB.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ATTN_TOL = 1e-4        # fp32 attention, max-abs
SCAN_REL_TOL = 1e-3    # scan, max-abs relative to max |y_ref|
PSNR_MIN = 60.0
LR_SIZES = {"a_128x128": (128, 128), "b_100x140": (100, 140),
            "c_336x512": (336, 512)}
# launches per image: DRCT 12 RDGs x 5 blocks, GRL sum of depths, MambaIR
# 36 layers x 4 directions
PER_IMAGE = {"window_attention_nhwc": 60, "grl_mixed_attention_nhwc": 40,
             "selective_scan": 144}
SOURCES = {
    "window_attention_nhwc": ("freqfusion_tpu_torch/csrc/window_attention.cu",
                              "freqfusion_tpu/ops/pallas_attention.py:238"),
    "grl_mixed_attention_nhwc": ("freqfusion_tpu_torch/csrc/grl_attention.cu",
                                 "freqfusion_tpu/ops/pallas_attention.py:548"),
    "selective_scan": ("freqfusion_tpu_torch/csrc/selective_scan.cu",
                       "freqfusion_tpu/ops/selective_scan.py:1310"),
}


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class KernelCheck:
    """Error and times of one kernel against its plain version, summed
    over the shapes it is checked at."""

    def __init__(self, name: str):
        self.name, self.err, self.ms, self.plain_ms = name, 0.0, 0.0, 0.0
        self.shapes = []

    def run(self, label: str, kernel, plain, tol_of) -> None:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        outs = got if isinstance(got, tuple) else (got,)
        refs = want if isinstance(want, tuple) else (want,)
        err = max((g - w).abs().max().item() for g, w in zip(outs, refs))
        tol = tol_of(refs)
        plain_ms, ms = cuda_ms(plain), cuda_ms(kernel)
        ms2, plain_ms2 = cuda_ms(kernel), cuda_ms(plain)
        ms, plain_ms = (ms + ms2) / 2, (plain_ms + plain_ms2) / 2
        print(f"  {self.name} {label}: max_abs_err {err:.3e} (tol {tol:.3e})"
              f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
        if not err <= tol:
            raise AssertionError(f"{self.name} {label}: error {err} > {tol}")
        self.err = max(self.err, err)
        self.ms += ms
        self.plain_ms += plain_ms
        self.shapes.append(label)


def phase_kernels(dev):
    from freqfusion_tpu_torch.ops.attention import (
        grl_mixed_attention_nhwc, grl_mixed_attention_nhwc_reference,
        window_attention_nhwc, window_attention_nhwc_reference)
    from freqfusion_tpu_torch.ops.selective_scan import (
        selective_scan_chain_proj, selective_scan_chain_proj_reference)
    from freqfusion_tpu_torch.ops.window_attention import (
        device_table, shifted_window_mask)

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def attn_tol(_):
        return ATTN_TOL

    h, w = LR_SIZES["c_336x512"]
    checks = {}
    wa = checks["window_attention_nhwc"] = KernelCheck("window_attention_nhwc")
    for c, heads in ((180, 6), (212, 4), (244, 2), (276, 6), (308, 4)):
        q, k, v = (randn(1, h, w, c) for _ in range(3))
        bias = randn(heads, 256, 256, scale=0.5)
        for shift in (0, 8):
            mask = device_table(shifted_window_mask, h, w, 16, shift,
                                device=dev)
            args = (q, k, v, bias, mask, heads, 16)
            wa.run(f"C{c}/hd{c // heads}/{'mask' if shift else 'nomask'}",
                   lambda: window_attention_nhwc(*args),
                   lambda: window_attention_nhwc_reference(*args), attn_tol)

    ga = checks["grl_mixed_attention_nhwc"] = KernelCheck(
        "grl_mixed_attention_nhwc")
    halves = [randn(1, h, w, 90) for _ in range(6)]
    anchor = randn(1, h // 2, w // 2, 90)
    scales = [10.0 + randn(3, 1, 1).abs() for _ in range(3)]
    biases = [16 * torch.sigmoid(randn(*s)) for s in ((3, 64, 64),
                                                     (3, 16, 64), (3, 64, 16))]
    for shift in (0, 4):
        mask = device_table(shifted_window_mask, h, w, 8, shift, device=dev)
        args = (*halves, anchor, *scales, *biases, mask, 3, 3, 8)
        ga.run("shift" if shift else "noshift",
               lambda: grl_mixed_attention_nhwc(*args),
               lambda: grl_mixed_attention_nhwc_reference(*args), attn_tol)

    sc = checks["selective_scan"] = KernelCheck("selective_scan")
    d, n, dtr = 360, 16, 12
    xc = randn(1, h, w, d)
    xpw = (torch.rand(44, d, generator=g, device=dev) * 2 - 1) / math.sqrt(d)
    dtw = (torch.rand(d, dtr, generator=g, device=dev) * 2 - 1) / math.sqrt(dtr)
    dt = torch.exp(torch.rand(d, generator=g, device=dev)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    bias = dt + torch.log(-torch.expm1(-dt))
    A = -torch.arange(1, n + 1, device=dev, dtype=torch.float32).repeat(d, 1)
    D = torch.ones(d, device=dev)
    for label, lay in (("rows", xc.transpose(1, 2).contiguous()),
                       ("cols", xc)):
        for rev in (False, True):
            args = (lay, xpw, dtw, A, D, bias, rev)
            sc.run(f"{label}/{'rev' if rev else 'fwd'}/T{lay.shape[1]}",
                   lambda: selective_scan_chain_proj(*args),
                   lambda: selective_scan_chain_proj_reference(*args),
                   lambda refs: SCAN_REL_TOL * refs[0].abs().max().item())
    return checks


def write_checkpoints(model_dir: Path, seed: int = 0) -> None:
    from freqfusion_tpu_torch.interface.io import _TORCH_FILES
    from freqfusion_tpu_torch.models.fusion.fusion_v2 import (
        CompleteEnhancedFusionSR)
    from freqfusion_tpu_torch.models.pipeline import build_expert_models

    g = torch.Generator().manual_seed(seed)
    models = build_expert_models(4, generator=g)
    models["fusion"] = CompleteEnhancedFusionSR(upscale=4, generator=g)
    for name, model in models.items():
        torch.save({"params": model.state_dict()}, model_dir / _TORCH_FILES[name])
        print(f"  wrote {_TORCH_FILES[name]}: "
              f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M params")


def write_inputs(in_dir: Path, seed: int = 0) -> None:
    from freqfusion_tpu_torch.utils.image_io import write_image

    rng = np.random.default_rng(seed)
    for name, (h, w) in LR_SIZES.items():
        coarse = rng.uniform(0, 1, (1, 3, h // 8 + 2, w // 8 + 2))
        img = torch.nn.functional.interpolate(
            torch.from_numpy(coarse), size=(h, w), mode="bicubic",
            align_corners=False)[0].permute(1, 2, 0).numpy()
        img = np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1)
        write_image(str(in_dir / f"{name}.png"), img)


def phase_serving(work: Path):
    from freqfusion_tpu_torch.interface.io import main
    from freqfusion_tpu_torch.ops import cuda
    from freqfusion_tpu_torch.utils.image_io import read_image

    model_dir, in_dir, out_dir = (work / d for d in ("models", "in", "out"))
    model_dir.mkdir()
    in_dir.mkdir()
    write_checkpoints(model_dir)
    write_inputs(in_dir)

    cuda.reset_launch_counts()
    seconds = main(str(model_dir), str(in_dir), str(out_dir), device="cuda")
    counts = dict(cuda.launch_counts)
    print(f"  launch counts: {json.dumps(counts, sort_keys=True)}")
    for name, per in PER_IMAGE.items():
        want = per * len(LR_SIZES)
        if counts.get(name, 0) != want:
            raise AssertionError(f"{name}: {counts.get(name, 0)} launches, "
                                 f"expected {want}")
    for name, (h, w) in LR_SIZES.items():
        sr = read_image(str(out_dir / f"{name}.png"))
        if sr.shape != (4 * h, 4 * w, 3) or not np.isfinite(sr).all():
            raise AssertionError(f"{name}: bad output {sr.shape}")
        if not (0.0 <= sr.min() and sr.max() <= 1.0 and sr.std() > 0.01):
            raise AssertionError(f"{name}: output range {sr.min()}..{sr.max()}"
                                 f" std {sr.std()}")
        print(f"  {name}: {h}x{w} -> {4 * h}x{4 * w}, "
              f"{seconds[name + '.png']:.3f} s/request, "
              f"{4 * h * 4 * w / seconds[name + '.png'] / 1e6:.3f} MP/s")
    return model_dir, counts


def phase_card_vs_cpu(model_dir: Path) -> None:
    from freqfusion_tpu_torch.interface.io import load_pipeline

    lr = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (1, 3, 32, 48)).astype(np.float32))
    outs = {}
    for dev in ("cuda", "cpu"):
        pipe = load_pipeline(str(model_dir), dev, verbose=False)
        t0 = time.perf_counter()
        with torch.inference_mode():
            outs[dev] = pipe(lr.to(dev)).cpu()
        print(f"  {dev}: {time.perf_counter() - t0:.2f} s")
        del pipe
    diff = (outs["cuda"] - outs["cpu"]).abs()
    mse = float((diff ** 2).mean())
    psnr = float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)
    print(f"  card vs CPU on 32x48: max_abs {diff.max().item():.3e}, "
          f"PSNR {psnr:.2f} dB (min {PSNR_MIN})")
    if not psnr >= PSNR_MIN:
        raise AssertionError(f"card vs CPU PSNR {psnr:.2f} < {PSNR_MIN}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from freqfusion_tpu_torch.ops import cuda
    except ImportError as e:
        print(f"chip_smoke: the freqfusion_tpu_torch package is missing "
              f"beside this script ({e})", file=sys.stderr)
        return 3

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[1] device: {kind}; nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  TF32 off for matmul and cuDNN: fp32 throughout")
    lib_path = cuda.build(ptxas_verbose=True)
    if cuda.build_seconds is None:
        print(f"  kernels already built: {lib_path}")
    else:
        print(f"  nvcc build: {cuda.build_seconds:.1f} s -> {lib_path}; ptxas:")
    for line in cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("    " + line.strip())
    cuda.library()
    dev = torch.device("cuda")

    print("[2] kernels against their plain versions (336x512 bucket)")
    checks = phase_kernels(dev)
    torch.cuda.empty_cache()

    print("[3] serving through freqfusion_tpu_torch.interface.io.main")
    with tempfile.TemporaryDirectory() as tmp:
        model_dir, counts = phase_serving(Path(tmp))
        torch.cuda.empty_cache()
        print("[4] card against CPU")
        phase_card_vs_cpu(model_dir)

    print(json.dumps({"kernels": [{
        "name": c.name, "route": "cuda", "source": SOURCES[c.name][0],
        "replaces": SOURCES[c.name][1], "launches": counts[c.name],
        "max_abs_err": c.err, "ms": c.ms, "plain_ms": c.plain_ms,
        "ms_covers": c.shapes} for c in checks.values()]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
