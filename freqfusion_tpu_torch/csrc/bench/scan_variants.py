"""The bf16 selective scan's design choices, measured on the card, and the
SASS of every scan pass's recurrence loop.

Not part of the package's build (csrc/bench is not compiled by
ops/cuda.py). Run on the card, from the repository root:

    python3 freqfusion_tpu_torch/csrc/bench/scan_variants.py
    python3 freqfusion_tpu_torch/csrc/bench/scan_variants.py --sass [DIR]

The first form builds copies of ``csrc/selective_scan.cu``, each with one
choice of the design undone or one stage of the projection's work taken
out (:func:`variants`; one nvcc each, all started together, into
``build/scan_variants/``), loads each with ctypes in place of the
package's library and times, by torch.profiler at the 336x512 bucket's
shapes, each launch of one bf16 #3/#4 call (rows, forward: the wgmma
projection and the two passes) and one bf16 #5 call (T = W, forward), the
variants in turns and then in reverse order. A variant that takes a stage
out computes wrong values: it is there to show what that stage costs.

The second form prints, for each scan pass kernel in the library that
``ops/cuda.py`` builds for the package at DIR (default: this checkout's;
another checkout's package, e.g. the parent commit's, is built with its
own sources), the instructions a step of its recurrence loop issues, by
opcode (``cuobjdump -sass``; the loop is the innermost backward branch
around 16 or more MUFU.EX2, its steps the EX2 count over 16, rounded).
"""

from __future__ import annotations

import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
CSRC = ROOT / "freqfusion_tpu_torch" / "csrc"
OUT = ROOT / "build" / "scan_variants"
NVCC = "/usr/local/cuda/bin/nvcc"


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"scan_variants: the source no longer has {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """Each variant's source: the design as it stands, three choices undone
    (pass 1's exponentials all on the SFU, or three on the FMA pipe; four
    ring stages with three blocks an SM) and five of the projection's
    stages taken out."""
    v = {"as built": src}
    v["pass 1: no ex2 on the FMA pipe"] = _sub(
        src, "constexpr int kEmu1 = 2;", "constexpr int kEmu1 = 0;")
    v["pass 1: three ex2 on the FMA pipe"] = _sub(
        src, "constexpr int kEmu1 = 2;", "constexpr int kEmu1 = 3;")
    v["passes: four stages, three blocks an SM"] = _sub(_sub(
        src, "constexpr int kRing16 = 3;", "constexpr int kRing16 = 4;"),
        "__launch_bounds__(kThreads16, kN ? 4 : 2)",
        "__launch_bounds__(kThreads16, kN ? 3 : 2)")
    v["projection: no epilogue"] = _sub(
        src, "for (int jg = 0; jg < kTiles; jg += kGroup) {",
        "for (int jg = 0; jg < kTiles * (r0 < 0); jg += kGroup) {")
    v["projection: no delta stores"] = _sub(
        src, "            *reinterpret_cast<float2*>(delta + (row0 + 8 * h)",
        "            if (r0 < 0) *reinterpret_cast<float2*>(delta + "
        "(row0 + 8 * h)")
    v["projection: no u stores"] = _sub(
        src, "      if (row < rows && col < D) {\n        __nv_bfloat16* dst",
        "      if (row < 0) {\n        __nv_bfloat16* dst")
    v["projection: no xc loads, no u stores"] = _sub(
        v["projection: no u stores"],
        "if (e < items && row < rows && 8 * q < D)",
        "if (e < items && row < 0)")
    v["projection: no weight copies"] = _sub(_sub(
        src, "mbar_arrive_expect_tx(&full[s], kPwSlice);",
        "mbar_arrive(&full[s]);"),
        "bulk_copy(ring + s * kPwSlice, src + (long long)it * kPwSlice,\n"
        "                  kPwSlice, &full[s]);", "")
    return v


def build_all(sources: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, lib = OUT / f"v{i}.cu", OUT / f"libv{i}.so"
        cu.write_text(text)
        jobs[name] = (lib, subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC),
             "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"scan_variants: {name} failed to build\n{log}")
        libs[name] = lib
    return libs


def time_variants() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT))
    from freqfusion_tpu_torch.ops import cuda
    from freqfusion_tpu_torch.ops import selective_scan as ss

    libs = build_all(variants((CSRC / "selective_scan.cu").read_text()))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    h, w, d, n, dtr = 336, 512, 360, 16, 12

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale
    xc = randn(1, w, h, d).to(bf)
    xpw = ((torch.rand(44, d, generator=g, device=dev) * 2 - 1)
           / d ** 0.5).to(bf)
    dtw = ((torch.rand(d, dtr, generator=g, device=dev) * 2 - 1)
           / dtr ** 0.5).to(bf)
    A = -torch.arange(1, n + 1, device=dev, dtype=torch.float32).repeat(d, 1)
    D = torch.ones(d, device=dev, dtype=bf)
    bias = torch.full((d,), -3.0, device=dev).to(bf)
    u = torch.nn.functional.silu(randn(1, w, h, d)).to(bf)
    dt, Bm, Cm = (randn(1, w, h, d, scale=0.3).to(bf),
                  randn(1, w, h, n).to(bf), randn(1, w, h, n).to(bf))

    def split(fn, reps=5) -> dict:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            part = ("projection" if "wgmma" in e.key else
                    "pass 2" if "pass16_kernel<true" in e.key else
                    "pass 1" if "pass16_kernel<false" in e.key else None)
            if part and us > 0:
                out[part] = us / e.count / 1e3
        return out

    print(f"card: {torch.cuda.get_device_name(0)}; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    print("ms a launch (torch.profiler, mean of 5 calls); #3/#4 bf16 rows "
          "forward, #5 bf16 512x336 forward")
    for name in list(libs) + list(reversed(libs)):
        lib = ctypes.CDLL(str(libs[name]))
        for fn in ("ff_selective_scan_slots", "ff_selective_scan_proj_bf16",
                   "ff_selective_scan_bf16"):
            getattr(lib, fn).argtypes = cuda._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        cuda._lib = lib
        ss._slots.clear()
        a = split(lambda: ss.selective_scan_chain_proj(xc, xpw, dtw, A, D,
                                                       bias, False))
        b = split(lambda: ss.selective_scan_chain(u, dt, A, Bm, Cm, D, bias,
                                                  False, bf))
        print(f"  {name:42s} #3/#4: projection {a['projection']:.3f} "
              f"pass 1 {a['pass 1']:.3f} pass 2 {a['pass 2']:.3f} | #5: "
              f"pass 1 {b['pass 1']:.3f} pass 2 {b['pass 2']:.3f}")


def loop_counts(sass: str) -> None:
    """Print, for each scan pass kernel in a ``cuobjdump -sass`` listing,
    the instructions a step of its recurrence loop issues, by opcode."""
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        m = re.search(r"(scan_pass(?:16)?_kernel)I(\w+?)EEv", name)
        if not m:
            continue
        ins = []
        for line in fn.split("\n"):
            hit = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if hit:
                body = re.sub(r"^@!?U?P\w+\s+", "", hit.group(2).strip())
                ins.append((int(hit.group(1), 16), body.split()[0], body))
        at = {a: i for i, (a, _, _) in enumerate(ins)}
        loops = []  # (first, last) instruction of each backward branch
        for i, (a, op, body) in enumerate(ins):
            tgt = re.search(r"0x([0-9a-f]+)", body) if op == "BRA" else None
            if tgt and int(tgt.group(1), 16) <= a and \
                    int(tgt.group(1), 16) in at:
                loops.append((at[int(tgt.group(1), 16)], i))
        inner = [lp for lp in loops if sum(
            op == "MUFU.EX2" for _, op, _ in ins[lp[0]:lp[1] + 1]) >= 16]
        if not inner:
            continue
        first, last = min(inner, key=lambda lp: lp[1] - lp[0])
        best = ins[first:last + 1]
        # the loop around it, over a ring stage's steps
        outer = [lp for lp in loops if lp[0] <= first and lp[1] >= last
                 and lp != (first, last)]
        stage = (ins[min(outer, key=lambda lp: lp[1] - lp[0])[0]:
                     min(outer, key=lambda lp: lp[1] - lp[0])[1] + 1]
                 if outer else best)
        ops = collections.Counter(op.split(".")[0] for _, op, _ in best)
        ex2 = sum(op == "MUFU.EX2" for _, op, _ in best)
        steps = max(1, round(ex2 / 16))
        named = ("MUFU", "FFMA", "FMUL", "LDS", "STS", "BAR")
        print(f"  {m.group(1)}<{m.group(2)}>: {len(best) / steps:.1f} a step "
              f"({steps} steps a loop): MUFU {ops['MUFU'] / steps:.1f} (EX2 "
              f"{ex2 / steps:.1f}), " + ", ".join(
                  f"{k} {ops[k] / steps:.1f}" for k in named[1:])
              + f", other {(len(best) - sum(ops[k] for k in named)) / steps:.1f}"
              f"; the stage loop around it (once a ring stage): {len(stage)}"
              f" instructions, BAR {sum(op.startswith('BAR') for _, op, _ in stage)}"
              f", SYNCS {sum(op.startswith('SYNCS') for _, op, _ in stage)}")


def sass_counts(package: Path) -> None:
    """loop_counts of the library the package at `package` builds."""
    sys.path.insert(0, str(package.parent))
    from freqfusion_tpu_torch.ops import cuda

    lib = cuda.build()
    print(f"SASS of {lib}")
    loop_counts(subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                                str(lib)], capture_output=True,
                               text=True).stdout)


if __name__ == "__main__":
    if "--sass" in sys.argv:
        at = sys.argv.index("--sass") + 1
        pkg = (Path(sys.argv[at]).resolve() if at < len(sys.argv)
               else ROOT / "freqfusion_tpu_torch")
        sass_counts(pkg)
    else:
        time_variants()
