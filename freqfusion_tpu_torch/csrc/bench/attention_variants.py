"""What holds the bf16 window attention (#1 bf16, ``csrc/window_attention.cu``,
``ff_window_attention_nhwc_bf16``) or, with ``--grl``, the bf16 GRL mixed
attention (#2 bf16, ``csrc/grl_attention.cu``,
``ff_grl_mixed_attention_nhwc_bf16``) on the card: its time with one stage
of the work taken out at a time, and ptxas's report on it.

Not part of the package's build (csrc/bench is not compiled by
ops/cuda.py). Run on the card, from the repository root:

    python3 freqfusion_tpu_torch/csrc/bench/attention_variants.py [--grl] [--tree DIR]

It builds copies of the kernel's source (with the headers beside it),
each with one stage changed (:data:`WINDOW_VARIANTS`, :data:`GRL_VARIANTS`;
one nvcc each, all started together, into ``build/attention_variants/``
or ``build/grl_variants/``), loads each with ctypes in place of the
package's library and times one call by CUDA events (median of 9 after 3
warm-ups), the variants in turns and then in reverse order: #1 at C 180
(6 heads) and C 244 (2 heads) on the 336x512 bucket, shifted and not; #2
at GRL-B's two shapes on the same bucket (C/2 90, 3 + 3 heads; unshifted,
and shifted with the mask). The sources come from ``freqfusion_tpu_torch/csrc`` or, with
``--tree``, from the package under DIR (a ``git archive`` of another
commit), which is also the package that is imported, so that each wrapper
calls its own kernel. A variant names the source text it replaces; one
whose text the tree does not have is reported and left out, so that the
list serves both #1's earlier kernel (two sweeps over the keys on
``mma.sync``) and the one-pass ``wgmma`` kernel that replaced it. A
variant that takes a stage out computes wrong values: it is there to show
what that stage costs.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
TREE = (Path(sys.argv[sys.argv.index("--tree") + 1]).resolve()
        if "--tree" in sys.argv else ROOT)
CSRC = TREE / "freqfusion_tpu_torch" / "csrc"
GRL = "--grl" in sys.argv
OUT = ROOT / "build" / ("grl_variants" if GRL else "attention_variants")
NVCC = "/usr/local/cuda/bin/nvcc"
SOURCE = "grl_attention.cu" if GRL else "window_attention.cu"

# (variant, [(old text, new text), ...]) on the source; every occurrence
# of each old text is replaced
PROFILED = "as built, timing marks (-DBW_PROFILE)"
WINDOW_VARIANTS = (
    ("as built", []),
    (PROFILED, []),
    # the earlier two-sweep mma.sync kernel
    ("two sweeps: no bias or mask fetches", [
        ("        ad.b[j][h] = __ldg(reinterpret_cast<const unsigned int*>"
         "(bb + off));\n"
         "        ad.m[j][h] = mb ? __ldg(reinterpret_cast<const float2*>"
         "(mb + off))\n"
         "                        : make_float2(0.f, 0.f);",
         "        ad.b[j][h] = off < 0 ? 1u : 0u;\n"
         "        ad.m[j][h] = make_float2(0.f, 0.f);")]),
    ("two sweeps: sweep 1 replaced by fixed row statistics", [
        ("  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};\n"
         "  Add cur, nxt;\n  fetch(cur, 0);\n"
         "  for (int k0 = 0; k0 < n; k0 += 16) {",
         "  float m[2] = {0.f, 0.f}, l[2] = {1.f, 1.f};\n"
         "  Add cur, nxt;\n  fetch(cur, 0);\n"
         "  for (int k0 = n; k0 < n; k0 += 16) {")]),
    ("two sweeps: no exponentials", [
        ("ex2(s[0][2 * h] - mn) + ex2(s[0][2 * h + 1] - mn) +\n"
         "                       ex2(s[1][2 * h] - mn) + ex2(s[1][2 * h + 1]"
         " - mn);",
         "(s[0][2 * h] - mn) + (s[0][2 * h + 1] - mn) +\n"
         "                       (s[1][2 * h] - mn) + (s[1][2 * h + 1]"
         " - mn);"),
        ("      l[h] = l[h] * ex2(m[h] - mn) + ps;",
         "      l[h] = l[h] * (m[h] - mn) + ps;"),
        ("s[j][e] = ex2(s[j][e] - m[e / 2]);",
         "s[j][e] = s[j][e] - m[e / 2];")]),
    ("two sweeps: the staging alone", [
        ("  __syncthreads();\n\n  const int r0 = 16 * warp;",
         "  __syncthreads();\n"
         "  if (tid == 0) out[blockIdx.x] = qs[kLd + 1];\n"
         "  if (blockIdx.x < 0x7fffffff) return;\n"
         "  const int r0 = 16 * warp;")]),
    ("two sweeps: the stores alone", [
        ("  for (int idx = tid; idx < 3 * n * kCh; idx += blockDim.x) {",
         "  for (int idx = tid; idx < 0; idx += blockDim.x) {"),
        ("  fetch(cur, 0);\n  for (int k0 = 0; k0 < n; k0 += 16) {",
         "  for (int k0 = 0; k0 < 0; k0 += 16) {")]),
    # the one-pass wgmma kernel
    ("one pass: no bias or mask loads", [
        ("          const bool ok = r < n && 128 * hh + 32 * bl + 8 * t4 < n;",
         "          const bool ok = false;")]),
    ("one pass: no exponentials", [
        ("        const float e = ex2(fmaf(x, kLog2e, -mx[h]));",
         "        const float e = fmaf(x, kLog2e, -mx[h]);")]),
    ("one pass: no products", [
        ("      wa_qk<HDP>(s[hh], qs + t * 2048, ks + hh * 4096, nq, nk);",
         "      if (nq < 0) wa_qk<HDP>(s[hh], qs + t * 2048, ks + hh * 4096,"
         " nq, nk);"),
        ("    wa_pv<HDP>(o, p, vs, n, nk);",
         "    if (nq < 0) wa_pv<HDP>(o, p, vs, n, nk);")]),
    ("one pass: the staging alone", [
        ("  __syncthreads();\n  BW_MARK(1);\n  // the block's query tiles",
         "  __syncthreads();\n"
         "  if (tid == 0) out[blockIdx.x] = *reinterpret_cast<"
         "__nv_bfloat16*>(ks + 2);\n"
         "  if (blockIdx.x < 0x7fffffff) return;\n"
         "  // the block's query tiles")]),
    ("one pass: each tile's bias and mask loaded a phase ahead", [
        ("    load_terms(t);\n", ""),
        ("    BW_MARK(5 + 5 * (t / WG));\n",
         "    BW_MARK(5 + 5 * (t / WG));\n"
         "    if (t + WG < tiles) load_terms(t + WG);\n"),
        ("  };\n  __syncthreads();\n",
         "  };\n  load_terms(wg);\n  __syncthreads();\n")]),
    ("one pass: two blocks an SM at head boxes up to 32", [
        ("__launch_bounds__(128 * WG, WG == 1 ? (HDP <= 32 ? 3 : 2) : 1)",
         "__launch_bounds__(128 * WG, WG == 1 ? 2 : 1)")]),
    ("one pass: K and V staged by token (their stores' banks clash)", [
        ("wa_stage<HDP, kThreads, true>", "wa_stage<HDP, kThreads, false>"),
        ("[&](int r, int c) { return ks + bw_a_off(r, c, nk); }",
         "[&](int r, int c) { return ks + bw_a_off(wa_perm(r), c, nk); }"),
        ("return vs + c * nk * 16 + (r >> 3) * 128 + (r & 7) * 16;",
         "return vs + c * nk * 16 + (wa_perm(r) >> 3) * 128 +\n"
         "               (wa_perm(r) & 7) * 16;")]),
    ("one pass: two rows in flight a thread in the staging, any width", [
        ("  constexpr int kRows = kW <= 5 ? 3 : kW <= 9 ? 2 : 1;",
         "  constexpr int kRows = kW <= 5 ? 3 : 2;")]),
    ("one pass: the staging's loads alone", [
        ("        *reinterpret_cast<uint4*>(dst(r, c)) =\n"
         "            map(make_uint4(o[0], o[1], o[2], o[3]));",
         "        if (o[0] == 0x12345678u && o[1] == 7u)\n"
         "          *reinterpret_cast<uint4*>(dst(r, c)) =\n"
         "              map(make_uint4(o[0], o[1], o[2], o[3]));")]),
    ("one pass: the staging's stores alone", [
        ("        const uint4 x = u < words ? __ldg(base + u) : make_uint4(0, 0, 0, 0);",
         "        const uint4 x = make_uint4(u, words, 0, 0);")]),
    ("one pass: one row in flight a thread in the staging", [
        ("  constexpr int kRows = kW <= 5 ? 3 : kW <= 9 ? 2 : 1;",
         "  constexpr int kRows = 1;")]),
    ("one pass: the stores alone", [
        ("  for (int r0 = tid; r0 < rows; r0 += kThreads * kRows) {",
         "  for (int r0 = tid; r0 < 0; r0 += kThreads * kRows) {"),
        (("    float s[2][64];", "    // O through the warpgroup's tile"),
         "    float o[HDP / 2] = {};\n")]),
)

# #2 bf16's persistent body: a block walks tiles of one half
GRL_VARIANTS = (
    ("as built", []),
    ("no bias or mask terms", [
        ("      const float2 bj = bias(j, h), mj = mask(j, h);",
         "      const float2 bj = make_float2(0.f, 0.f), mj = bj;")]),
    ("no norms", [
        ("  const float f0 = gb_inv_norm(quad_sum(s0)), "
         "f1 = gb_inv_norm(quad_sum(s1));",
         "  const float f0 = 1.f + 0.f * s0, f1 = 1.f + 0.f * s1;"),
        ("  const float f = gb_inv_norm(quad_sum(s));",
         "  const float f = 1.f + 0.f * s;")]),
    ("no output stores", [
        ("    for (int y = 0; y < kGrlWs; ++y)\n      bw_store(",
         "    for (int y = 0; y < 0; ++y)\n      bw_store(")]),
    ("the staging and the stores alone (no units)", [
        ("    for (int u = warp; u < units; u += kWarps) {\n"
         "      const int h = u / 4, r = u % 4",
         "    for (int u = warp; u < 0; u += kWarps) {\n"
         "      const int h = u / 4, r = u % 4"),
        ("    for (int h = warp; h < heads; h += kWarps) {  // stage 1",
         "    for (int h = warp; h < 0; h += kWarps) {  // stage 1"),
        ("    for (int u = warp; u < units; u += kWarps) {  // stage 2",
         "    for (int u = warp; u < 0; u += kWarps) {  // stage 2")]),
    ("the window half alone", [
        ("  const long long total = (long long)p.B * k.tiles;",
         "  const long long total = stripe ? 0 : (long long)p.B * k.tiles;")]),
    ("the stripe half alone", [
        ("  const long long total = (long long)p.B * k.tiles;",
         "  const long long total = stripe ? (long long)p.B * k.tiles : 0;")]),
)
VARIANTS = GRL_VARIANTS if GRL else WINDOW_VARIANTS


def _apply(text: str, old, new: str):
    """text with every `old` replaced by `new` (a pair of texts: all from
    the first up to the second, the second kept), or None if it lacks it."""
    if isinstance(old, tuple):
        a = text.find(old[0])
        b = text.find(old[1], a) if a >= 0 else -1
        return None if b < 0 else text[:a] + new + text[b:]
    return text.replace(old, new) if old in text else None


def variants(text: str) -> dict:
    out = {}
    for name, subs in VARIANTS:
        t = text
        for old, new in subs:
            t = _apply(t, old, new) if t is not None else None
        if t is None:
            print(f"  {name}: not in this tree, left out")
            continue
        out[name] = t
    return out


def build_all(sets: dict) -> dict:
    headers = {f.name: f.read_text() for f in CSRC.iterdir()
               if f.suffix == ".cuh"}
    jobs = {}
    for i, (name, text) in enumerate(sets.items()):
        d = OUT / f"v{i}"
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        for f, t in headers.items():
            (d / f).write_text(t)
        (d / SOURCE).write_text(text)
        lib = d / "lib.so"
        flags = ["-DBW_PROFILE"] if name == PROFILED else []
        jobs[name] = (lib, subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             *flags, "-o", str(lib), str(d / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"  {name}: failed to build, left out\n" + "\n".join(
                ln for ln in log.splitlines() if "error" in ln)[:2000])
            continue
        libs[name] = lib
        if name == "as built":
            report(log)
    return libs


def report(log: str) -> None:
    """ptxas's lines on the bf16 kernels (registers, spills, stack)."""
    kernel = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"((?:window_attention_(?:bf16|wgmma)|"
                          r"grl_\w*bf16\w*?)_kernel\w*?E)(?:Ev|EEv|v)",
                          m.group(1))
            kernel = k.group(1) if k else None
        elif kernel and ("Used" in line or "spill" in line):
            print(f"  ptxas {kernel}: {line.strip()[:160]}")


def marks(lib, calls, torch) -> None:
    """The kernel's timing marks (BW_PROFILE) after one call of each:
    thread 0's clock64 at each mark less its first, the mean over the
    blocks, in thousands of SM clocks (1: staged; then for each tile of
    the first warpgroup: S issued, S done, P formed, O done, O stored); a
    block's mean time, the kernel's span (global timer) and their ratio,
    the blocks in flight."""
    import numpy as np

    lib.ff_bw_prof_wa.argtypes = [ctypes.c_void_p]
    buf = np.zeros(8192 * 96, dtype=np.int64)
    for label, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        lib.ff_bw_prof_wa(buf.ctypes.data)
        t = buf.reshape(8192, 96)
        live = t[:, 30] > 0
        base = t[live, 0]
        out = []
        for k in range(1, 30):
            col = t[live, k]
            if (col > 0).all():
                out.append(f"{k}:{(col - base).mean() / 1e3:.2f}")
        t0, t1 = t[live, 30], t[live, 31]
        span = (t1.max() - t0.min()) / 1e3
        each = (t1 - t0).mean() / 1e3
        print(f"    {label} ({live.sum()} blocks): a block {each:.2f} us, "
              f"span {span:.1f} us, {each * live.sum() / span:.1f} blocks "
              "in flight; k-clocks at each mark: " + " ".join(out))


def window_calls(torch, dev, g) -> dict:
    """#1 bf16 at C 180 and C 244, shifted and not."""
    from freqfusion_tpu_torch.ops.attention import window_attention_nhwc
    from freqfusion_tpu_torch.ops.window_attention import (
        device_table, shifted_window_mask)

    bf = torch.bfloat16
    h, w = 336, 512
    calls = {}
    for c, heads in ((180, 6), (244, 2)):
        q, k, v = (torch.randn(1, h, w, c, generator=g, device=dev).to(bf)
                   for _ in range(3))
        bias = (0.5 * torch.randn(heads, 256, 256, generator=g,
                                  device=dev)).to(bf)
        for shift in (0, 8):
            mask = device_table(shifted_window_mask, h, w, 16, shift,
                                device=dev)
            calls[f"C{c}/{'mask' if shift else 'nomask'}"] = (
                lambda a=(q, k, v, bias, mask, heads, 16):
                window_attention_nhwc(*a))
    return calls


def grl_calls(torch, dev, g) -> dict:
    """#2 bf16 at GRL-B's two shapes: unshifted, and shifted with the
    mask."""
    from freqfusion_tpu_torch.ops.attention import grl_mixed_attention_nhwc
    from freqfusion_tpu_torch.ops.window_attention import (
        device_table, shifted_window_mask)

    bf = torch.bfloat16
    h, w = 336, 512

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    halves = [randn(1, h, w, 90).to(bf) for _ in range(6)]
    anchor = randn(1, h // 2, w // 2, 90).to(bf)
    scales = [10.0 + randn(3, 1, 1).abs() for _ in range(3)]
    biases = [16 * torch.sigmoid(randn(*s)) for s in ((3, 64, 64),
                                                     (3, 16, 64), (3, 64, 16))]
    calls = {}
    for shift in (0, 4):
        mask = device_table(shifted_window_mask, h, w, 8, shift, device=dev)
        calls["shift" if shift else "noshift"] = (
            lambda a=(*halves, anchor, *scales, *biases, mask, 3, 3, 8):
            grl_mixed_attention_nhwc(*a))
    return calls


def main() -> None:
    import torch

    sys.path.insert(0, str(TREE))
    from freqfusion_tpu_torch.ops import cuda

    libs = build_all(variants((CSRC / SOURCE).read_text()))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    calls = (grl_calls if GRL else window_calls)(torch, dev, g)

    def ms(fn, reps=9, warmup=3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    print(f"card: {torch.cuda.get_device_name(0)}; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    print(f"sources: {CSRC}")
    print("ms a call (CUDA events, median of 9)")
    for name in list(libs) + list(reversed(libs)):
        lib = ctypes.CDLL(str(libs[name]))
        for fn, argtypes in cuda._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        cuda._lib = lib
        if name == PROFILED:
            print(f"  {name}")
            marks(lib, calls, torch)
            continue
        if name == "as built" and hasattr(
                lib, "ff_window_attention_bf16_occupancy"):
            occ = lib.ff_window_attention_bf16_occupancy
            occ.argtypes = [ctypes.c_int, ctypes.c_int]
            print("  blocks an SM (runtime occupancy), N 256: " + ", ".join(
                f"hd {hd}: {occ(256, hd)}" for hd in (30, 53, 122, 46, 77)))
        parts = []
        for label, fn in calls.items():
            try:
                parts.append(f"{label} {ms(fn):.3f}")
            except (RuntimeError, ValueError) as e:  # a shape it refuses
                parts.append(f"{label} failed ({e})")
        print(f"  {name}: " + ", ".join(parts))


if __name__ == "__main__":
    main()
