"""The wgmma GEMM's design choices (csrc/bf16_wgmma.cuh), measured on the
card through the bf16 qkv window attention (#11), the bf16 NAFBlock (#16),
the bf16 fused FFN (#14) and the bf16 CAB (#15), and ptxas's report on
their kernels.

Not part of the package's build (csrc/bench is not compiled by
ops/cuda.py). Run on the card, from the repository root:

    python3 freqfusion_tpu_torch/csrc/bench/wgmma_variants.py [--ffn-cab]

It builds copies of ``csrc/`` (``window_attention_qkv.cu``,
``window_attention.cu``, ``nafblock.cu``, ``fused_mlp.cu`` and ``cab.cu``
into one library each), each with one choice of the design changed or one
stage of the work taken out
(:func:`variants`; one nvcc each, all started together, into
``build/wgmma_variants/``), loads each with ctypes in place of the
package's library and times, by torch.profiler, each launch of one #11
bf16 call at C 180 and C 308, one #16 bf16 call at C 64 (1344x2048)
and C 1024 (84x128), one #14 bf16 call at C 244 (Ch 976) and post-norm
C 180 (Ch 360) and one #15 bf16 call in GRL-B's and MambaIR's form, all
at 336x512, the variants in turns and then in reverse order. A variant
that takes a stage out computes wrong values: it is there to show what
that stage costs. With ``--ffn-cab`` only #14 and #15 are timed, built
from ``fused_mlp.cu`` and ``cab.cu`` alone, with the variants that touch
them.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
CSRC = ROOT / "freqfusion_tpu_torch" / "csrc"
OUT = ROOT / "build" / "wgmma_variants"
NVCC = "/usr/local/cuda/bin/nvcc"
FFN_CAB = "--ffn-cab" in sys.argv
SOURCES = (("fused_mlp.cu", "cab.cu") if FFN_CAB else
           ("window_attention_qkv.cu", "window_attention.cu", "nafblock.cu",
            "fused_mlp.cu", "cab.cu"))


def _sub(files: dict, name: str, old: str, new: str) -> dict:
    if old not in files[name]:
        raise SystemExit(f"wgmma_variants: {name} no longer has {old!r}")
    return {**files, name: files[name].replace(old, new)}


PROFILED = ("as built, timing marks (-DBW_PROFILE)",
            "timing marks, #11's qkv projection alone")


def variants(files: dict) -> dict:
    """Each variant's sources: the design as it stands (and with its timing
    marks compiled in, also with #11's qkv projection alone), #11 at two
    warpgroups a block, #11's stores changed (to two rows only, so L2
    takes them all; without the tile's reads; st.global.cg), and the
    epilogues' stores and the staging's loads taken out; #14's H stores,
    #15's y stores and conv1's staging loads taken out."""
    h, n = "bf16_wgmma.cuh", "nafblock.cu"
    v = {"as built": files, PROFILED[0]: files,
         PROFILED[1]: _sub(files, "window_attention_qkv.cu",
                           "  if (err != cudaSuccess) return int(err);\n"
                           "  const int rc = ff_window_attention_nhwc_bf16(",
                           "  return int(err);\n"
                           "  const int rc = ff_window_attention_nhwc_bf16(")}
    v["no epilogue stores"] = _sub(
        files, h, "      epi(m0 + row, c * BN + 2 * u, tile[row * kTs + u], vs, np, "
        "pre[k]);", "      if (m0 < 0) epi(m0 + row, c * BN + 2 * u, "
        "tile[row * kTs + u], vs, np, pre[k]);")
    q = "window_attention_qkv.cu"
    store = "    *reinterpret_cast<uint32_t*>(o + m * width + c) = t;"
    v["#11 stores to two rows (L2 only)"] = _sub(
        files, q, store,
        "    *reinterpret_cast<uint32_t*>(o + (m & 1) * width + c) = t;")
    v["#11 stores, no tile reads"] = _sub(
        files, h, "      epi(m0 + row, c * BN + 2 * u, tile[row * kTs + u], "
        "vs, np, pre[k]);", "      epi(m0 + row, c * BN + 2 * u, Tile{}, "
        "vs, np, pre[k]);")
    v["#11 stores st.global.cg"] = _sub(
        files, q, store,
        "    __stcg(reinterpret_cast<unsigned int*>(o + m * width + c), t);")
    v["#11 two warpgroups a block (128 rows)"] = _sub(
        files, q, "  return bw_gemm<1, BN>(g, BwRows{a, M, K},",
        "  return bw_gemm<2, BN>(g, BwRows{a, M, K},")
    v["#14 no H stores"] = _sub(
        files, "fused_mlp.cu", "        bw_store(h0 + ",
        "        if (pieces < 0) bw_store(h0 + ")
    v["#14 up weights from four stages (in L2)"] = _sub(
        files, "fused_mlp.cu",
        "    if (tid == kThreads) bw_produce(r, a.w1, a.nch * nst);",
        "    if (tid == kThreads)\n      for (int i = 0; i < a.nch * nst; ++i)"
        "\n        bw_produce(r, static_cast<const unsigned char*>(a.w1) +"
        "\n                          (i & 3) * BN * 64, 1);")
    v["#14 no GELU"] = _sub(
        files, "fused_mlp.cu", "pack_bf16(gelu_erf(v0 + b1s[n]),\n"
        "                                     gelu_erf(v1 + b1s[n + 1]));",
        "pack_bf16(v0 + b1s[n], v1 + b1s[n + 1]);")
    v["#15 no y stores"] = _sub(
        files, "cab.cu", "          if (y < a.H && x < a.W && co < a.C) {",
        "          if (y < 0 && x < a.W && co < a.C) {")
    v["#15 conv1 no staging loads"] = _sub(
        files, "cab.cu", "        raw[k] = px < 0 ? make_uint4(0, 0, 0, 0)",
        "        raw[k] = px >= -1 ? make_uint4(0, 0, 0, 0)")
    v["no staging loads"] = _sub(
        files, h, "    for (int b = 0; b < kBwBatch; ++b) {\n"
        "      const int e = e0 + threads * b;\n      v[b] = e < items",
        "    for (int b = 0; b < kBwBatch; ++b) {\n"
        "      const int e = e0 + threads * b;\n      v[b] = e < 0")
    if FFN_CAB:
        v = {k: f for k, f in v.items() if k == "as built"
             or k.startswith(("#14", "#15", "no staging"))}
    return v


def build_all(sets: dict) -> dict:
    jobs = {}
    for i, (name, files) in enumerate(sets.items()):
        flags = ["-DBW_PROFILE"] if name in PROFILED else []
        d = OUT / f"v{i}"
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        for f, text in files.items():
            (d / f).write_text(text)
        lib = d / "lib.so"
        jobs[name] = (lib, subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             *flags, "-o", str(lib), *(str(d / s) for s in SOURCES)],
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
    """ptxas's lines on the wgmma kernels, performance notes included."""
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and re.search(r"bw_gemm|naf_(gate|apply)_wgmma|ffn_\w+_wgmma|"
                              r"cab_conv\d", name) and (
                "Used" in line or "spill" in line or "C75" in line
                or "Performance" in line):
            short = re.search(r"(bw_gemm_kernel|naf_\w+_wgmma_kernel|"
                              r"ffn_\w+_wgmma_kernel|cab_conv\d_kernel)\w*",
                              name).group(0)[:90]
            print(f"  {short}: {line.strip()[:200]}")


def time_variants() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT))
    from freqfusion_tpu_torch.ops import cuda, wgmma
    from freqfusion_tpu_torch.ops.attention import window_attention_qkv_nhwc
    from freqfusion_tpu_torch.ops.cab import cab_fused
    from freqfusion_tpu_torch.ops.mlp import fused_mlp_block
    from freqfusion_tpu_torch.ops.nafblock import nafblock_fused

    files = {f.name: f.read_text() for f in CSRC.iterdir()
             if f.suffix in (".cu", ".cuh")}
    libs = build_all(variants(files))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    calls = {}
    for c, heads in () if FFN_CAB else ((180, 6), (308, 4)):
        args = (randn(1, 336, 512, c), randn(c, 3 * c, scale=c ** -0.5),
                randn(3 * c, scale=0.1), randn(c, c, scale=c ** -0.5),
                randn(c, scale=0.1), randn(heads, 256, 256, scale=0.5),
                None, heads, 16)
        calls[f"#11 C{c}"] = (lambda a=args: window_attention_qkv_nhwc(*a))
    for c, hh, ww in () if FFN_CAB else ((64, 1344, 2048), (256, 336, 512),
                                         (1024, 84, 128)):
        def conv(cin, cout, k=1):
            return {"kernel": randn(k, k, 1 if k == 3 else cin, cout,
                                    scale=cin ** -0.5),
                    "bias": randn(cout, scale=0.1)}
        norm = {"scale": 1 + randn(c, scale=0.1), "bias": randn(c, scale=0.1)}
        tree = {"norm1": norm, "norm2": norm, "conv1": conv(c, 2 * c),
                "conv2": conv(2 * c, 2 * c, 3), "sca": conv(c, c),
                "conv3": conv(c, c), "conv4": conv(c, 2 * c),
                "conv5": conv(c, c), "beta": randn(c, scale=0.5),
                "gamma": randn(c, scale=0.5)}
        x = torch.rand(1, hh, ww, c, generator=g, device=dev).to(bf)
        calls[f"#16 C{c}"] = (lambda x=x, t=tree: nafblock_fused(x, t))
    for c, ch, pre in ((244, 976, True), (180, 360, False)):
        args = (randn(1, 336, 512, c), randn(c, ch, scale=c ** -0.5),
                randn(ch, scale=0.1), randn(ch, c, scale=ch ** -0.5),
                randn(c, scale=0.1), 1 + randn(c, scale=0.1),
                randn(c, scale=0.1), pre)
        calls[f"#14 C{c}{'' if pre else ' post'}"] = (
            lambda a=args: fused_mlp_block(*a))
    x = randn(1, 336, 512, 180, scale=0.5)
    for form, cr, sq in (("grl", 45, 18), ("mambair", 60, 30)):
        def conv3(cin, cout, k):
            return {"kernel": randn(k, k, cin, cout, scale=(k * k * cin) ** -0.5),
                    "bias": randn(cout, scale=0.1)}
        tree = {"cab_0": conv3(180, cr, 3), "cab_2": conv3(cr, 180, 3),
                "ca_1": conv3(180, 180 // sq, 1),
                "ca_3": conv3(180 // sq, 180, 1)}
        ln = ({"scale": 1 + randn(180, scale=0.1),
               "bias": randn(180, scale=0.1)} if form == "mambair" else None)
        calls[f"#15 {form}"] = (lambda t=tree, n=ln: cab_fused(x, t, n))

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
            key = re.sub(r"\(anonymous namespace\)::", "", e.key)
            m = re.search(r"(bw_gemm_kernel<[^>]*>|naf_\w+_wgmma_kernel<\d+>|"
                          r"window_attention_bf16_kernel|"
                          r"ffn_\w+_wgmma_kernel<[^>]*>|"
                          r"cab_conv\d_kernel(?:<\d+>)?|"
                          r"cab_apply_bf16_kernel)", key)
            if m and us > 0:
                out[m.group(1)] = out.get(m.group(1), 0.0) + us / reps / 1e3
        return out

    print(f"card: {torch.cuda.get_device_name(0)}; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    print("ms a call by kernel (torch.profiler, mean of 5 calls)")
    for name in list(libs) + list(reversed(libs)):
        lib = ctypes.CDLL(str(libs[name]))
        for fn, argtypes in cuda._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = (ctypes.c_longlong
                                            if fn in cuda._RETURNS_LONG
                                            else ctypes.c_int)
        cuda._lib = lib
        wgmma.clear_weight_layouts()
        print(f"  {name}")
        if name in PROFILED:
            marks(lib, {k: f for k, f in calls.items()
                        if k.startswith("#11") or (
                            name == PROFILED[0] and k.startswith("#16"))},
                  torch)
            continue
        for label, fn in calls.items():
            try:
                parts = split(fn)
            except RuntimeError as e:  # a variant a shape cannot launch
                print(f"    {label}: {e}")
                continue
            print(f"    {label}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in sorted(parts.items())))


def marks(lib, calls, torch) -> None:
    """Each kernel's timing marks (BW_PROFILE) after one call: the mean over
    its blocks of each mark's clock64 less the block's first, in thousands
    of SM clocks; a block's mean time, the kernel's span and their ratio
    (the blocks in flight), from the global timer."""
    import numpy as np

    groups = {"gate kernel": 0, "pass B kernel": 32,
              "bw_gemm_kernel (the call's last)": 64}
    buf = np.zeros(8192 * 96, dtype=np.int64)
    for label, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        for reader in ("ff_bw_prof_qkv", "ff_bw_prof_naf"):
            getattr(lib, reader).argtypes = [ctypes.c_void_p]
            getattr(lib, reader)(buf.ctypes.data)
            t = buf.reshape(8192, 96)
            for group, at in groups.items():
                base = t[:, at]
                live = base > 0
                if not live.any():
                    continue
                out = []
                for k in range(at, at + 30):
                    col = t[live, k]
                    if (col > 0).all():
                        out.append(f"{k - at}:"
                                   f"{(col - base[live]).mean() / 1e3:.1f}")
                t0, t1 = t[live, at + 30], t[live, at + 31]
                ok = (t0 > 0) & (t1 > 0)
                span = (t1[ok].max() - t0[ok].min()) / 1e3 if ok.any() else 0
                each = (t1[ok] - t0[ok]).mean() / 1e3 if ok.any() else 0
                print(f"    {label} {group} ({live.sum()} blocks): a block "
                      f"{each:.2f} us, span {span:.1f} us, "
                      f"{each * ok.sum() / max(span, 1e-9):.1f} blocks in "
                      "flight; k-clocks at each mark: " + " ".join(out))


if __name__ == "__main__":
    time_variants()
