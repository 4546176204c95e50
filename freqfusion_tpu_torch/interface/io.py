"""NTIRE entry point: main(model_dir, input_path, output_path, device).

Counterpart of ``freqfusion_tpu/interface/io.py``. Loads the reference
torch checkpoints by their file names (``_TORCH_FILES``) straight into the
port's modules by state-dict name, runs x4 SR over every PNG in
``input_path`` and writes PNGs to ``output_path``. A missing expert
checkpoint degrades that expert (bilinear image, zero features), a missing
fusion checkpoint gives a seeded random fusion net; both are reported.
``device=None`` means "cuda" and raises without a card: CPU runs pass
"cpu". The JAX package's native msgpack route and its optional TSD-SR
refiner are not ported.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Dict

import torch

from ..models.fusion.fusion_v2 import CompleteEnhancedFusionSR
from ..models.pipeline import (EXPERT_ORDER, FreqFusionPipeline,
                               build_expert_models)
from ..utils.image_io import read_image, write_image

__all__ = ["main", "load_pipeline", "load_state_dict_file", "resolve_device"]

_TORCH_FILES = {
    "drct": "DRCT-L_X4.pth",
    "grl": "GRL-B_SR_x4.pth",
    "nafnet": "NAFNet-SIDD-width64.pth",
    "mamba": "MambaIR_x4.pth",
    "fusion": "fusion_best.pth",
}
_CONTAINERS = ("params_ema", "params", "state_dict", "model",
               "model_state_dict")
# Buffers the reference stores and the port recomputes.
_BUFFER_NAMES = ("relative_position_index", "attn_mask")
_BUFFER_PREFIXES = ("table_", "index_", "mask_")
_BUFFER_SUFFIXES = ("dct_basis", "dct_basis_t", "low_mask", "mid_mask",
                    "high_mask", "lo_row", "hi_row", "lo_col", "hi_col",
                    "gaussian.kernel")


def resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the CPU")
        device = "cuda"
    return torch.device(device)


def load_state_dict_file(path) -> Dict[str, torch.Tensor]:
    """A reference .pth as {name: tensor}: container keys unwrapped,
    'module.' prefixes and recomputed buffers dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in _CONTAINERS:
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    out = {}
    for name, t in ckpt.items():
        name = name[len("module."):] if name.startswith("module.") else name
        parts = name.split(".")
        if (name == "mean" or name.startswith("expert_ensemble.")
                or any(b in name for b in _BUFFER_NAMES)
                or any(p.startswith(_BUFFER_PREFIXES) for p in parts)
                or name.endswith(_BUFFER_SUFFIXES)):
            continue
        out[name] = t
    return out


def _overrides(name: str, sd: Dict[str, torch.Tensor]) -> dict:
    """Geometry read from the checkpoint: the official DRCT-L release uses
    mlp_ratio 2 where the reference instantiates 4."""
    if name == "drct":
        return {"mlp_ratio": sd["layers.0.swin1.mlp.fc1.weight"].shape[0]
                / sd["conv_first.weight"].shape[0]}
    return {}


def load_pipeline(model_dir, device=None, scale: int = 4, seed: int = 0,
                  verbose: bool = True) -> FreqFusionPipeline:
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    mdir = Path(model_dir)
    experts = {}
    for name in EXPERT_ORDER:
        path = mdir / _TORCH_FILES[name]
        if not path.exists():
            print(f"  ! {name} checkpoint not found ({path.name}); "
                  "bilinear image + zero features")
            continue
        sd = load_state_dict_file(path)
        model = build_expert_models(scale, {name: _overrides(name, sd)},
                                    generator=g, names=(name,))[name]
        if name == "nafnet" and not any(k.startswith("nafnet.") for k in sd):
            model.nafnet.load_state_dict(sd)     # bare NAFNet checkpoint
        else:
            model.load_state_dict(sd)
        experts[name] = model
        if verbose:
            print(f"  loaded {name} from {path.name}")
    fusion = CompleteEnhancedFusionSR(upscale=scale, generator=g)
    fpath = mdir / _TORCH_FILES["fusion"]
    if fpath.exists():
        fusion.load_state_dict(load_state_dict_file(fpath))
        if verbose:
            print(f"  loaded fusion from {fpath.name}")
    else:
        print(f"  ! fusion weights missing ({fpath.name}); seeded random "
              "init")
    return FreqFusionPipeline(experts, fusion, scale).to(device).eval()


def main(model_dir: str, input_path: str, output_path: str,
         device=None) -> Dict[str, float]:
    """NTIRE challenge ABI. Returns {image name: seconds}, each time taken
    from reading the LR file to the SR result on the host."""
    device = resolve_device(device)
    os.makedirs(output_path, exist_ok=True)
    pipeline = load_pipeline(model_dir, device)
    if os.environ.get("FREQFUSION_TSDSR", "0") not in ("0", "false", ""):
        print("  ! the TSD-SR refiner is not ported to the PyTorch package; "
              "serving the fusion output (identity refiner)")
    files = sorted(p for p in Path(input_path).iterdir()
                   if p.suffix.lower() == ".png")
    print(f"FreqFusionSR (PyTorch, {device}): {len(files)} images")
    seconds = {}
    for i, path in enumerate(files):
        t0 = time.perf_counter()
        lr = torch.from_numpy(read_image(str(path))).permute(2, 0, 1)[None]
        with torch.inference_mode():
            sr = pipeline(lr.to(device))
        if not bool(torch.isfinite(sr).all()):
            raise RuntimeError(f"{path.name}: SR output is not finite")
        sr = sr[0].permute(1, 2, 0).cpu().numpy()
        write_image(str(Path(output_path) / f"{path.stem}.png"), sr)
        seconds[path.name] = time.perf_counter() - t0
        print(f"  [{i + 1}/{len(files)}] {path.name} {lr.shape[2]}x"
              f"{lr.shape[3]} -> {sr.shape[0]}x{sr.shape[1]} "
              f"({seconds[path.name]:.2f}s)")
    return seconds

