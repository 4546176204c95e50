"""NTIRE entry point: main(model_dir, input_path, output_path, device).

Counterpart of ``freqfusion_tpu/interface/io.py``. Loads the reference
torch checkpoints by their file names (``_TORCH_FILES``) straight into the
port's modules by state-dict name, runs x4 SR over every image in
``input_path`` and writes PNGs to ``output_path``. DRCT's and MambaIR's
geometry is read from their checkpoints' tensor shapes
(``convert/drct.py``, ``convert/mambair.py``). An expert whose checkpoint
is missing or does not load degrades (bilinear image, zero features), a
fusion checkpoint that is missing or does not load gives a seeded random
fusion net; each case is reported with the JAX interface's message.
Inputs are the PNG, JPEG and BMP files of ``input_path``
(``utils/image_io.py``); a file that cannot be decoded is named, skipped
and counted, and the run goes on.
``device=None`` means "cuda" and raises without a card: CPU runs pass
"cpu". ``FREQFUSION_EXPERT_DTYPE`` set to "bf16" or "bfloat16" (any case)
serves the experts in bf16 (:func:`expert_dtype`), as the JAX interface
reads it. The JAX package's native msgpack route and its optional TSD-SR
refiner are not ported.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from ..convert.drct import sniff_drct_config
from ..convert.mambair import sniff_mambair_config
from ..models.fusion.fusion_v2 import CompleteEnhancedFusionSR
from ..models.pipeline import (EXPERT_ORDER, FreqFusionPipeline,
                               build_expert_models)
from ..utils.image_io import IMAGE_SUFFIXES, read_image, write_image

__all__ = ["main", "load_pipeline", "load_state_dict_file", "resolve_device",
           "expert_dtype"]

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


def expert_dtype() -> Optional[torch.dtype]:
    """The experts' dtype FREQFUSION_EXPERT_DTYPE asks for: bf16 for "bf16"
    or "bfloat16" (any case), else None (fp32), as
    freqfusion_tpu/interface/io.py reads it."""
    return {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16}.get(
        os.environ.get("FREQFUSION_EXPERT_DTYPE", "").lower())


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


_SNIFFERS = {"drct": sniff_drct_config, "mamba": sniff_mambair_config}


def _sniff_config(name: str, sd: Dict[str, torch.Tensor]) -> dict:
    """The geometry `sd` was trained at, as the expert's keyword arguments
    ({} for the experts whose geometry is fixed, or when sniffing fails)."""
    sniff = _SNIFFERS.get(name)
    if sniff is None:
        return {}
    try:
        return sniff(sd)
    except Exception as e:  # noqa: BLE001 (sniffing is best-effort, as in JAX)
        print(f"  ! {name} config sniff failed: {e}")
        return {}


def _load_expert(name: str, path: Path, scale: int,
                 generator: torch.Generator) -> torch.nn.Module:
    sd = load_state_dict_file(path)
    model = build_expert_models(scale, {name: _sniff_config(name, sd)},
                                generator=generator, names=(name,))[name]
    if name == "nafnet" and not any(k.startswith("nafnet.") for k in sd):
        model.nafnet.load_state_dict(sd)     # bare NAFNet checkpoint
    else:
        model.load_state_dict(sd)
    return model


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
        try:
            experts[name] = _load_expert(name, path, scale, g)
        except Exception as e:  # noqa: BLE001 (degrade, as the JAX interface)
            print(f"  ! {name} conversion failed: {e}")
            continue
        if verbose:
            print(f"  loaded {name} from {path.name}")
    fusion = None
    fpath = mdir / _TORCH_FILES["fusion"]
    if fpath.exists():
        try:
            fusion = CompleteEnhancedFusionSR(upscale=scale)
            fusion.load_state_dict(load_state_dict_file(fpath))
        except Exception as e:  # noqa: BLE001 (degrade, as the JAX interface)
            print(f"  ! fusion conversion failed: {e}")
            fusion = None
        else:
            if verbose:
                print(f"  loaded fusion from {fpath.name}")
    if fusion is None:
        print(f"  ! fusion weights missing ({fpath.name}); seeded random "
              "init")
        # a generator of its own: the init does not depend on the experts
        fusion = CompleteEnhancedFusionSR(
            upscale=scale, generator=torch.Generator().manual_seed(seed))
    return FreqFusionPipeline(experts, fusion, scale,
                              expert_dtype()).to(device).eval()


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
                   if p.suffix.lower() in IMAGE_SUFFIXES)
    dtype = str(pipeline.expert_dtype or torch.float32).replace("torch.", "")
    print(f"FreqFusionSR (PyTorch, {device}, experts in {dtype}): "
          f"{len(files)} images")
    seconds, skipped = {}, []
    for i, path in enumerate(files):
        t0 = time.perf_counter()
        try:
            img = read_image(str(path))
        except (OSError, ValueError) as e:
            skipped.append(path.name)
            print(f"  ! [{i + 1}/{len(files)}] {path.name} skipped: {e}")
            continue
        lr = torch.from_numpy(img).permute(2, 0, 1)[None]
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
    print(f"  served {len(seconds)} images, skipped {len(skipped)}"
          + (f": {', '.join(skipped)}" if skipped else ""))
    return seconds

