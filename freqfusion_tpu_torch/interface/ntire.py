"""NTIRE test harness of the port: the counterpart of the JAX repo's
``test.py``.

    python -m freqfusion_tpu_torch.interface.ntire --test_dir LR_DIR \
        [--valid_dir LR_DIR] [--save_dir results] [--model_id 29] \
        [--device cuda|cpu]

Selects a team model by ID (29 = FreqFusionSR, served by
:func:`freqfusion_tpu_torch.interface.io.main` from
``model_zoo/team29_FreqFusionSR``), runs x4 SR over the valid and test
splits into ``<save_dir>/<model>/<split>``, prints each split's
"runtime (Including I/O)" (host clock around the whole split, outputs
written) and records it in ``results.json`` in the working directory,
under the keys ``<model>_valid_ms`` and ``<model>_test_ms``, as
``test.py`` does. ``--device`` defaults to the card (a run without one
raises); pass ``cpu`` to serve on the CPU. FREQFUSION_EXPERT_DTYPE=bf16
serves the experts in bf16. Model 0 (the DAT baseline) is not ported.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

__all__ = ["select_model", "run", "main"]


def select_model(model_id: int):
    """(entry point, model path, model name) of team `model_id`."""
    if model_id == 0:
        raise NotImplementedError(
            "Model 0 (the DAT baseline) is not ported to the PyTorch "
            "package yet.")
    if model_id == 29:
        from .io import main as freqfusion_sr
        return (freqfusion_sr, os.path.join("model_zoo", "team29_FreqFusionSR"),
                f"{model_id:02}_FreqFusionSR")
    raise NotImplementedError(f"Model {model_id} is not implemented.")


def run(model_func, model_name: str, model_path: str, args,
        mode: str = "test") -> float:
    """Serve one split; returns its milliseconds, I/O included."""
    data_path = args.valid_dir if mode == "valid" else args.test_dir
    if data_path is None:
        raise ValueError("specify the dataset path")
    save_path = os.path.join(args.save_dir, model_name, mode)
    os.makedirs(save_path, exist_ok=True)
    t0 = time.perf_counter()
    model_func(model_dir=model_path, input_path=data_path,
               output_path=save_path, device=args.device)
    ms = (time.perf_counter() - t0) * 1e3
    print(f"Model {model_name} runtime (Including I/O): {ms:.1f} ms")
    return ms


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("NTIRE2026-ImageSRx4")
    p.add_argument("--valid_dir", default=None, type=str)
    p.add_argument("--test_dir", default=None, type=str)
    p.add_argument("--save_dir", default="results", type=str)
    p.add_argument("--model_id", default=29, type=int)
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: the card; 'cpu' serves on "
                        "the CPU)")
    return p


def main(argv=None) -> dict:
    """Run the CLI on `argv` (sys.argv[1:] when None); returns the
    results written to results.json."""
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    logger = logging.getLogger("NTIRE2026-ImageSRx4")

    model_func, model_path, model_name = select_model(args.model_id)
    logger.info(model_name)

    results = {}
    json_path = os.path.join(os.getcwd(), "results.json")
    if os.path.exists(json_path):
        with open(json_path) as f:
            results = json.load(f)
    if args.valid_dir is not None:
        results[f"{model_name}_valid_ms"] = run(
            model_func, model_name, model_path, args, mode="valid")
    if args.test_dir is not None:
        results[f"{model_name}_test_ms"] = run(
            model_func, model_name, model_path, args, mode="test")
    with open(json_path, "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
