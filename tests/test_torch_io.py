"""The port's NTIRE entry point on the CPU: checkpoint loading by the
reference file names (container unwrapping, 'module.' prefixes, dropped
buffers, a bare NAFNet checkpoint), missing experts, PNG in and out."""

import numpy as np
import pytest
import torch

from freqfusion_tpu_torch.interface.io import (
    load_pipeline, load_state_dict_file, main)
from freqfusion_tpu_torch.models.nafnet import NAFNetSR
from freqfusion_tpu_torch.utils.image_io import read_image, write_image


def test_load_state_dict_file_unwraps_and_drops_buffers(tmp_path):
    sd = {"module.conv_first.weight": torch.ones(2),
          "module.layers.0.swin1.attn.relative_position_index": torch.ones(2),
          "module.layers.0.blocks.0.attn.table_w": torch.ones(2),
          "module.mean": torch.ones(3)}
    torch.save({"params_ema": sd}, tmp_path / "x.pth")
    assert list(load_state_dict_file(tmp_path / "x.pth")) == [
        "conv_first.weight"]


def test_main_serves_pngs_on_cpu(tmp_path):
    model_dir, in_dir, out_dir = (tmp_path / d for d in ("m", "in", "out"))
    model_dir.mkdir()
    in_dir.mkdir()
    naf = NAFNetSR(generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for blk in naf.modules():
            if hasattr(blk, "beta"):
                blk.beta.normal_(0, 0.1)
                blk.gamma.normal_(0, 0.1)
    torch.save({"params": {f"module.{k}": v for k, v in
                           naf.nafnet.state_dict().items()}},
               model_dir / "NAFNet-SIDD-width64.pth")
    rng = np.random.default_rng(0)
    for name, (h, w) in {"a": (16, 16), "b": (13, 18)}.items():
        write_image(str(in_dir / f"{name}.png"),
                    rng.uniform(0, 1, (h, w, 3)).astype(np.float32))

    seconds = main(str(model_dir), str(in_dir), str(out_dir), device="cpu")
    assert sorted(seconds) == ["a.png", "b.png"]

    pipe = load_pipeline(str(model_dir), "cpu", verbose=False)
    assert set(pipe.experts) == {"nafnet"}
    for p in pipe.experts["nafnet"].state_dict():
        torch.testing.assert_close(pipe.experts["nafnet"].state_dict()[p],
                                   naf.state_dict()[p])
    for name in ("a", "b"):
        lr = read_image(str(in_dir / f"{name}.png"))
        with torch.no_grad():
            sr = pipe(torch.from_numpy(lr).permute(2, 0, 1)[None])
        sr = sr[0].permute(1, 2, 0).numpy()
        got = read_image(str(out_dir / f"{name}.png"))
        assert got.shape == (4 * lr.shape[0], 4 * lr.shape[1], 3)
        np.testing.assert_allclose(got, np.round(sr * 255) / 255, atol=1e-6)


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_pipeline(str(tmp_path))
