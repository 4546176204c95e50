"""The port's NTIRE interface on what the JAX interface also takes:
checkpoints of another geometry (DRCT's and MambaIR's sniffed from tensor
shapes), checkpoints that do not load (degraded with the JAX interface's
messages), and BMP and JPEG inputs besides PNG, with every file that
cannot be decoded named and counted."""

import struct
import sys

import numpy as np
import pytest
import torch

from freqfusion_tpu.convert.drct import sniff_drct_config as jax_sniff_drct
from freqfusion_tpu.convert.mambair import (
    sniff_mambair_config as jax_sniff_mambair)
from freqfusion_tpu.utils.image_io import read_image as jax_read_image
from freqfusion_tpu_torch.convert.drct import sniff_drct_config
from freqfusion_tpu_torch.convert.mambair import sniff_mambair_config
from freqfusion_tpu_torch.interface.io import _TORCH_FILES, load_pipeline, main
from freqfusion_tpu_torch.models.drct import DRCT
from freqfusion_tpu_torch.models.mambair import MambaIR
from freqfusion_tpu_torch.utils.image_io import read_image, write_image

# geometries other than the challenge's (embed 180, 12 layers, window 16,
# gc 32; depths (6,) * 6)
EXPERTS = {
    "drct": (DRCT, dict(embed_dim=60, num_layers=2, window_size=8, gc=16,
                        mlp_ratio=2.0)),
    "mamba": (MambaIR, dict(embed_dim=60, depths=(2, 2))),
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Seeded port experts of the geometries above, saved under the
    reference file names; returns (dir, {name: model})."""
    root = tmp_path_factory.mktemp("models")
    models = {}
    for i, (name, (cls, cfg)) in enumerate(EXPERTS.items()):
        models[name] = cls(**cfg, generator=torch.Generator().manual_seed(i))
        torch.save({"params": models[name].state_dict()},
                   root / _TORCH_FILES[name])
    return root, models


def _lr(h=8, w=12, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (1, 3, h, w)).astype(np.float32))


@pytest.mark.parametrize("name", sorted(EXPERTS))
def test_sniffers_match_jax(checkpoints, name):
    sniff, jax_sniff = {"drct": (sniff_drct_config, jax_sniff_drct),
                        "mamba": (sniff_mambair_config, jax_sniff_mambair)
                        }[name]
    sd = checkpoints[1][name].state_dict()
    got = sniff(sd)
    assert got == jax_sniff({k: v.numpy() for k, v in sd.items()})
    assert {k: got[k] for k in EXPERTS[name][1]} == EXPERTS[name][1]


def test_load_pipeline_loads_other_geometries(checkpoints, capsys):
    """Each loaded expert reproduces its saved model exactly (same
    weights, same code, same CPU) on a 16x16 LR, a multiple of DRCT's
    window as the pipeline's pad to 16 makes it."""
    root, models = checkpoints
    pipe = load_pipeline(str(root), "cpu")
    assert "loaded drct" in capsys.readouterr().out
    assert sorted(pipe.experts) == ["drct", "mamba"]
    lr = _lr(16, 16)
    with torch.no_grad():
        for name, model in models.items():
            for got, want in zip(pipe.experts[name](lr), model.eval()(lr)):
                torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)


@pytest.mark.parametrize("name,key", [
    ("drct", "conv_last.bias"),
    ("drct", "conv_first.weight"),     # the sniffer's key: sniff fails too
    ("mamba", "layers.1.conv.weight"),
    ("fusion", "edge_enhance.edge_gate.2.bias"),
])
def test_broken_checkpoint_degrades(checkpoints, tmp_path, capsys, name,
                                    key):
    """A state dict with one key removed degrades with the JAX interface's
    message; its output equals that of the same directory without the
    file (exactly: the same modules run on the same weights)."""
    root, models = checkpoints
    broken, missing = tmp_path / "broken", tmp_path / "missing"
    broken.mkdir()
    missing.mkdir()
    if name == "fusion":
        from freqfusion_tpu_torch.models.fusion.fusion_v2 import (
            CompleteEnhancedFusionSR)
        sd = CompleteEnhancedFusionSR(
            generator=torch.Generator().manual_seed(5)).state_dict()
    else:
        sd = models[name].state_dict()
    assert key in sd
    torch.save({k: v for k, v in sd.items() if k != key},
               broken / _TORCH_FILES[name])
    pipe = load_pipeline(str(broken), "cpu", verbose=False)
    out = capsys.readouterr().out
    assert f"  ! {name} conversion failed: " in out
    assert (f"  ! {name} config sniff failed" in out) == (
        key == "conv_first.weight")
    want = load_pipeline(str(missing), "cpu", verbose=False)
    assert name not in pipe.experts
    lr = _lr(seed=1)
    with torch.no_grad():
        torch.testing.assert_close(pipe(lr), want(lr), atol=0.0, rtol=0.0)


def _write_bmp(path, img: np.ndarray, top_down: bool) -> None:
    """uint8 [H, W, 3] RGB as an uncompressed 24-bit BMP (BGR rows padded
    to 4 bytes; bottom-up unless `top_down`, whose height is negative)."""
    h, w, _ = img.shape
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = img[..., ::-1].reshape(h, 3 * w)
    body = (rows if top_down else rows[::-1]).tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<2sIHHI", b"BM", 54 + len(body), 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1,
                            24, 0, len(body), 2835, 2835, 0, 0))
        f.write(body)


def _smooth(h, w, seed):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.integers(-3, 4, (h, w, 3)), axis=1) + 128
    return np.clip(base, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_reads_as_the_jax_reader(tmp_path, top_down):
    """Width 18: 54 bytes a row, padded to 56. Bit-equal."""
    img = _smooth(13, 18, 3)
    path = tmp_path / "x.bmp"
    _write_bmp(path, img, top_down)
    got = read_image(str(path))
    np.testing.assert_array_equal(got, jax_read_image(str(path)))
    np.testing.assert_array_equal(got, img.astype(np.float32) / 255.0)


def test_jpeg_reads_as_the_jax_reader(tmp_path):
    """Both decode with libjpeg's default (islow) IDCT: bit-equal."""
    Image = pytest.importorskip("PIL.Image")
    path = tmp_path / "x.jpg"
    Image.fromarray(_smooth(40, 56, 4)).save(path, quality=90)
    np.testing.assert_array_equal(read_image(str(path)),
                                  jax_read_image(str(path)))


@pytest.mark.parametrize("pil", [True, False])
def test_main_serves_png_bmp_jpeg(tmp_path, monkeypatch, capsys, pil):
    """No checkpoints (bilinear experts, seeded random fusion net): a PNG,
    a BMP copy of it (the same output) and a JPEG, which is served when
    PIL imports and named and counted as skipped when it does not."""
    Image = pytest.importorskip("PIL.Image")
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    img = _smooth(8, 12, 6)
    write_image(str(in_dir / "a.png"), img)
    _write_bmp(in_dir / "b.bmp", img, top_down=False)
    Image.fromarray(img).save(in_dir / "c.jpg", quality=90)
    (in_dir / "notes.txt").write_text("not an image")
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)
    seconds = main(str(tmp_path / "models"), str(in_dir), str(out_dir),
                   device="cpu")
    out = capsys.readouterr().out
    served = ["a.png", "b.bmp"] + (["c.jpg"] if pil else [])
    assert sorted(seconds) == served
    assert sorted(p.name for p in out_dir.iterdir()) == [
        f"{n[0]}.png" for n in served]
    np.testing.assert_array_equal(read_image(str(out_dir / "a.png")),
                                  read_image(str(out_dir / "b.png")))
    if pil:
        assert "skipped 0" in out
    else:
        assert "c.jpg skipped: " in out and "no JPEG decoder" in out
        assert "served 2 images, skipped 1: c.jpg" in out
