"""The port's NTIRE interface on what the JAX interface also takes:
checkpoints of another geometry (DRCT's and MambaIR's sniffed from tensor
shapes), checkpoints that do not load (degraded with the JAX interface's
messages), and BMP and JPEG inputs besides PNG, with every file that
cannot be decoded named and counted."""

import struct
import sys
import zlib

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


def _png_filter(line: np.ndarray, prev: np.ndarray, bpp: int,
                ftype: int) -> np.ndarray:
    """PNG scanline filter `ftype` of one row of bytes (int arrays)."""
    left = np.concatenate([np.zeros(bpp, int), line[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, int), prev[:-bpp]])
    if ftype == 1:
        pred = left
    elif ftype == 2:
        pred = prev
    elif ftype == 3:
        pred = (left + prev) // 2
    elif ftype == 4:
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prev, upleft))
    else:
        pred = 0
    return (line - pred) & 0xFF


def _png_rows(px: np.ndarray, depth: int, first_filter: int) -> bytes:
    """Samples [h, w, ch] packed at `depth` bits (16-bit big-endian), each
    row filtered (types cycling from `first_filter`)."""
    h, w, ch = px.shape
    if depth == 16:
        rows = px.astype(">u2").view(np.uint8).reshape(h, 2 * w * ch)
    elif depth == 8:
        rows = px.astype(np.uint8).reshape(h, w * ch)
    else:
        bits = ((px[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1)
        rows = np.packbits(bits.reshape(h, w * depth).astype(np.uint8), 1)
    bpp = max(1, depth * ch // 8)
    out, prev = bytearray(), np.zeros(rows.shape[1], int)
    for y, line in enumerate(rows.astype(int)):
        ftype = (first_filter + y) % 5
        out += bytes([ftype]) + _png_filter(line, prev, bpp,
                                            ftype).astype(np.uint8).tobytes()
        prev = line
    return bytes(out)


def _write_png(path, px: np.ndarray, depth: int, color: int,
               interlace: bool = False, palette=None) -> None:
    """A PNG of samples px [h, w, ch] (ch of the colour type), written
    here, since neither cv2 nor PIL writes Adam7 or 2/4-bit gray; Adam7's
    seven passes are filtered each on its own."""
    h, w, _ = px.shape
    if interlace:
        data = b"".join(
            _png_rows(px[y0::dy, x0::dx], depth, i)
            for i, (x0, y0, dx, dy) in enumerate(
                ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                 (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)))
            if x0 < w and y0 < h)
    else:
        data = _png_rows(px, depth, 0)

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                           0, 0, int(interlace))))
        if palette is not None:
            f.write(chunk(b"PLTE", palette.astype(np.uint8).tobytes()))
        f.write(chunk(b"IDAT", zlib.compress(data, 9)))
        f.write(chunk(b"IEND", b""))


def _write_bmp_bits(path, px: np.ndarray, bits: int, palette=None,
                    top_down: bool = False, masks=None) -> None:
    """A BMP of `bits` bits a pixel: px [h, w] palette indices (1/4/8
    bits, `palette` [n, 3] RGB) or [h, w, 4] bytes in file order (32
    bits; `masks` (r, g, b) for BI_BITFIELDS, else BI_RGB)."""
    h, w = px.shape[:2]
    stride = (bits * w + 31) // 32 * 4
    if bits == 32:
        rows = px.astype(np.uint8).reshape(h, 4 * w)
    else:
        b = (px[..., None] >> np.arange(bits - 1, -1, -1)) & 1
        rows = np.packbits(b.reshape(h, w * bits).astype(np.uint8), 1)
    body = np.zeros((h, stride), np.uint8)
    body[:, :rows.shape[1]] = rows
    body = (body if top_down else body[::-1]).tobytes()
    extra = b""
    if palette is not None:
        quad = np.zeros((len(palette), 4), np.uint8)
        quad[:, :3] = palette[:, ::-1]
        extra = quad.tobytes()
    elif masks is not None:
        extra = struct.pack("<III", *masks)
    offset = 54 + len(extra)
    with open(path, "wb") as f:
        f.write(struct.pack("<2sIHHI", b"BM", offset + len(body), 0, 0,
                            offset))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1,
                            bits, 3 if masks else 0, len(body), 2835, 2835,
                            0 if palette is None else len(palette), 0))
        f.write(extra + body)


def _write_kind(path_dir, kind: str):
    """A 13 x 19 image file of `kind` (odd width: sub-byte rows end
    mid-byte, BMP rows are padded), written by cv2, PIL or the writers
    above. Returns its path."""
    cv2 = pytest.importorskip("cv2")
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(sum(map(ord, kind)))
    h, w = 13, 19
    rgb = _smooth(h, w, 7)
    u16 = rng.integers(0, 1 << 16, (h, w, 4)).astype(np.uint16)
    pal = rng.integers(0, 256, (16, 3))
    ext = "bmp" if kind.startswith("bmp") else "png"
    path = path_dir / f"{kind}.{ext}"
    if kind == "png_palette8":         # PIL: colour type 3, 8 bits
        Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                     colors=200).save(path)
    elif kind == "png_palette4":       # PIL: colour type 3, 4 bits
        Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                     colors=16).save(path, bits=4)
    elif kind == "png_gray16":         # cv2: 16-bit gray
        cv2.imwrite(str(path), u16[..., 0])
    elif kind == "png_rgb16":          # cv2: 16-bit BGR
        cv2.imwrite(str(path), u16[..., :3])
    elif kind == "png_rgba16":         # cv2: 16-bit BGRA, alpha dropped
        cv2.imwrite(str(path), u16)
    elif kind == "png_gray1":          # PIL: mode "1"
        Image.fromarray(rgb[..., 0] > 128).save(path)
    elif kind in ("png_gray2", "png_gray4"):
        depth = int(kind[-1])
        _write_png(path, rng.integers(0, 1 << depth, (h, w, 1)), depth, 0)
    elif kind == "png_gray_alpha16":
        _write_png(path, u16[..., :2], 16, 4)
    elif kind == "png_adam7_rgb8":
        _write_png(path, rgb, 8, 2, interlace=True)
    elif kind == "png_adam7_gray2":
        _write_png(path, rng.integers(0, 4, (h, w, 1)), 2, 0,
                   interlace=True)
    elif kind == "png_adam7_palette4":
        _write_png(path, rng.integers(0, 16, (h, w, 1)), 4, 3,
                   interlace=True, palette=pal)
    elif kind == "png_adam7_rgba16":
        _write_png(path, u16, 16, 6, interlace=True)
    elif kind == "bmp_palette8":       # PIL: 8-bit palette
        Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                     colors=200).save(path)
    elif kind == "bmp_gray8":          # PIL: "L" as an 8-bit palette
        Image.fromarray(rgb[..., 1]).save(path)
    elif kind == "bmp_bits1":          # PIL: mode "1"
        Image.fromarray(rgb[..., 0] > 128).save(path)
    elif kind == "bmp_bits4":
        _write_bmp_bits(path, rng.integers(0, 16, (h, w)), 4, palette=pal)
    elif kind == "bmp_bits4_top_down":
        _write_bmp_bits(path, rng.integers(0, 16, (h, w)), 4, palette=pal,
                        top_down=True)
    elif kind == "bmp_bgra32_bitfields":  # cv2: compression 3
        cv2.imwrite(str(path), u16.astype(np.uint8))
    elif kind == "bmp_rgba32":         # PIL: BI_RGB
        Image.fromarray(u16.astype(np.uint8), "RGBA").save(path)
    elif kind == "bmp_bgrx32_top_down":
        _write_bmp_bits(path, u16.astype(np.uint8), 32, top_down=True)
    else:
        raise AssertionError(kind)
    return path


IMAGE_KINDS = ["png_palette8", "png_palette4", "png_gray16", "png_rgb16",
               "png_rgba16", "png_gray1", "png_gray2", "png_gray4",
               "png_gray_alpha16", "png_adam7_rgb8", "png_adam7_gray2",
               "png_adam7_palette4", "png_adam7_rgba16", "bmp_palette8",
               "bmp_gray8", "bmp_bits1", "bmp_bits4", "bmp_bits4_top_down",
               "bmp_bgra32_bitfields", "bmp_rgba32", "bmp_bgrx32_top_down"]


@pytest.mark.parametrize("kind", IMAGE_KINDS)
def test_image_kinds_read_as_the_jax_reader(tmp_path, kind):
    """Every kind of file the JAX reader (cv2.imread, IMREAD_COLOR)
    serves: palette, 16-bit, 1/2/4-bit gray and Adam7-interlaced PNGs
    (every filter type, in every pass), 1/4/8-bit palette and 32-bit
    BMPs. Bit-equal, with the file's own colours (not a flat image)."""
    path = _write_kind(tmp_path, kind)
    got = read_image(str(path))
    want = jax_read_image(str(path))
    assert got.shape == (13, 19, 3)
    np.testing.assert_array_equal(got, want)
    assert got.std() > 0.01


def _write_oriented(path_dir, orientation: int, suffix: str):
    """A 24 x 40 RGB image stored with an EXIF Orientation tag: a PNG's
    eXIf chunk or a JPEG's APP1 (quality 95), written by PIL."""
    Image = pytest.importorskip("PIL.Image")
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = path_dir / f"o{orientation}.{suffix}"
    Image.fromarray(_smooth(24, 40, orientation)).save(
        path, exif=exif, **({"quality": 95} if suffix == "jpg" else {}))
    return path


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("suffix", ["png", "jpg"])
def test_exif_orientation_reads_as_the_jax_reader(tmp_path, orientation,
                                                  suffix):
    """The JAX reader (cv2.imread) turns a file by its EXIF Orientation:
    2 mirror, 3 rotate 180, 4 flip, 5 transpose, 6 rotate 90 clockwise, 7
    transverse, 8 rotate 90 anticlockwise. Bit-equal, 5-8 in the turned
    geometry."""
    path = _write_oriented(tmp_path, orientation, suffix)
    got = read_image(str(path))
    assert got.shape == ((24, 40, 3) if orientation < 5 else (40, 24, 3))
    np.testing.assert_array_equal(got, jax_read_image(str(path)))


def test_cmyk_jpeg_reads_as_the_jax_reader(tmp_path):
    """A CMYK JPEG (PIL, quality 95, Adobe marker): converted by cv2's
    integer rule, not PIL's, so bit-equal."""
    Image = pytest.importorskip("PIL.Image")
    path = tmp_path / "cmyk.jpg"
    Image.fromarray(_smooth(24, 40, 9)).convert("CMYK").save(path,
                                                             quality=95)
    got = read_image(str(path))
    assert got.shape == (24, 40, 3) and got.std() > 0.01
    np.testing.assert_array_equal(got, jax_read_image(str(path)))


def test_main_serves_the_other_kinds(tmp_path, capsys):
    """io.main serves a 16-bit PNG, an Adam7 palette PNG, a bit-field
    32-bit BMP and a 24 x 40 PNG with EXIF Orientation 6 (served 40 x 24,
    turned) (no checkpoints: bilinear experts, seeded random fusion net),
    none skipped."""
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    kinds = ("png_rgb16", "png_adam7_palette4", "bmp_bgra32_bitfields")
    for kind in kinds:
        _write_kind(in_dir, kind)
    _write_oriented(in_dir, 6, "png")
    seconds = main(str(tmp_path / "models"), str(in_dir), str(out_dir),
                   device="cpu")
    out = capsys.readouterr().out
    assert sorted(seconds) == sorted(
        [f"{k}.{'bmp' if k.startswith('bmp') else 'png'}" for k in kinds]
        + ["o6.png"])
    assert "skipped 0" in out
    for kind in kinds:
        sr = read_image(str(out_dir / f"{kind}.png"))
        assert sr.shape == (52, 76, 3) and np.isfinite(sr).all()
    sr = read_image(str(out_dir / "o6.png"))
    assert sr.shape == (160, 96, 3) and np.isfinite(sr).all()


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
