"""Image files <-> float32 HWC RGB in [0, 1], with zlib and numpy only.

Counterpart of ``freqfusion_tpu/utils/image_io.py``, which uses cv2 or
PIL; PNG and BMP need neither here. ``read_image`` reads what the JAX
interface serves: non-interlaced 8-bit gray, gray+alpha, RGB and RGBA
PNGs (alpha dropped, gray replicated) with all five scanline filters;
uncompressed 24-bit BMPs, bottom-up or top-down; and JPEGs through PIL
where PIL imports (else it raises ``ValueError``). ``write_image`` writes
8-bit RGB PNGs with filter 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["read_image", "write_image", "IMAGE_SUFFIXES"]

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp")

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # PNG colour type -> samples/pixel


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    out = bytearray(h * stride)
    prev = bytearray(stride)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = bytearray(raw[pos + 1: pos + 1 + stride])
        pos += 1 + stride
        if ftype == 1:      # Sub
            for i in range(bpp, stride):
                line[i] = (line[i] + line[i - bpp]) & 0xFF
        elif ftype == 2:    # Up
            line = bytearray((a + b) & 0xFF for a, b in zip(line, prev))
        elif ftype == 3:    # Average
            for i in range(stride):
                left = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:    # Paeth
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (line[i] + pred) & 0xFF
        elif ftype != 0:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y * stride:(y + 1) * stride] = line
        prev = line
    return np.frombuffer(bytes(out), np.uint8).reshape(h, w, bpp)


def _read_png(path: str, data: bytes) -> np.ndarray:
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only non-interlaced 8-bit gray/RGB(A) "
                         f"PNGs are supported (depth {depth}, colour type "
                         f"{color}, interlace {interlace})")
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[color])
    return np.repeat(px[..., :1], 3, -1) if color in (0, 4) else px[..., :3]


def _read_bmp(path: str, data: bytes) -> np.ndarray:
    """Uncompressed 24-bit BMP: BGR rows padded to 4 bytes, bottom-up for
    a positive height, top-down for a negative one."""
    offset, dib = struct.unpack_from("<II", data, 10)
    if dib < 40:
        raise ValueError(f"{path}: BMP header of {dib} bytes is not "
                         "supported")
    w, h, _, bits, compression = struct.unpack_from("<iiHHI", data, 18)
    if bits != 24 or compression != 0 or w <= 0 or h == 0:
        raise ValueError(f"{path}: only uncompressed 24-bit BMPs are "
                         f"supported ({bits} bits, compression "
                         f"{compression}, {w}x{h})")
    stride = (3 * w + 3) // 4 * 4
    rows = np.frombuffer(data, np.uint8, abs(h) * stride, offset)
    px = rows.reshape(abs(h), stride)[:, :3 * w].reshape(abs(h), w, 3)
    return px[::-1 if h > 0 else 1, :, ::-1]


def _read_jpeg(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError(f"{path}: no JPEG decoder (PIL does not import: "
                         f"{e})") from None
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def read_image(path: str) -> np.ndarray:
    """Read a PNG, BMP or JPEG file -> float32 [H, W, 3] RGB in [0, 1].
    Raises ``ValueError`` (or ``OSError``) on a file it cannot decode."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _SIGNATURE:
        px = _read_png(path, data)
    elif data[:2] == b"BM":
        px = _read_bmp(path, data)
    elif data[:3] == b"\xff\xd8\xff":
        px = _read_jpeg(path)
    else:
        raise ValueError(f"{path}: not a PNG, BMP or JPEG file")
    return px.astype(np.float32) / 255.0


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_image(path: str, img: np.ndarray) -> None:
    """Write float [H, W, 3] RGB in [0, 1] (or uint8) as an 8-bit RGB PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * 3)], 1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
