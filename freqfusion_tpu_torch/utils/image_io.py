"""Image files <-> float32 HWC RGB in [0, 1], with zlib and numpy only.

Counterpart of ``freqfusion_tpu/utils/image_io.py``, which decodes every
input with ``cv2.imread(..., IMREAD_COLOR)``; PNG and BMP need neither cv2
nor PIL here, and ``read_image`` gives the pixels cv2 gives:

- PNG: every colour type (gray, RGB, palette, gray+alpha, RGBA) at every
  bit depth, interlaced (Adam7) or not, all five scanline filters. Alpha
  and transparency are dropped, gray is replicated, gray of 1/2/4 bits is
  scaled to 0..255 (x 255, 85, 17) and 16-bit samples keep their high
  byte (``v >> 8``), as libpng's expand and strip_16 do for cv2.
- BMP: uncompressed 1/4/8-bit palette, 24-bit and 32-bit (``BI_RGB``, or
  ``BI_BITFIELDS`` with byte-wide masks from the header) images, bottom-up
  or top-down; the fourth byte of a 32-bit pixel is dropped.
- JPEG through PIL where PIL imports (else it raises ``ValueError``);
  a CMYK JPEG is converted with cv2's integer rule, not PIL's.
- EXIF orientation: a JPEG's (APP1) and a PNG's (``eXIf`` chunk)
  Orientation tag is applied, as cv2 applies it, so a rotated file is
  read in the geometry it is shown in.

``write_image`` writes 8-bit RGB PNGs with filter 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["read_image", "write_image", "IMAGE_SUFFIXES"]

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp")

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples a pixel, and the bit depths it allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7's seven passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(raw: bytes, pos: int, h: int, stride: int,
              bpp: int) -> "tuple[np.ndarray, int]":
    """Undo the scanline filters of `h` rows of `stride` bytes starting at
    raw[pos] (each row a filter byte, then its bytes); bpp is the bytes a
    pixel, at least 1. Returns the rows [h, stride] and the position after
    them."""
    out = bytearray(h * stride)
    prev = bytearray(stride)
    if pos + h * (1 + stride) > len(raw):
        raise ValueError("PNG image data is truncated")
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
    return np.frombuffer(bytes(out), np.uint8).reshape(h, stride), pos


def _samples(rows: np.ndarray, w: int, depth: int, channels: int
             ) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, w, channels]: 8-bit as
    they are, 16-bit as their high byte, 1/2/4-bit unpacked (most
    significant bits first) to values 0..2^depth - 1."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    if depth == 16:
        return rows[:, 0:2 * w * channels:2].reshape(h, w, channels)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits.reshape(h, w, depth) * weights).sum(-1, dtype=np.uint8)[
        ..., None]


def _exif_orientation(exif: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 in a TIFF-structured EXIF
    block (an optional ``Exif\\0\\0`` prefix skipped); 1 when it is absent
    or the block does not parse."""
    if exif.startswith(b"Exif\0\0"):
        exif = exif[6:]
    order = {b"II": "<", b"MM": ">"}.get(exif[:2])
    if order is None or len(exif) < 8:
        return 1
    ifd = struct.unpack_from(order + "I", exif, 4)[0]
    if ifd + 2 > len(exif):
        return 1
    count = struct.unpack_from(order + "H", exif, ifd)[0]
    for i in range(count):
        at = ifd + 2 + 12 * i
        if at + 12 > len(exif):
            break
        tag, kind = struct.unpack_from(order + "HH", exif, at)
        if tag == 0x0112 and kind == 3:   # SHORT, held in the value field
            return struct.unpack_from(order + "H", exif, at + 8)[0]
    return 1


def _orient(px: np.ndarray, orientation: int) -> np.ndarray:
    """[H, W, ...] as stored -> as shown under an EXIF Orientation."""
    turn = {2: lambda a: a[:, ::-1],                        # mirror
            3: lambda a: a[::-1, ::-1],                     # rotate 180
            4: lambda a: a[::-1],                           # flip
            5: lambda a: a.swapaxes(0, 1),                  # transpose
            6: lambda a: a[::-1].swapaxes(0, 1),            # 90 clockwise
            7: lambda a: a[::-1, ::-1].swapaxes(0, 1),      # transverse
            8: lambda a: a[:, ::-1].swapaxes(0, 1)}         # 90 anticlockwise
    return turn[orientation](px) if orientation in turn else px


def _read_png(path: str, data: bytes) -> np.ndarray:
    pos, idat, header, plte, orientation = 8, [], None, None, 1
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"eXIf":
            orientation = _exif_orientation(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth not in _DEPTHS.get(color, ()) or interlace > 1:
        raise ValueError(f"{path}: not a valid PNG (bit depth {depth}, "
                         f"colour type {color}, interlace {interlace})")
    if color == 3 and not plte:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    channels = _CHANNELS[color]
    bits = depth * channels                   # bits a pixel
    bpp = max(1, bits // 8)                   # the filters' pixel bytes
    raw = zlib.decompress(b"".join(idat))
    if interlace:
        px = np.zeros((h, w, channels), np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue  # an empty pass has no rows, not even filters
            rows, pos = _unfilter(raw, pos, ph, -(-pw * bits // 8), bpp)
            px[y0::dy, x0::dx] = _samples(rows, pw, depth, channels)
    else:
        rows, _ = _unfilter(raw, 0, h, -(-w * bits // 8), bpp)
        px = _samples(rows, w, depth, channels)
    if color == 3:
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte, np.uint8)[:768]
        pal[:len(entries) // 3] = entries[:len(entries) // 3 * 3].reshape(
            -1, 3)
        rgb = pal[px[..., 0]]
    elif color in (0, 4):
        gray = px[..., :1]
        if depth < 8:
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        rgb = np.repeat(gray, 3, -1)
    else:
        rgb = px[..., :3]
    return _orient(rgb, orientation)


def _mask_channel(px: np.ndarray, mask: int) -> np.ndarray:
    """A BI_BITFIELDS channel: the byte under `mask` (one of 0xFF << 8k)."""
    shift = (mask & -mask).bit_length() - 1
    return ((px >> np.uint32(shift)) & np.uint32(0xFF)).astype(np.uint8)


def _read_bmp(path: str, data: bytes) -> np.ndarray:
    """Uncompressed BMP: 1/4/8-bit palette indices, 24-bit BGR or 32-bit
    BGRX (or BI_BITFIELDS masks) pixels, rows padded to 4 bytes, bottom-up
    for a positive height, top-down for a negative one."""
    offset, dib = struct.unpack_from("<II", data, 10)
    if dib < 40:
        raise ValueError(f"{path}: BMP header of {dib} bytes is not "
                         "supported")
    w, h, _, bits, compression = struct.unpack_from("<iiHHI", data, 18)
    ok = (compression == 0 and bits in (1, 4, 8, 24, 32)) or (
        compression == 3 and bits == 32)
    if not ok or w <= 0 or h == 0:
        raise ValueError(f"{path}: only uncompressed 1/4/8/24/32-bit and "
                         f"bit-field 32-bit BMPs are supported ({bits} "
                         f"bits, compression {compression}, {w}x{h})")
    stride = (bits * w + 31) // 32 * 4
    rows = np.frombuffer(data, np.uint8, abs(h) * stride, offset).reshape(
        abs(h), stride)
    if bits <= 8:
        used = struct.unpack_from("<I", data, 46)[0] or 1 << bits
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(data, np.uint8, 4 * used, 14 + dib)
        pal[:used] = entries.reshape(used, 4)[:, 2::-1]
        idx = _samples(rows, w, bits, 1)[..., 0]
        px = pal[idx]
    elif bits == 24:
        px = rows[:, :3 * w].reshape(abs(h), w, 3)[..., ::-1]
    else:
        masks = (struct.unpack_from("<III", data, 54) if compression == 3
                 else (0xFF0000, 0xFF00, 0xFF))
        if any(m not in (0xFF, 0xFF00, 0xFF0000, 0xFF000000) for m in masks):
            raise ValueError(f"{path}: only byte-wide BMP bit-field masks "
                             f"are supported ({[hex(m) for m in masks]})")
        v = rows[:, :4 * w].copy().view("<u4")
        px = np.stack([_mask_channel(v, m) for m in masks], -1)
    return px[::-1] if h > 0 else px


def _read_jpeg(path: str) -> np.ndarray:
    """Through PIL, turned by its EXIF orientation; CMYK as cv2 converts
    it, in integers (k = 255 - K, each of R, G, B = k - C' k >> 8 with C'
    the decoded, inverted sample), not by PIL's conversion."""
    try:
        from PIL import Image, ImageOps
    except ImportError as e:
        raise ValueError(f"{path}: no JPEG decoder (PIL does not import: "
                         f"{e})") from None
    with Image.open(path) as img:
        img = ImageOps.exif_transpose(img)
        if img.mode != "CMYK":
            return np.asarray(img.convert("RGB"))
        raw = np.asarray(img).astype(np.int32)
    k = 255 - raw[..., 3:]
    return (k - ((raw[..., :3] * k) >> 8)).astype(np.uint8)


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
