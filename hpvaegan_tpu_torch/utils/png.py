"""PNG on ``zlib`` and numpy: the port's image reader and writer.

The machine with the card has no dependable image library (PIL, imageio,
OpenCV), so the port reads and writes PNG itself:

* ``read_png``: 8-bit gray, RGB or RGBA, non-interlaced, every filter
  type (None, Sub, Up, Average, Paeth), returned as imageio returns them,
  (H, W) for gray and (H, W, C) otherwise, uint8; anything else raises
  ``ValueError`` naming what it found;
* ``encode_png``: (H, W, C) uint8, C in 1, 3, 4, every row under one
  filter type (``filter_type``, None by default).

Other image formats go through the frames file: ``python -m
hpvaegan_tpu_torch.tools.decode_frames <image>`` decodes the image once,
where OpenCV exists (``data/image.py`` reads what it wrote).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["PNG_SIGNATURE", "is_png", "read_png", "encode_png"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

_CHANNELS = {0: 1, 2: 3, 6: 4}     # colour type -> channels read here
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray + alpha",
                6: "RGBA"}


def is_png(path: str) -> bool:
    """Does the file at ``path`` start with the PNG signature?"""
    with open(path, "rb") as f:
        return f.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int arrays ``a`` (left), ``b`` (up), ``c``
    (up-left)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """(h, stride) uint8 rows from the filtered scanlines ``raw``."""
    rows = raw.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.int64)
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:    # Sub: a running sum along each channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif kind == 2:    # Up
            cur = (line + prior) & 255
        elif kind in (3, 4):   # Average, Paeth: pixel after pixel
            cur = line.copy()
            left = np.zeros(bpp, np.int64)
            up_left = np.zeros(bpp, np.int64)
            for x in range(0, stride, bpp):
                up = prior[x:x + bpp]
                pred = ((left + up) >> 1 if kind == 3
                        else _paeth(left, up, up_left))
                left = (line[x:x + bpp] + pred) & 255
                cur[x:x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"unknown PNG filter type {kind} in row {y}")
        out[y] = cur
        prior = cur
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """The image at ``path``: (H, W) uint8 gray, or (H, W, 3 | 4)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(
            f"{path}: {depth}-bit {_COLOR_NAMES.get(color, color)}"
            f"{', interlaced' if interlace else ''} PNG; the reader takes "
            f"8-bit gray, RGB or RGBA, not interlaced (decode other "
            f"images with `python -m hpvaegan_tpu_torch.tools.decode_frames "
            f"{path}`)")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, "
                         f"{h} rows of {w} x {c} need {h * (1 + w * c)}")
    img = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    return img[:, :, 0] if c == 1 else img


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter(rows: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """(h, stride) rows filtered with ``kind`` (0-4), as uint8."""
    x = rows.astype(np.int64)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    up_left = np.zeros_like(x)
    up_left[1:, bpp:] = x[:-1, :-bpp]
    pred = (0, left, up, (left + up) >> 1, _paeth(left, up, up_left))[kind]
    return ((x - pred) & 255).astype(np.uint8)


def encode_png(img: np.ndarray, filter_type: int = 0) -> bytes:
    """(H, W, C) uint8, C in 1, 3, 4 -> PNG bytes, every row filtered
    with ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    if filter_type not in range(5):
        raise ValueError(f"PNG filter type {filter_type} is not 0-4")
    rows = np.ascontiguousarray(img, np.uint8).reshape(h, w * c)
    raw = np.zeros((h, 1 + w * c), np.uint8)
    raw[:, 0] = filter_type
    raw[:, 1:] = _filter(rows, c, filter_type)
    return (PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))
