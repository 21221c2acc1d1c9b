"""Sample clips as uncompressed AVI files, with no OpenCV.

The JAX package writes each sampled clip with OpenCV's MJPG writer
(``hpvaegan_tpu/utils/saver.py:186-203``).  The machine with the card has
no OpenCV, so the port writes the AVI container itself: RIFF ``AVI `` with
``hdrl`` (``avih``, one ``strl`` holding a ``vids`` stream header and a
``BITMAPINFOHEADER``), ``movi`` with one ``00db`` chunk a frame, and an
``idx1`` index.  A frame is an uncompressed ``BI_RGB`` 24-bit DIB: BGR
pixels, each row padded to 4 bytes, rows top-down (a negative
``biHeight``: the FFmpeg that OpenCV 5.0's wheel bundles crashes reading
bottom-up raw frames).  Why uncompressed:

* any player, ffmpeg and OpenCV read it, and it stays a ``.avi`` as the
  JAX package writes;
* it is lossless, so a test compares the frames exactly (MJPG would not
  be);
* a top-scale clip (13 x 144 x 256 x 3) is 1.44 MB.

The pixels follow the JAX de-normalisation exactly: ``np.uint8((x + 1.0)
* 127.5)`` on the float32 sample, a truncating cast with no clip and no
rounding (``saver.py:194-195``).  The frame rate is stored as the
fraction ``dwRate / dwScale`` and as ``dwMicroSecPerFrame``.

``read_avi`` reads back what ``write_avi`` wrote (the checks that run
where OpenCV is missing use it).
"""
from __future__ import annotations

import struct
from fractions import Fraction
from typing import Tuple

import numpy as np

__all__ = ["to_uint8", "write_avi", "read_avi"]

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def to_uint8(clip: np.ndarray) -> np.ndarray:
    """[-1, 1] float samples -> uint8 RGB, as the JAX writer converts."""
    return np.uint8((np.asarray(clip) + 1.0) * 127.5)


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\0" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(kind: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body


def write_avi(clip: np.ndarray, path: str, fps: float) -> None:
    """Write ``clip``, (T, H, W, 3) float in [-1, 1] (RGB), as an
    uncompressed AVI at ``fps`` frames a second."""
    frames = to_uint8(clip)
    t, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"expected RGB frames, got {c} channels")
    stride = (3 * w + 3) & ~3
    dib = np.zeros((t, h, stride), np.uint8)
    dib[:, :, :3 * w] = frames[..., ::-1].reshape(t, h, 3 * w)   # BGR
    frame_bytes = h * stride
    rate = Fraction(float(fps)).limit_denominator(10000)
    if rate <= 0:
        raise ValueError(f"fps must be positive, got {fps}")

    avih = struct.pack(
        "<14I", int(round(1e6 / float(rate))),
        int(frame_bytes * float(rate)) + 1, 0, _AVIF_HASINDEX, t, 0, 1,
        frame_bytes, w, h, 0, 0, 0, 0)
    # fccType, fccHandler, flags, priority, language, initial frames,
    # scale, rate, start, length, buffer size, quality (-1: default),
    # sample size, frame rectangle
    strh = struct.pack(
        "<4s4sIHH6IiI4h", b"vids", b"DIB ", 0, 0, 0, 0, rate.denominator,
        rate.numerator, 0, t, frame_bytes, -1, 0, 0, 0, w, h)
    # a negative height: rows top-down
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, frame_bytes, 0,
                       0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))

    head = struct.pack("<4sI", b"00db", frame_bytes)
    movi_body = b"".join(head + dib[i].tobytes() for i in range(t))
    movi = _list(b"movi", movi_body)
    # offsets from the 'movi' fourcc to each chunk's header
    chunk = 8 + frame_bytes
    idx1 = _chunk(b"idx1", b"".join(
        struct.pack("<4sIII", b"00db", _AVIIF_KEYFRAME, 4 + i * chunk,
                    frame_bytes) for i in range(t)))
    body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def _walk(data: bytes, start: int, end: int):
    """(fourcc, list kind or None, payload start, payload end) of each
    chunk in data[start:end]."""
    pos = start
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        if fourcc in (b"LIST", b"RIFF"):
            yield fourcc, data[pos + 8:pos + 12], pos + 12, pos + 8 + size
        else:
            yield fourcc, None, pos + 8, pos + 8 + size
        pos += 8 + size + (size & 1)


def read_avi(path: str) -> Tuple[np.ndarray, float]:
    """(frames (T, H, W, 3) uint8 RGB, fps) of an AVI that ``write_avi``
    wrote (uncompressed 24-bit DIB frames)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path} is not an AVI file")
    w = h = None
    fps = None
    frames = []

    def visit(start, end):
        nonlocal w, h, fps
        for fourcc, kind, a, b in _walk(data, start, end):
            if kind is not None:
                visit(a, b)
            elif fourcc == b"strh":
                scale, rate = struct.unpack_from("<II", data, a + 20)
                fps = rate / scale
            elif fourcc == b"strf":
                _, w, h, _, bits, comp = struct.unpack_from("<IiiHHI",
                                                            data, a)
                if bits != 24 or comp != 0:
                    raise ValueError(f"{path}: not an uncompressed "
                                     f"24-bit AVI")
            elif fourcc == b"00db":
                frames.append((a, b))

    visit(12, len(data))
    if w is None or fps is None:
        raise ValueError(f"{path} has no video stream header")
    stride = (3 * w + 3) & ~3
    out = np.empty((len(frames), abs(h), w, 3), np.uint8)
    for i, (a, b) in enumerate(frames):
        rows = np.frombuffer(data, np.uint8, abs(h) * stride, a).reshape(
            abs(h), stride)[:, :3 * w].reshape(abs(h), w, 3)
        if h > 0:   # a positive height: rows bottom-up
            rows = rows[::-1]
        out[i] = rows[:, :, ::-1]
    return out, fps
