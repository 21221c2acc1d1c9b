"""TensorBoard event files with no TensorBoard package.

The JAX package writes its summaries through tensorboardX
(``hpvaegan_tpu/utils/summaries.py:40-41``), and its clips as GIFs through
moviepy.  The machine with the card has neither, so the port writes the
event file format itself, from numpy and ``struct``:

* TFRecord framing: u64 length, masked CRC32C of the length, payload,
  masked CRC32C of the payload.  CRC32C runs table-driven in numpy over
  many lanes of the payload at once, whose sums are then chained with the
  operator that shifts a sum over a lane's length of zeros, so a
  megabyte-sized image costs milliseconds, not a Python loop per byte;
* ``Event`` protobufs encoded by hand: ``wall_time`` (1, double), ``step``
  (2, int64), ``file_version`` "brain.Event:2" (3) on the first record,
  ``summary`` (5).  A ``Summary.Value`` holds ``tag`` (1) and either
  ``simple_value`` (2, float) or ``image`` (4: height, width, colorspace,
  ``encoded_image_string``);
* images as PNG (``utils/png.py`` ``encode_png``, filter 0 rows);
* clips as animated GIF on a fixed 6 x 7 x 6 colour cube (each channel
  within 26/255 of the frame), LZW-coded with literal 9-bit codes only and
  a CLEAR code every 254 symbols, so the code width never grows and a
  frame packs into bits with numpy in one pass.

Tags are cleaned as tensorboardX's ``summary._clean_tag`` does, and the
file is named ``events.out.tfevents.<time>.<host>`` as tensorboardX names
it.  ``read_events`` reads such a file back, checking every CRC, where
TensorBoard is not installed.
"""
from __future__ import annotations

import math
import os
import re
import socket
import struct
import time

import numpy as np

from .png import encode_png

__all__ = ["crc32c", "masked_crc32c", "clean_tag", "encode_png",
           "encode_gif", "EventFileWriter", "read_events"]

_CRC32C_POLY = 0x82F63B78


def _crc_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_CRC32C_POLY), t >> 1)
    return t.astype(np.uint32)


_TABLE = _crc_table()
_TABLE_LIST = [int(v) for v in _TABLE]


def _advance(states: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The CRC registers ``states`` (one a lane) through ``rows`` (one
    row a byte position, one column a lane)."""
    for row in rows:
        states = _TABLE[(states ^ row) & 0xFF] ^ (states >> 8)
    return states


def _shift_tables(n: int):
    """Four 256-entry tables that apply, byte by byte, the linear map
    taking a register to itself advanced over ``n`` zero bytes."""
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    cols = _advance(basis, np.zeros((n, 32), np.uint8))
    v = np.arange(256)
    tables = []
    for b in range(4):
        tab = np.zeros(256, np.uint32)
        for bit in range(8):
            tab ^= np.where((v >> bit) & 1, cols[8 * b + bit], 0).astype(
                np.uint32)
        tables.append([int(x) for x in tab])
    return tables


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc = 0xFFFFFFFF
    n = len(data)
    lanes = int(math.isqrt(n))
    if lanes < 64:
        for byte in data:
            crc = _TABLE_LIST[(crc ^ byte) & 0xFF] ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF
    length = n // lanes
    head = n - lanes * length
    for byte in data[:head]:
        crc = _TABLE_LIST[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    block = np.frombuffer(data, np.uint8, lanes * length, head)
    # each lane's register from zero; the register is linear in
    # (start, bytes), so the sum of the whole is the lanes' sums chained
    # through the shift over one lane's length of zeros
    sums = _advance(np.zeros(lanes, np.uint32),
                    np.ascontiguousarray(block.reshape(lanes, length).T))
    t0, t1, t2, t3 = _shift_tables(length)
    for s in sums.tolist():
        crc = (t0[crc & 0xFF] ^ t1[(crc >> 8) & 0xFF]
               ^ t2[(crc >> 16) & 0xFF] ^ t3[crc >> 24] ^ s)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")


def clean_tag(name: str) -> str:
    """tensorboardX's ``summary._clean_tag``: characters outside
    ``[-/\\w.]`` become ``_``, leading slashes go."""
    return _INVALID_TAG_CHARACTERS.sub("_", name).lstrip("/")


# ---- protobuf wire format ----

def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1   # int64: two's complement in ten bytes
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(int(value))


def _image_value(tag: str, height: int, width: int, colorspace: int,
                 encoded: bytes) -> bytes:
    image = (_int_field(1, height) + _int_field(2, width)
             + _int_field(3, colorspace) + _bytes_field(4, encoded))
    return _bytes_field(1, clean_tag(tag).encode()) + _bytes_field(4, image)


def _scalar_value(tag: str, value: float) -> bytes:
    return (_bytes_field(1, clean_tag(tag).encode()) + _key(2, 5)
            + struct.pack("<f", float(value)))


# ---- image formats ----

_GIF_LEVELS = (6, 7, 6)          # the colour cube: R, G, B levels
_GIF_CLEAR, _GIF_END = 256, 257
_GIF_RUN = 254                   # literals between CLEAR codes


def _gif_palette() -> bytes:
    nr, ng, nb = _GIF_LEVELS
    i = np.arange(256)
    rgb = np.stack([i // (ng * nb), (i // nb) % ng, i % nb], axis=1)
    levels = np.asarray(_GIF_LEVELS) - 1
    pal = (rgb * 510 // levels + 1) // 2          # round(l * 255 / (n-1))
    pal[nr * ng * nb:] = 0
    return np.clip(pal, 0, 255).astype(np.uint8).tobytes()


def _gif_indices(frames: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8 -> colour-cube indices, each channel rounded to
    its nearest level."""
    v = frames.astype(np.int32)
    levels = np.asarray(_GIF_LEVELS, np.int32) - 1
    q = (v * levels * 2 + 255) // 510
    nr, ng, nb = _GIF_LEVELS
    return (q[..., 0] * ng * nb + q[..., 1] * nb + q[..., 2]).astype(
        np.uint16)


def _lzw_literal(indices: np.ndarray) -> bytes:
    """GIF LZW data (minimum code size 8) of one frame's indices, as
    9-bit literals with a CLEAR every ``_GIF_RUN`` of them, then END."""
    flat = indices.reshape(-1)
    n = flat.size
    runs = -(-n // _GIF_RUN)
    codes = np.empty(runs + n + 1, np.uint16)
    i = np.arange(n)
    codes[i + i // _GIF_RUN + 1] = flat
    codes[np.arange(runs) * (_GIF_RUN + 1)] = _GIF_CLEAR
    codes[-1] = _GIF_END
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(
        np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        part = data[i:i + 255]
        out.append(len(part))
        out += part
    out.append(0)
    return bytes(out)


def encode_gif(frames: np.ndarray, fps: float) -> bytes:
    """(T, H, W, 3) uint8 -> a looping animated GIF at ``fps``."""
    t, h, w, _ = frames.shape
    delay = max(1, int(round(100.0 / max(float(fps), 1e-6))))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
           _gif_palette(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    indices = _gif_indices(frames)
    for i in range(t):
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay)
                   + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(b"\x08" + _sub_blocks(_lzw_literal(indices[i])))
    out.append(b"\x3b")
    return b"".join(out)


# ---- the event file ----

class EventFileWriter:
    """Appends ``Event`` records to ``events.out.tfevents.<time>.<host>``
    in ``logdir``; each ``add_*`` call writes its record through."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        base = os.path.join(
            logdir, f"events.out.tfevents.{str(time.time())[:10]}."
            f"{socket.gethostname()}")
        path, n = base, 0
        while os.path.exists(path):   # two writers in one second
            n += 1
            path = f"{base}.{n}"
        self.path = path
        self._file = open(path, "wb")
        self._event(_bytes_field(3, b"brain.Event:2"), step=0)

    def _event(self, what: bytes, step: int) -> None:
        data = (_key(1, 1) + struct.pack("<d", time.time())
                + (_int_field(2, step) if step else b"") + what)
        header = struct.pack("<Q", len(data))
        self._file.write(header + struct.pack("<I", masked_crc32c(header))
                         + data + struct.pack("<I", masked_crc32c(data)))
        self._file.flush()

    def _summary(self, value: bytes, step: int) -> None:
        self._event(_bytes_field(5, _bytes_field(1, value)), step)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._summary(_scalar_value(tag, value), step)

    def add_image(self, tag: str, img: np.ndarray, step: int) -> None:
        """(H, W, C) uint8 as a PNG image value."""
        h, w, c = img.shape
        self._summary(_image_value(tag, h, w, c, encode_png(img)), step)

    def add_gif(self, tag: str, frames: np.ndarray, step: int,
                fps: float) -> None:
        """(T, H, W, 3) uint8 as an animated GIF image value."""
        _, h, w, c = frames.shape
        self._summary(_image_value(tag, h, w, c, encode_gif(frames, fps)),
                      step)

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()


# ---- reading back ----

def _fields(data: bytes):
    """(field number, wire type, value) of each field of a protobuf
    message: an int for varints, bytes for fixed and length-delimited."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            value, pos = data[pos:pos + size], pos + size
        elif wire == 2:
            size, pos = _read_varint(data, pos)
            value, pos = data[pos:pos + size], pos + size
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _read_varint(data: bytes, pos: int):
    value = shift = 0
    while True:
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, pos


def read_events(path: str) -> list:
    """The events of an event file, as dicts: ``step``, ``wall_time``,
    ``file_version`` (the first event) and ``values``, a list of ``(tag,
    "scalar", float)`` and ``(tag, "image", (height, width, colorspace,
    encoded bytes))``.  Raises ``ValueError`` on a CRC mismatch."""
    with open(path, "rb") as f:
        data = f.read()
    events, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack("<I", data[pos + 12 + length:
                                           pos + 16 + length])
        if crc != masked_crc32c(header) or pcrc != masked_crc32c(payload):
            raise ValueError(f"{path}: CRC mismatch in the record at {pos}")
        pos += 16 + length
        event = {"step": 0, "values": []}
        for field, _, value in _fields(payload):
            if field == 1:
                event["wall_time"] = struct.unpack("<d", value)[0]
            elif field == 2:
                event["step"] = value
            elif field == 3:
                event["file_version"] = value.decode()
            elif field == 5:
                for _, _, v in _fields(value):
                    event["values"].append(_read_value(v))
        events.append(event)
    return events


def _read_value(data: bytes):
    tag, kind, what = "", None, None
    for field, _, value in _fields(data):
        if field == 1:
            tag = value.decode()
        elif field == 2:
            kind, what = "scalar", struct.unpack("<f", value)[0]
        elif field == 4:
            img = dict((f, v) for f, _, v in _fields(value))
            kind = "image"
            what = (img.get(1, 0), img.get(2, 0), img.get(3, 0),
                    img.get(4, b""))
    return tag, kind, what
