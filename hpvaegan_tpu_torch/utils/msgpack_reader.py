"""Read the JAX package's flax-msgpack checkpoints without ``flax`` or
``msgpack`` (no JAX counterpart: the JAX package reads them with flax).

The JAX package writes ``netG``, ``netD_<s>``, ``Noise_Amps`` and
``netG_mid`` with ``flax.serialization.to_bytes``: a msgpack document of
maps, arrays, strings, binaries, integers, floats, nil and booleans, plus
flax's extension types

* 1: an ndarray, itself msgpack ``(shape, dtype name, C-order bytes)``;
* 2: a complex, msgpack ``(real, imag)``;
* 3: a numpy scalar, packed as a 0-d ndarray.

Flax turns lists into ``{"0": ..., "1": ...}`` maps before writing, so a
generator's ``body`` comes back as such a map (``convert.load_generator``
takes either).  ``read`` gives what ``flax.serialization.
msgpack_restore`` gives, except for flax's chunked form of arrays above
1 GiB and any other extension type, which raise; a ``bfloat16`` array is
widened to float32 exactly (numpy has no bfloat16).
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np

__all__ = ["read", "read_file", "is_msgpack_file"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack document")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H",
                                         0xC9: ">I"}[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("flax's chunked array form (arrays above 1 GiB) "
                             "is not supported")
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            real, imag = read(payload)
            return complex(real, imag)
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buf = read(payload)
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def read(data: bytes) -> Any:
    """The tree in one msgpack document."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack document")
    return out


def read_file(path: str) -> Any:
    with open(path, "rb") as f:
        return read(f.read())


def is_msgpack_file(path: str) -> bool:
    """True for a flax-msgpack checkpoint (a top-level map), False for a
    ``torch.save`` file (a zip archive, ``PK``)."""
    with open(path, "rb") as f:
        head = f.read(1)
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))
