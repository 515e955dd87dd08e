"""A reader of flax `.msgpack` files, in pure Python.

Counterpart of `flax.serialization.msgpack_restore` (the format the JAX
package's `save_pretrained` writes and in which its LPIPS lin heads ship):
the msgpack wire format (nil, booleans, integers, floats, strings, binary,
arrays, maps and the extension types), flax's extension types (1: an
ndarray packed as (shape, dtype name, C-order bytes); 2: a Python complex;
3: a numpy scalar, packed as a 0-d ndarray) and flax's
`__msgpack_chunked_array__` dicts, in which arrays over `MAX_CHUNK_SIZE`
bytes are split into flat chunks. Arrays are read-only numpy views of the
file's bytes, as flax returns them; a bfloat16 array (numpy has no such
dtype) is widened to float32, which is exact. The card's machine has no
`msgpack` package, hence this reader.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax.serialization's; arrays above it are chunked
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data, raw: bool = False):
        self.view = memoryview(data)
        self.pos = 0
        self.raw = raw  # strings as bytes (flax reads its ndarray payloads so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.view):
            raise ValueError("msgpack: data ends inside an object")
        out = self.view[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def ext(self, code: int, n: int) -> Any:
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == EXT_COMPLEX:
            real, imag = _Reader(data).read()
            return complex(real, imag)
        raise ValueError(f"msgpack: unknown extension type {code}")

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.string(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: reserved byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _ndarray(data: memoryview) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(data, raw=True).read()
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape, order="C")


def _unchunk(node: dict) -> np.ndarray:
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(node: Any) -> Any:
    if isinstance(node, dict):
        if "__msgpack_chunked_array__" in node:
            return _unchunk(node)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def unpackb(data) -> Any:
    """One msgpack object from `data` (bytes), extension types decoded as
    flax decodes them."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.view):
        raise ValueError(f"msgpack: {len(reader.view) - reader.pos} bytes after the object")
    return out


def msgpack_restore(data) -> Any:
    """The tree `flax.serialization.msgpack_restore(data)` returns: dicts,
    lists, Python scalars and numpy arrays, chunked arrays joined."""
    return _unchunk_tree(unpackb(data))


def read_msgpack(path: str) -> Any:
    """`msgpack_restore` of a file."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())

