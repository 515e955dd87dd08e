"""flax `.msgpack` files, read and written in pure Python.

The reader is the counterpart of `flax.serialization.msgpack_restore` (the
format the JAX package's `save_pretrained` writes and in which its LPIPS lin
heads ship): the msgpack wire format (nil, booleans, integers, floats,
strings, binary, arrays, maps and the extension types), flax's extension
types (1: an ndarray packed as (shape, dtype name, C-order bytes); 2: a
Python complex; 3: a numpy scalar, packed as a 0-d ndarray) and flax's
`__msgpack_chunked_array__` dicts, in which arrays over `MAX_CHUNK_SIZE`
bytes are split into flat chunks. Arrays are read-only numpy views of the
file's bytes, as flax returns them; a bfloat16 array (numpy has no such
dtype) is widened to float32, which is exact.

The writer is the counterpart of `flax.serialization.to_bytes` and
`msgpack_serialize`, byte for byte: `to_state_dict`'s string keys in the
tree's own order (lists and tuples become {"0": ...} maps), arrays over
`MAX_CHUNK_SIZE` (read when the writer runs) chunked as flax chunks them,
and msgpack-python's encodings (the smallest integer form, float64, str8
for short strings, bin and ext sized to their payload). Leaves are numpy
arrays and scalars (bfloat16 through `ml_dtypes` where present), torch
tensors (bfloat16 written as flax writes it), Python booleans, integers
and floats, and strings. `write_msgpack` streams the array bytes to the file, so a checkpoint
is not held twice in memory. The port needs no `msgpack` package,
hence this module.
"""

from __future__ import annotations

import io
import struct
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

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



# ---- writing ------------------------------------------------------------


class _Array(NamedTuple):
    """An array leaf as flax packs it: its shape, dtype name and C-order
    data (a contiguous numpy array; bfloat16 as uint16)."""

    shape: tuple
    dtype: str
    data: np.ndarray


def _as_array(x: Any):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _Array(tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().view(np.uint16))
        x = t.numpy()
    if isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported for serialization "
                             "of ndarrays.")
        return _Array(x.shape, x.dtype.name, x if x.flags.c_contiguous else x.copy(order="C"))
    return None


def _chunk(arr: _Array) -> dict:
    """flax's `_chunk`: a flat array cut into `MAX_CHUNK_SIZE`-byte pieces."""
    chunksize = max(1, int(MAX_CHUNK_SIZE / arr.data.dtype.itemsize))
    flat = arr.data.reshape(-1)
    chunks = [_Array((len(flat[i:i + chunksize]),), arr.dtype, flat[i:i + chunksize])
              for i in range(0, flat.size, chunksize)]
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _prepare(node: Any, chunkable: bool = True) -> Any:
    """Array leaves as `_Array`, chunked above `MAX_CHUNK_SIZE` where flax's
    `_chunk_array_leaves_in_place` chunks them: the root and dict values,
    not inside lists."""
    if isinstance(node, dict):
        return {k: _prepare(v, chunkable) for k, v in node.items()}
    if isinstance(node, list):
        return [_prepare(v, False) for v in node]
    return _leaf(node, chunkable)


def _leaf(x: Any, chunkable: bool) -> Any:
    if isinstance(x, np.generic):
        return x  # a numpy scalar: extension type 3
    arr = _as_array(x)
    if arr is None:
        return x
    if chunkable and arr.data.nbytes > MAX_CHUNK_SIZE:
        return _chunk(arr)
    return arr


class _Writer:
    def __init__(self, write: Callable[[Any], Any]):
        self.write = write

    def header(self, fixed: int, fixed_max: int, sized: tuple, n: int) -> None:
        """A fix-form header (`fixed | n` when n < fixed_max), else the
        first of `sized` ((code, struct format, limit), ...) that holds n."""
        if fixed_max and n < fixed_max:
            self.write(bytes([fixed | n]))
            return
        for code, fmt, limit in sized:
            if n <= limit:
                self.write(bytes([code]) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack: object of size {n} is too large")

    def int(self, n: int) -> None:
        if 0 <= n < 0x80 or -0x20 <= n < 0:
            self.write(struct.pack(">b" if n < 0 else ">B", n))
            return
        forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF), (0xCE, ">I", 0, 0xFFFFFFFF),
                 (0xCF, ">Q", 0, 0xFFFFFFFFFFFFFFFF)) if n >= 0 else (
                 (0xD0, ">b", -0x80, 0), (0xD1, ">h", -0x8000, 0),
                 (0xD2, ">i", -0x80000000, 0), (0xD3, ">q", -0x8000000000000000, 0))
        for code, fmt, low, high in forms:
            if low <= n <= high:
                self.write(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"msgpack: integer {n} out of range")

    def str(self, text: str) -> None:
        raw = text.encode("utf-8")
        self.header(0xA0, 32, ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                               (0xDB, ">I", 0xFFFFFFFF)), len(raw))
        self.write(raw)

    def bin_header(self, n: int) -> None:
        self.header(0, 0, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF)), n)

    def ext_header(self, code: int, n: int) -> None:
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.write(bytes([fixed[n]]))
        else:
            self.header(0, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                               (0xC9, ">I", 0xFFFFFFFF)), n)
        self.write(struct.pack(">b", code))

    def array(self, arr: _Array, code: int = EXT_NDARRAY) -> None:
        """Extension `code` holding packb((shape, dtype name, bytes))."""
        inner = io.BytesIO()
        head = _Writer(inner.write)
        head.write(b"\x93")
        head.pack(list(arr.shape))
        head.str(arr.dtype)
        head.bin_header(arr.data.nbytes)
        self.ext_header(code, inner.tell() + arr.data.nbytes)
        self.write(inner.getvalue())
        self.write(memoryview(arr.data.reshape(-1).view(np.uint8)))

    def pack(self, obj: Any) -> None:
        kind = type(obj)
        if kind is bool:
            self.write(b"\xc3" if obj else b"\xc2")
        elif kind is int:
            self.int(obj)
        elif kind is float:
            self.write(b"\xcb" + struct.pack(">d", obj))
        elif kind is str:
            self.str(obj)
        elif kind is list:
            self.header(0x90, 16, ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF)), len(obj))
            for item in obj:
                self.pack(item)
        elif kind is dict:
            self.header(0x80, 16, ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF)), len(obj))
            for key, value in obj.items():
                self.pack(key)
                self.pack(value)
        elif kind is _Array:
            self.array(obj)
        elif isinstance(obj, np.generic):
            self.array(_as_array(np.asarray(obj)), EXT_NPSCALAR)
        else:
            raise TypeError(f"msgpack: can not serialize {kind.__name__!r} object")


def to_state_dict(tree: Any) -> Any:
    """flax's `to_state_dict` of plain containers: dicts with string keys,
    lists and tuples as {"0": ...} maps."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def sorted_tree(tree: Any) -> Any:
    """`tree` with every dict's keys in sorted order, as `jax.device_get`
    (a tree map) rebuilds dicts before the JAX package's `save_pretrained`
    serializes them."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [sorted_tree(v) for v in tree]
    return tree


def _serialize(tree: Any) -> bytes:
    out = io.BytesIO()
    _Writer(out.write).pack(_prepare(tree))
    return out.getvalue()


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes `flax.serialization.msgpack_serialize(tree)` gives (its
    copy of the tree, a tree map, puts dict keys in sorted order)."""
    return _serialize(sorted_tree(tree))


def to_bytes(tree: Any) -> bytes:
    """The bytes `flax.serialization.to_bytes(tree)` gives (keys in the
    tree's own order)."""
    return _serialize(to_state_dict(tree))


def write_msgpack(path: str, tree: Any) -> None:
    """`to_bytes(tree)` written to `path`, the arrays streamed."""
    with open(path, "wb") as f:
        _Writer(f.write).pack(_prepare(to_state_dict(tree)))
