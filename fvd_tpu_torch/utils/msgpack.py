"""A reader of the msgpack files flax writes: the counterpart of
``flax.serialization.msgpack_restore`` for a machine without the ``msgpack``
package.

``flax_model.msgpack`` of a Hugging Face Flax checkpoint is
``msgpack.packb(params)`` of a nested dict whose leaves are numpy arrays
packed as msgpack ext type 1: the ext payload is itself the msgpack array
``[shape, dtype name, raw C-order bytes]``.  This module decodes the subset
of msgpack that such a file uses (maps, arrays, str, bin, nil, bools, ints,
floats and ext types 1-3) and, as flax does, joins arrays that flax split
into ``__msgpack_chunked_array__`` maps.

Arrays are read-only views of the file, which :func:`read_msgpack` maps
with ``mmap`` and keeps mapped while any view lives.  A ``bfloat16`` leaf
(numpy has no such dtype) comes back as float32, which holds every bfloat16
value exactly.
"""

from __future__ import annotations

import mmap
import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
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
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            return getattr(self, kind)(n)
        fixed_ext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixed_ext:
            return self.ext(fixed_ext[b])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[bytes(k) if isinstance(k, memoryview) else k] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = self.take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray(data)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).obj()
            return complex(real, imag)
        raise ValueError(f"msgpack: ext type {code} is not one flax writes")


def _ndarray(payload: memoryview) -> np.ndarray:
    shape, name, raw = _Reader(payload).obj()
    name = bytes(name).decode() if isinstance(name, memoryview) else name
    if name == "bfloat16":
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def _to_bytes(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_bytes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_bytes(v) for v in tree]
    return bytes(tree) if isinstance(tree, memoryview) else tree


def restore(data) -> Any:
    """The tree ``flax.serialization.msgpack_restore(data)`` gives, from a
    bytes-like object; arrays are views of ``data``."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes after the object")
    return _unchunk(_to_bytes(tree))


def read_msgpack(path: str) -> Any:
    """:func:`restore` of the file at ``path``, mapped rather than read."""
    with open(path, "rb") as f:
        if f.seek(0, 2) == 0:
            raise ValueError(f"{path}: empty file")
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return restore(mapped)


def leaves(tree: Any, prefix: Tuple[str, ...] = ()):
    """``(path, array)`` of every leaf of a nested dict, depth first."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v
