"""A reader and a writer of the msgpack files flax writes: the counterparts
of ``flax.serialization.msgpack_restore`` and ``flax.serialization.to_bytes``
for a machine without the ``msgpack`` package.

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

:func:`to_bytes` packs a tree as ``msgpack.packb(tree, default=...,
strict_types=True)`` does after flax's conversions: maps keep their keys'
order, an ndarray is ext 1 of ``packb((shape, dtype name, C-order bytes))``
(a 0-d array included), a numpy scalar ext 3, a complex ext 2, and an array
of more than ``MAX_CHUNK_SIZE`` bytes the ``__msgpack_chunked_array__`` map
flax splits it into.  Every object takes the smallest encoding msgpack-python
gives it, so the bytes equal flax's: a file read and written again is the
same file.
"""

from __future__ import annotations

import mmap
import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
#: flax's ``MAX_CHUNK_SIZE``: an array of more bytes is split into chunks
MAX_CHUNK_SIZE = 2 ** 30


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


# -- writing ----------------------------------------------------------------
def _sized(out: bytearray, n: int, small: int, fixed_base: int, codes) -> None:
    """The header of a str, bin, array or map of ``n`` entries: the fixed
    form below ``small`` (where the kind has one), else the 8-, 16- or
    32-bit length form."""
    if fixed_base is not None and n < small:
        out.append(fixed_base | n)
    elif codes[0] is not None and n <= 0xFF:
        out += bytes((codes[0], n))
    elif n <= 0xFFFF:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack: an object of {n} entries or bytes is too large")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: {v} does not fit 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000), (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: {v} does not fit 64 bits")


def _ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _sized(out, len(data), 0, None, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype name, bytes))``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of ndarrays.")
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _int(out, obj)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _sized(out, len(data), 32, 0xA0, (0xD9, 0xDA, 0xDB))
        out += data
    elif type(obj) in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _sized(out, len(data), 0, None, (0xC4, 0xC5, 0xC6))
        out += data
    elif type(obj) is list:
        _sized(out, len(obj), 16, 0x90, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif type(obj) is dict:
        _sized(out, len(obj), 16, 0x80, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _ext(out, _EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif type(obj) is complex:
        data = bytearray()
        _pack(data, [obj.real, obj.imag])
        _ext(out, _EXT_COMPLEX, bytes(data))
    else:
        raise TypeError(f"msgpack: can not serialize {type(obj).__name__!r} object")


def _state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` then its chunking, on a copy: dict keys as
    strings, a list or tuple as the map of its indices, an array of more
    than :data:`MAX_CHUNK_SIZE` bytes split into chunks."""
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        step = max(1, int(MAX_CHUNK_SIZE / tree.dtype.itemsize))
        flat = tree.reshape(-1)
        return {"__msgpack_chunked_array__": True, "shape": {str(i): n for i, n in enumerate(tree.shape)},
                "chunks": {str(i): flat[j:j + step] for i, j in enumerate(range(0, flat.size, step))}}
    return tree


def to_bytes(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes(tree)`` gives for a nested
    dict of numpy arrays (and numpy scalars, Python numbers, strings, bytes;
    a list is written as the map of its indices, as flax writes it): the
    inverse of :func:`restore`."""
    out = bytearray()
    _pack(out, _state_dict(tree))
    return bytes(out)


def write_msgpack(path: str, tree: Any) -> None:
    """Write :func:`to_bytes` of ``tree`` to ``path`` (through a temporary
    file beside it, so a reader never sees half a file)."""
    import os

    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(to_bytes(tree))
    os.replace(tmp, path)
