"""PNG encode and decode with ``zlib`` and ``struct``.

The port writes its keyframe and face-crop artifacts, and the frames of its
viz videos, as PNG where the JAX package encodes JPEG with OpenCV, which the
port does not use.  Rows are stored unfiltered (filter type 0) and deflated at
level 1: on a 240x320 frame that is a few milliseconds of host time, and the
files are lossless.  :func:`decode_png` reads what :func:`encode_png` writes
(8-bit RGB or RGBA, filter type 0); any other PNG raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {3: 2, 4: 6}  # channels -> PNG colour type (RGB, RGBA)
ZLIB_LEVEL = 1


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB (or [H, W, 4] RGBA) -> PNG bytes."""
    img = np.asarray(rgb)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes uint8 [H, W, 3|4], got {img.dtype} {img.shape}")
    h, w, c = img.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)  # leading 0: filter type None
    rows[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), ZLIB_LEVEL)) + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes written by :func:`encode_png` -> uint8 [H, W, 3|4]."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPE.items()}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype}, interlace {interlace}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError(f"unsupported PNG row filters {sorted(set(rows[:, 0].tolist()))}: only type 0 is read")
    return rows[:, 1:].reshape(h, w, channels).copy()
