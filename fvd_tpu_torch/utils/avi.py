"""Raw-RGBA AVI and PNG-in-AVI files, with numpy and the standard library only.

The port reads and writes video without OpenCV or libav.  Its container is
the AVI that libavformat writes when OpenCV's ``VideoWriter`` is given fourcc
``RGBA`` (lossless raw frames) or ``png `` (one PNG per frame), chunk for
chunk:

    RIFF 'AVI '
      LIST 'hdrl'  avih, LIST 'strl' (strh, strf, JUNK: room for an OpenDML
                   index), JUNK (room for the OpenDML header)
      LIST 'INFO'  ISFT
      JUNK         1016 bytes of padding
      LIST 'movi'  one '00dc' chunk per frame: top-down RGBA bytes, or a PNG
      idx1         one keyframe entry per frame, offsets from the 'movi' tag

so OpenCV reads the frames back bit-exactly with the same fps, frame count and
size.  The writer makes one RIFF of at most 1 GiB (AVI 1.0): about 116 s of
240x320 frames.  The reader also takes the OpenDML files that libavformat
writes past 1 GiB, whose later frames sit in RIFF 'AVIX' chunks.

:class:`AviWriter` appends frames and writes the headers on close;
:func:`probe` and :func:`read_frames` walk the RIFF chunks of a raw-RGBA file
through ``mmap``, so a sample of frame ids is random access.  A file in any
other container, or an AVI of another codec, raises :class:`UnsupportedVideo`
naming what it found.
"""

from __future__ import annotations

import mmap
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fvd_tpu_torch.utils.png import encode_png

FOURCC_RAW = b"RGBA"
FOURCC_PNG = b"png "
MAX_RIFF_BYTES = 1 << 30
_MOVI_OFFSET = 5666           # where LIST 'movi' starts, after the fixed header
_ISFT = b"fvd_tpu_torch\x00"  # 14 bytes, as libavformat's version string
_AVIF_FLAGS = 0x910           # HASINDEX | ISINTERLEAVED | TRUSTCKTYPE
_KEYFRAME = 0x10


class UnsupportedVideo(ValueError):
    """A video file the port cannot read; the message names its container."""


def fps_rational(fps: float) -> Tuple[int, int]:
    """``(rate, scale)`` for ``fps`` as OpenCV's libav writer picks them: the
    first power-of-ten base whose rounded rate is within 1e-3 of ``fps``,
    reduced."""
    import math

    if not fps > 0:
        raise ValueError(f"fps must be positive, got {fps}")
    rate, scale = int(fps + 0.5), 1
    while abs(rate / scale - fps) > 0.001:
        scale *= 10
        rate = int(fps * scale + 0.5)
    g = math.gcd(rate, scale)
    return rate // g, scale // g


def _chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + (b"\x00" if len(body) & 1 else b"")


def _list(kind: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", 4 + len(body)) + kind + body


def _header(fourcc: bytes, fps: float, n: int, w: int, h: int, max_chunk: int, movi_bytes: int) -> bytes:
    rate, scale = fps_rational(fps)
    bits = 32 if fourcc == FOURCC_RAW else 24
    image_bytes = w * h * bits // 8
    avih = struct.pack("<14I", 1_000_000 * scale // rate, max_chunk * rate // scale, 0, _AVIF_FLAGS,
                       n, 0, 1, 1 << 20, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", fourcc, 0, 0, 0, 0, scale, rate, 0, n,
                       max_chunk, -1, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, bits, fourcc, image_bytes, 0, 0, 0, 0)
    indx = struct.pack("<HBBI4s", 4, 0, 0, 0, b"00dc").ljust(4120, b"\x00")
    odml = b"odml" + b"dmlh" + struct.pack("<I", 248) + bytes(248)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf) + _chunk(b"JUNK", indx))
                 + _chunk(b"JUNK", odml))
    head = hdrl + _list(b"INFO", _chunk(b"ISFT", _ISFT)) + _chunk(b"JUNK", bytes(1016))
    assert 12 + len(head) == _MOVI_OFFSET
    riff_body = 4 + len(head) + 12 + movi_bytes + 8 + 16 * n
    return (b"RIFF" + struct.pack("<I", riff_body) + b"AVI " + head
            + b"LIST" + struct.pack("<I", 4 + movi_bytes) + b"movi")


class AviWriter:
    """Appends RGB frames to a raw-RGBA (``fourcc=FOURCC_RAW``) or PNG-in-AVI
    (``FOURCC_PNG``) file; :meth:`close` writes the index and the headers."""

    def __init__(self, path: str, fps: float, fourcc: bytes = FOURCC_RAW):
        if fourcc not in (FOURCC_RAW, FOURCC_PNG):
            raise ValueError(f"unsupported fourcc {fourcc!r}")
        fps_rational(fps)  # rejects fps <= 0 before the file exists
        self.path, self.fps, self.fourcc = path, float(fps), fourcc
        self._f = open(path, "wb")
        self._f.write(bytes(_MOVI_OFFSET + 12))  # the header, written on close
        self._index: List[Tuple[int, int]] = []  # (offset from the 'movi' tag, size)
        self._movi_bytes = 0
        self._shape: Optional[Tuple[int, int]] = None

    def write(self, rgb: np.ndarray) -> None:
        frame = np.asarray(rgb)
        if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"frames are uint8 [H, W, 3] RGB, got {frame.dtype} {frame.shape}")
        if self._shape is None:
            self._shape = frame.shape[:2]
        elif frame.shape[:2] != self._shape:
            raise ValueError(f"frame size {frame.shape[:2]} differs from the first frame's {self._shape}")
        if self.fourcc == FOURCC_RAW:
            h, w = self._shape
            body = np.empty((h, w, 4), np.uint8)
            body[..., :3] = frame
            body[..., 3] = 255
            body = body.tobytes()
        else:
            body = encode_png(frame)
        chunk = _chunk(b"00dc", body)
        if _MOVI_OFFSET + 12 + self._movi_bytes + len(chunk) + 16 * (len(self._index) + 1) > MAX_RIFF_BYTES:
            raise ValueError(f"{self.path}: more than {MAX_RIFF_BYTES} bytes; an AVI 1.0 file holds one RIFF")
        self._index.append((4 + self._movi_bytes, len(body)))
        self._f.write(chunk)
        self._movi_bytes += len(chunk)

    def write_all(self, frames: np.ndarray) -> None:
        for f in frames:
            self.write(f)

    def close(self) -> None:
        if self._f is None:
            return
        try:
            h, w = self._shape or (0, 0)
            n = len(self._index)
            self._f.write(b"idx1" + struct.pack("<I", 16 * n) + b"".join(
                struct.pack("<4sIII", b"00dc", _KEYFRAME, off, size) for off, size in self._index))
            max_chunk = max((size for _, size in self._index), default=0)
            self._f.seek(0)
            self._f.write(_header(self.fourcc, self.fps, n, w, h, max_chunk, self._movi_bytes))
        finally:
            self._f.close()
            self._f = None

    def __enter__(self) -> "AviWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_avi(path: str, frames: np.ndarray, fps: float, fourcc: bytes = FOURCC_RAW) -> None:
    """RGB uint8 [T, H, W, 3] -> an AVI file of ``fourcc``."""
    with AviWriter(path, fps, fourcc) as w:
        w.write_all(frames)


def container_name(head: bytes) -> str:
    """The container the first bytes of a file announce."""
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return "AVI"
    if head[4:8] == b"ftyp":
        return f"MP4/QuickTime (ISO BMFF, brand {head[8:12].decode('latin-1')!r})"
    for magic, name in ((b"\x1aE\xdf\xa3", "Matroska/WebM"), (b"OggS", "Ogg"), (b"FLV", "FLV"),
                        (b"\x00\x00\x01\xba", "MPEG program stream"), (b"GIF8", "GIF"),
                        (b"\x89PNG", "PNG image"), (b"RIFF", "RIFF (not AVI)")):
        if head.startswith(magic):
            return name
    if head[:1] == b"\x47" and len(head) > 188 and head[188:189] == b"\x47":
        return "MPEG transport stream"
    return f"unknown container (first bytes {head[:12].hex()})"


class _Layout:
    """What :func:`_parse` finds in a raw-RGBA AVI."""

    def __init__(self, fps: float, width: int, height: int, frames: List[int]):
        self.fps, self.width, self.height, self.frames = fps, width, height, frames


def _walk(mm, start: int, end: int):
    """(tag, body offset, body size) of each chunk in ``[start, end)``."""
    pos = start
    while pos + 8 <= end:
        tag = bytes(mm[pos:pos + 4])
        (size,) = struct.unpack_from("<I", mm, pos + 4)
        yield tag, pos + 8, size
        pos += 8 + size + (size & 1)


def _parse(path: str, mm) -> _Layout:
    head = bytes(mm[:200])
    name = container_name(head)
    if name != "AVI":
        raise UnsupportedVideo(f"{path}: {name}; the port reads raw-RGBA AVI only "
                               "(fvd_tpu_torch.providers.media.write_video writes one)")
    strh = strf = None
    odml_frames = None  # dmlh's total frame count, where the file is OpenDML
    frames: List[int] = []

    def movi(off, size):
        for t, o, s in _walk(mm, off + 4, min(off + size, len(mm))):
            if t in (b"00dc", b"00db") and o + s <= len(mm):
                frames.append(o)

    # An OpenDML file (libavformat starts one once a file passes 1 GiB) holds
    # its first frames in RIFF 'AVI ' and the rest in RIFF 'AVIX' chunks.
    for riff, roff, rsize in _walk(mm, 0, len(mm)):
        rkind = bytes(mm[roff:roff + 4])
        if riff != b"RIFF" or rkind != (b"AVI " if roff == 8 else b"AVIX"):
            raise UnsupportedVideo(f"{path}: AVI with a {riff!r} {rkind!r} chunk at byte {roff - 8}")
        for tag, off, size in _walk(mm, roff + 4, min(roff + rsize, len(mm))):
            if tag != b"LIST":
                continue
            kind = bytes(mm[off:off + 4])
            if kind == b"movi":
                movi(off, size)
            elif kind == b"hdrl" and rkind == b"AVI ":
                for t, o, s in _walk(mm, off + 4, off + size):
                    if t == b"LIST" and bytes(mm[o:o + 4]) == b"strl" and strh is None:
                        for t2, o2, s2 in _walk(mm, o + 4, o + s):
                            if t2 == b"strh":
                                strh = struct.unpack_from("<4s4sIHHIIIIIIiI", mm, o2)
                            elif t2 == b"strf":
                                strf = struct.unpack_from("<IiiHH4sI", mm, o2)
                    elif t == b"LIST" and bytes(mm[o:o + 4]) == b"odml":
                        for t2, o2, s2 in _walk(mm, o + 4, o + s):
                            if t2 == b"dmlh":
                                (odml_frames,) = struct.unpack_from("<I", mm, o2)
    if strh is None or strf is None or strh[0] != b"vids":
        raise UnsupportedVideo(f"{path}: AVI without a video stream header")
    _, width, height, _, bits, compression, _ = strf
    if compression != FOURCC_RAW or bits != 32:
        raise UnsupportedVideo(f"{path}: AVI of codec {compression!r} at {bits} bits; the port "
                               f"reads raw {FOURCC_RAW!r} at 32 bits only")
    scale, rate = strh[6], strh[7]
    if not scale or not rate:
        raise UnsupportedVideo(f"{path}: AVI stream with rate {rate}/{scale}")
    # The stream header's length (and an OpenDML header's total) counts every
    # frame written; fewer whole frame chunks means a cut or damaged file.
    for what, count in (("stream header", strh[9]), ("OpenDML header", odml_frames)):
        if count and count != len(frames):
            raise UnsupportedVideo(f"{path}: the {what} counts {count} frames, the file holds "
                                   f"{len(frames)} whole frame chunks")
    return _Layout(rate / scale, width, abs(height), frames)


def _open(path: str):
    f = open(path, "rb")
    try:
        return f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except ValueError:  # an empty file cannot be mapped
        f.close()
        raise UnsupportedVideo(f"{path}: empty file") from None


def probe(path: str) -> Tuple[float, int, int, int]:
    """``(fps, frame_count, width, height)`` of a raw-RGBA AVI."""
    f, mm = _open(path)
    with f, mm:
        lay = _parse(path, mm)
    return lay.fps, len(lay.frames), lay.width, lay.height


def read_frames(path: str, frame_ids: Sequence[int]) -> Tuple[np.ndarray, List[int]]:
    """The frames ``frame_ids`` (sorted, without repeats) of a raw-RGBA AVI ->
    (uint8 [T, H, W, 3] RGB, the ids that exist)."""
    f, mm = _open(path)
    with f, mm:
        lay = _parse(path, mm)
        kept = [i for i in sorted(set(int(i) for i in frame_ids)) if 0 <= i < len(lay.frames)]
        h, w = lay.height, lay.width
        out = np.empty((len(kept), h, w, 3), np.uint8)
        nbytes = h * w * 4
        for k, fid in enumerate(kept):
            off = lay.frames[fid]
            (size,) = struct.unpack_from("<I", mm, off - 4)
            if size != nbytes or off + nbytes > len(mm):
                raise UnsupportedVideo(f"{path}: frame {fid} holds {size} bytes, not {h}x{w}x4")
            out[k] = np.frombuffer(mm, np.uint8, nbytes, off).reshape(h, w, 4)[..., :3]
    return out, kept
