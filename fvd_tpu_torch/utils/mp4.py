"""ISO base media (MP4) files of MPEG-4 Part 2 video, with the standard library.

The JAX package writes its clips through OpenCV's ``mp4v`` writer, whose
libavformat mov muxer lays a file out as

    ftyp  free  mdat (the samples)  moov
    moov: mvhd, trak (tkhd, edts/elst, mdia (mdhd, hdlr 'vide',
          minf (vmhd, dinf/dref, stbl (stsd 'mp4v' + esds, stts, stss,
          stsc, stsz, stco)))), udta

:func:`parse` walks ``moov/trak/mdia`` of the first video track for its
timescale, the ``tkhd`` display matrix, the ``mp4v`` sample entry with the
DecoderSpecificInfo of its ``esds`` (the VOS/VO/VOL headers), and the sample
table (``stts``, ``stss``, ``stsc``, ``stsz``, ``stco`` or ``co64``), giving
each sample's byte range.  A video track of any other sample entry (``avc1``,
``hvc1``, ``av01``, ...) raises :class:`UnsupportedVideo` naming its fourcc.

:class:`Mp4Writer` writes the same layout: samples into ``mdat`` as they
come, and ``moov`` at the end with the VOL in ``esds`` and an ``stss`` of the
I-VOPs.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from fractions import Fraction
from typing import List, Optional, Tuple

from fvd_tpu_torch.utils.avi import UnsupportedVideo, container_name, fps_rational

_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf", b"udta"}


@dataclass
class Track:
    """The first video track of an MP4 file."""
    fourcc: str
    width: int
    height: int
    timescale: int
    sample_deltas: List[int]
    offsets: List[int]
    sizes: List[int]
    sync: Optional[List[int]]          # 0-based ids of the sync samples; None: all
    config: bytes                      # esds DecoderSpecificInfo
    matrix: Tuple[int, ...] = field(default=(0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000))

    @property
    def frame_count(self) -> int:
        return len(self.sizes)

    @property
    def fps(self) -> float:
        """Frames over the summed sample durations, reduced as libavformat's
        ``avg_frame_rate``."""
        total = sum(self.sample_deltas)
        if not total or not self.timescale:
            return 0.0
        return float(Fraction(self.timescale * len(self.sample_deltas), total))

    @property
    def rotation(self) -> int:
        """The display rotation in degrees [0, 360), as libavformat reads it
        from the ``tkhd`` matrix: ``atan2(b, a)`` rounded."""
        a, b, _, c, d = (self.matrix[i] / 65536.0 for i in range(5))
        if math.hypot(a, c) == 0.0 or math.hypot(b, d) == 0.0:
            return 0
        theta = math.degrees(math.atan2(b / math.hypot(b, d), a / math.hypot(a, c)))
        r = int(math.floor(abs(theta) + 0.5)) * (1 if theta >= 0 else -1)  # C lround
        return r % 360


def _boxes(data, start: int, end: int):
    """(type, body start, box end) of each box in ``[start, end)``."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            (size,) = struct.unpack_from(">Q", data, pos + 8)
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise UnsupportedVideo(f"MP4 box {kind!r} at byte {pos} runs past its parent")
        yield kind, pos + head, pos + size
        pos += size


def _child(data, start: int, end: int, kind: bytes):
    for k, s, e in _boxes(data, start, end):
        if k == kind:
            return s, e
    return None


def _descriptor(data, pos: int) -> Tuple[int, int, int]:
    """(tag, body start, body end) of an MPEG-4 descriptor (ISO 14496-1)."""
    tag = data[pos]
    pos += 1
    size = 0
    for _ in range(4):
        byte = data[pos]
        pos += 1
        size = (size << 7) | (byte & 0x7F)
        if not byte & 0x80:
            break
    return tag, pos, pos + size


def _esds_config(data, start: int, end: int) -> bytes:
    """The DecoderSpecificInfo in an ``esds`` box body."""
    tag, s, e = _descriptor(data, start + 4)   # after version/flags
    if tag != 0x03:
        raise UnsupportedVideo("MP4 esds without an ES descriptor")
    flags = data[s + 2]
    s += 3
    if flags & 0x80:
        s += 2
    if flags & 0x40:
        s += 1 + data[s]
    if flags & 0x20:
        s += 2
    tag, s, e = _descriptor(data, s)
    if tag != 0x04:
        raise UnsupportedVideo("MP4 esds without a DecoderConfig descriptor")
    if data[s] not in (0x20,):
        raise UnsupportedVideo(f"MP4 mp4v track of object type 0x{data[s]:02x}, not MPEG-4 Visual")
    s += 13
    while s < e:
        tag, ds, de = _descriptor(data, s)
        if tag == 0x05:
            return bytes(data[ds:de])
        s = de
    return b""


def _full(data, s: int) -> int:
    return s + 4  # skip version and flags


def _sample_table(data, s: int, e: int, path: str, tkhd) -> Track:
    stsd = _child(data, s, e, b"stsd")
    if stsd is None:
        raise UnsupportedVideo(f"{path}: MP4 video track without stsd")
    entries = list(_boxes(data, _full(data, stsd[0]) + 4, stsd[1]))
    if not entries:
        raise UnsupportedVideo(f"{path}: MP4 video track without a sample entry")
    kind, es, ee = entries[0]
    fourcc = kind.decode("latin-1")
    if kind != b"mp4v":
        raise UnsupportedVideo(f"{path}: MP4 video of codec {fourcc!r}; the port reads MPEG-4 "
                               f"Part 2 ('mp4v') only")
    width, height = struct.unpack_from(">HH", data, es + 24)
    esds = _child(data, es + 78, ee, b"esds")
    config = _esds_config(data, *esds) if esds else b""

    def table(kind):
        box = _child(data, s, e, kind)
        if box is None:
            return None
        body = _full(data, box[0])
        (n,) = struct.unpack_from(">I", data, body)
        return body + 4, n

    deltas: List[int] = []
    t = table(b"stts")
    if t is None:
        raise UnsupportedVideo(f"{path}: MP4 video track without stts")
    for i in range(t[1]):
        count, delta = struct.unpack_from(">II", data, t[0] + 8 * i)
        deltas += [delta] * count
    sizes: List[int]
    box = _child(data, s, e, b"stsz")
    if box is None:
        raise UnsupportedVideo(f"{path}: MP4 video track without stsz")
    uniform, n = struct.unpack_from(">II", data, _full(data, box[0]))
    sizes = [uniform] * n if uniform else list(struct.unpack_from(f">{n}I", data, _full(data, box[0]) + 8))
    t = table(b"stco")
    if t is not None:
        chunks = list(struct.unpack_from(f">{t[1]}I", data, t[0]))
    else:
        t = table(b"co64")
        if t is None:
            raise UnsupportedVideo(f"{path}: MP4 video track without stco or co64")
        chunks = list(struct.unpack_from(f">{t[1]}Q", data, t[0]))
    t = table(b"stsc")
    if t is None:
        raise UnsupportedVideo(f"{path}: MP4 video track without stsc")
    runs = [struct.unpack_from(">III", data, t[0] + 12 * i) for i in range(t[1])]
    offsets: List[int] = []
    k = 0
    for i, (first, per_chunk, _) in enumerate(runs):
        last = runs[i + 1][0] - 1 if i + 1 < len(runs) else len(chunks)
        for chunk in range(first - 1, last):
            pos = chunks[chunk]
            for _ in range(per_chunk):
                if k >= len(sizes):
                    break
                offsets.append(pos)
                pos += sizes[k]
                k += 1
    if len(offsets) != len(sizes):
        raise UnsupportedVideo(f"{path}: MP4 sample table places {len(offsets)} of {len(sizes)} samples")
    if any(o + z > len(data) for o, z in zip(offsets, sizes)):
        raise UnsupportedVideo(f"{path}: MP4 samples run past the end of the file (cut?)")
    sync = None
    t = table(b"stss")
    if t is not None:
        sync = [v - 1 for v in struct.unpack_from(f">{t[1]}I", data, t[0])]
    if len(deltas) < len(sizes):
        deltas += [deltas[-1] if deltas else 0] * (len(sizes) - len(deltas))
    return Track(fourcc, width, height, 0, deltas[:len(sizes)], offsets, sizes, sync, config,
                 tkhd or Track.matrix)


def parse(path: str, data) -> Track:
    """The first video track of the MP4 file whose bytes are ``data``."""
    name = container_name(bytes(data[:200]))
    if not name.startswith("MP4"):
        raise UnsupportedVideo(f"{path}: {name}, not MP4")
    moov = _child(data, 0, len(data), b"moov")
    if moov is None:
        raise UnsupportedVideo(f"{path}: MP4 without a moov box (cut or fragmented file)")
    for kind, s, e in _boxes(data, *moov):
        if kind != b"trak":
            continue
        mdia = _child(data, s, e, b"mdia")
        if mdia is None:
            continue
        hdlr = _child(data, *mdia, b"hdlr")
        if hdlr is None or bytes(data[hdlr[0] + 8:hdlr[0] + 12]) != b"vide":
            continue
        matrix = None
        tkhd = _child(data, s, e, b"tkhd")
        if tkhd is not None:
            off = tkhd[0] + (52 if data[tkhd[0]] == 1 else 40)
            matrix = struct.unpack_from(">9i", data, off)
        mdhd = _child(data, *mdia, b"mdhd")
        timescale = 0
        if mdhd is not None:
            timescale = struct.unpack_from(">I", data, mdhd[0] + (20 if data[mdhd[0]] == 1 else 12))[0]
        minf = _child(data, *mdia, b"minf")
        stbl = _child(data, *minf, b"stbl") if minf else None
        if stbl is None:
            raise UnsupportedVideo(f"{path}: MP4 video track without a sample table")
        track = _sample_table(data, *stbl, path, matrix)
        track.timescale = timescale
        return track
    raise UnsupportedVideo(f"{path}: MP4 without a video track")


def is_mp4(head: bytes) -> bool:
    return head[4:8] == b"ftyp"


# --- writing -----------------------------------------------------------------

def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _fullbox(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _desc(tag: int, body: bytes) -> bytes:
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F, 0x80 | (n >> 7) & 0x7F,
                  n & 0x7F]) + body


_IDENTITY = (0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
_ENCODER = b"fvd_tpu_torch"


class Mp4Writer:
    """Appends MPEG-4 Part 2 samples; :meth:`close` writes ``moov``.

    ``config`` is the VOS/VO/VOL headers.  The track's timescale is the
    frame rate's numerator doubled up to at least 10000 and every sample
    lasts ``timescale / fps``, as libavformat's mov muxer does."""

    def __init__(self, path: str, width: int, height: int, fps: float, config: bytes):
        rate, scale = fps_rational(fps)
        self.path, self.width, self.height, self.config = path, width, height, config
        self.timescale = rate
        while self.timescale < 10000:
            self.timescale *= 2
        self.delta = self.timescale * scale // rate
        self._f = open(path, "wb")
        ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isom", b"iso2", b"mp41")
        self._f.write(ftyp + _box(b"free"))
        self._mdat_at = self._f.tell()
        self._f.write(struct.pack(">I4s", 8, b"mdat"))
        self._pos = self._mdat_at + 8
        self._sizes: List[int] = []
        self._sync: List[int] = []
        self._max = 0

    def write(self, sample: bytes, sync: bool) -> None:
        if sync:
            self._sync.append(len(self._sizes) + 1)
        self._f.write(sample)
        self._sizes.append(len(sample))
        self._pos += len(sample)

    def close(self) -> None:
        if self._f is None:
            return
        try:
            mdat_size = self._pos - self._mdat_at
            if mdat_size >= 1 << 32:
                raise ValueError(f"{self.path}: more than 4 GiB of samples")
            self._f.write(self._moov())
            self._f.seek(self._mdat_at)
            self._f.write(struct.pack(">I", mdat_size))
        finally:
            self._f.close()
            self._f = None

    def __enter__(self) -> "Mp4Writer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _moov(self) -> bytes:
        n = len(self._sizes)
        duration = n * self.delta
        movie_ms = duration * 1000 // self.timescale
        matrix = struct.pack(">9i", *_IDENTITY)
        mvhd = _fullbox(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, movie_ms),
                        struct.pack(">IH", 0x10000, 0x100), bytes(10), matrix, bytes(24),
                        struct.pack(">I", 2))
        tkhd = _fullbox(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie_ms), bytes(8),
                        struct.pack(">hhH", 0, 0, 0), bytes(2), matrix,
                        struct.pack(">II", self.width << 16, self.height << 16))
        edts = _box(b"edts", _fullbox(b"elst", 0, 0, struct.pack(">IIiHH", 1, movie_ms, 0, 1, 0)))
        mdhd = _fullbox(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, self.timescale, duration),
                        struct.pack(">HH", 0x55C4, 0))
        hdlr = _fullbox(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"VideoHandler\x00")
        dinf = _box(b"dinf", _fullbox(b"dref", 0, 0, struct.pack(">I", 1), _fullbox(b"url ", 0, 1)))
        bitrate = int(sum(self._sizes) * 8 * self.timescale / max(duration, 1))
        dcd = _desc(0x04, bytes([0x20, 0x11]) + struct.pack(">I", max(self._sizes, default=0) * 8)[1:]
                    + struct.pack(">II", bitrate, bitrate) + _desc(0x05, self.config))
        esds = _fullbox(b"esds", 0, 0, _desc(0x03, struct.pack(">HB", 1, 0) + dcd + _desc(0x06, b"\x02")))
        mp4v = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                    struct.pack(">HHIIIH", self.width, self.height, 0x480000, 0x480000, 0, 1),
                    bytes(32), struct.pack(">Hh", 0x18, -1), esds)
        stsd = _fullbox(b"stsd", 0, 0, struct.pack(">I", 1), mp4v)
        stts = _fullbox(b"stts", 0, 0, struct.pack(">III", 1, n, self.delta))
        stss = _fullbox(b"stss", 0, 0, struct.pack(f">I{len(self._sync)}I", len(self._sync), *self._sync))
        stsc = _fullbox(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
        stsz = _fullbox(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *self._sizes))
        stco = _fullbox(b"stco", 0, 0, struct.pack(">II", 1, self._mdat_at + 8))
        stbl = _box(b"stbl", stsd, stts, stss, stsc, stsz, stco)
        vmhd = _fullbox(b"vmhd", 0, 1, bytes(8))
        minf = _box(b"minf", vmhd, dinf, stbl)
        mdia = _box(b"mdia", mdhd, hdlr, minf)
        trak = _box(b"trak", tkhd, edts, mdia)
        udta = _box(b"udta", _fullbox(b"meta", 0, 0,
                                      _fullbox(b"hdlr", 0, 0, bytes(4), b"mdirappl", bytes(9)),
                                      _box(b"ilst", _box(b"\xa9too", _box(b"data", struct.pack(">II", 1, 0),
                                                                             _ENCODER)))))
        return _box(b"moov", mvhd, trak, udta)
