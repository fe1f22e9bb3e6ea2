"""ISO base media (MP4) files of MPEG-4 Part 2 and H.264 video, with the
standard library.

The JAX package writes its clips through OpenCV's ``mp4v`` writer, whose
libavformat mov muxer lays a file out as

    ftyp  free  mdat (the samples)  moov
    moov: mvhd, trak (tkhd, edts/elst, mdia (mdhd, hdlr 'vide',
          minf (vmhd, dinf/dref, stbl (stsd 'mp4v' + esds, stts, stss,
          stsc, stsz, stco)))), udta

:func:`parse` walks ``moov/trak/mdia`` of the first video track for its
timescale, the ``tkhd`` display matrix, the first ``elst`` edit's
``media_time``, the sample entry and the sample table (``stts``, ``ctts``,
``stss``, ``stsc``, ``stsz``, ``stco`` or ``co64``), giving each sample's byte
range and composition offset.  The sample entry is ``mp4v`` with the
DecoderSpecificInfo of its ``esds`` (the VOS/VO/VOL headers), or ``avc1`` /
``avc3`` with its ``avcC`` (H.264's parameter sets: ``utils/h264.py``); a video
track of any other sample entry (``hvc1``, ``av01``, ...), or an ``avc1``
without ``avcC``, raises :class:`UnsupportedVideo` naming its fourcc.

:class:`Mp4Writer` writes the same layout: samples into ``mdat`` as they
come, and ``moov`` at the end with the VOL in ``esds`` (or the ``avcC``) and
an ``stss`` of the sync samples; samples shown later than they decode (H.264's
B pictures) get a ``ctts`` and an ``elst`` whose ``media_time`` is the first
sample's composition offset, as FFmpeg's mov muxer writes them.
"""

from __future__ import annotations

import math
import mmap
import struct
from dataclasses import dataclass, field
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

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
    config: bytes                      # esds DecoderSpecificInfo (mp4v) or the avcC body (avc1, avc3)
    matrix: Tuple[int, ...] = field(default=(0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000))
    composition_offsets: Optional[List[int]] = None   # ctts per sample; None: all 0
    media_time: int = 0                # the first edit's start in the media timescale
    movie_duration: float = 0.0        # mvhd's duration in seconds (libavformat's ``fmt->duration``)

    @property
    def codec(self) -> str:
        """The decoder's name as libavcodec gives it (``avcodec_get_name``)."""
        return "h264" if self.fourcc in ("avc1", "avc3") else "mpeg4"

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


def _esds(data, start: int, end: int) -> Tuple[int, bytes]:
    """(objectTypeIndication, DecoderSpecificInfo) of an ``esds`` box body."""
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
    object_type = data[s]
    s += 13
    while s < e:
        tag, ds, de = _descriptor(data, s)
        if tag == 0x05:
            return object_type, bytes(data[ds:de])
        s = de
    return object_type, b""


def _esds_config(data, start: int, end: int) -> bytes:
    """The DecoderSpecificInfo of an ``mp4v`` track's ``esds`` box body."""
    object_type, config = _esds(data, start, end)
    if object_type != 0x20:
        raise UnsupportedVideo(f"MP4 mp4v track of object type 0x{object_type:02x}, not MPEG-4 Visual")
    return config


def _full(data, s: int) -> int:
    return s + 4  # skip version and flags


def _table_reader(data, s: int, e: int):
    """``table(kind)``: (first entry, entry count) of full box ``kind`` of
    the ``stbl`` at ``[s, e)``, or None."""
    def table(kind):
        box = _child(data, s, e, kind)
        if box is None:
            return None
        body = _full(data, box[0])
        (n,) = struct.unpack_from(">I", data, body)
        return body + 4, n
    return table


def _samples(data, s: int, e: int, path: str, what: str) -> Tuple[List[int], List[int], List[int]]:
    """Each sample's duration, byte offset and size from the ``stbl`` at
    ``[s, e)`` (``stts``, ``stsz``, ``stco`` or ``co64``, ``stsc``)."""
    table = _table_reader(data, s, e)
    deltas: List[int] = []
    t = table(b"stts")
    if t is None:
        raise UnsupportedVideo(f"{path}: MP4 {what} track without stts")
    for i in range(t[1]):
        count, delta = struct.unpack_from(">II", data, t[0] + 8 * i)
        deltas += [delta] * count
    sizes: List[int]
    box = _child(data, s, e, b"stsz")
    if box is None:
        raise UnsupportedVideo(f"{path}: MP4 {what} track without stsz")
    uniform, n = struct.unpack_from(">II", data, _full(data, box[0]))
    sizes = [uniform] * n if uniform else list(struct.unpack_from(f">{n}I", data, _full(data, box[0]) + 8))
    t = table(b"stco")
    if t is not None:
        chunks = list(struct.unpack_from(f">{t[1]}I", data, t[0]))
    else:
        t = table(b"co64")
        if t is None:
            raise UnsupportedVideo(f"{path}: MP4 {what} track without stco or co64")
        chunks = list(struct.unpack_from(f">{t[1]}Q", data, t[0]))
    t = table(b"stsc")
    if t is None:
        raise UnsupportedVideo(f"{path}: MP4 {what} track without stsc")
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
    if len(deltas) < len(sizes):
        deltas += [deltas[-1] if deltas else 0] * (len(sizes) - len(deltas))
    return deltas, offsets, sizes


def _sample_table(data, s: int, e: int, path: str, tkhd) -> Track:
    stsd = _child(data, s, e, b"stsd")
    if stsd is None:
        raise UnsupportedVideo(f"{path}: MP4 video track without stsd")
    entries = list(_boxes(data, _full(data, stsd[0]) + 4, stsd[1]))
    if not entries:
        raise UnsupportedVideo(f"{path}: MP4 video track without a sample entry")
    kind, es, ee = entries[0]
    fourcc = kind.decode("latin-1")
    width, height = struct.unpack_from(">HH", data, es + 24)
    if kind == b"mp4v":
        esds = _child(data, es + 78, ee, b"esds")
        config = _esds_config(data, *esds) if esds else b""
    elif kind in (b"avc1", b"avc3"):
        avcc = _child(data, es + 78, ee, b"avcC")
        if avcc is None:
            raise UnsupportedVideo(f"{path}: MP4 video of codec {fourcc!r} without an avcC box")
        config = bytes(data[avcc[0]:avcc[1]])
    else:
        raise UnsupportedVideo(f"{path}: MP4 video of codec {fourcc!r}; the port reads MPEG-4 "
                               f"Part 2 ('mp4v') and H.264 ('avc1', 'avc3') only")

    table = _table_reader(data, s, e)
    deltas, offsets, sizes = _samples(data, s, e, path, "video")
    sync = None
    t = table(b"stss")
    if t is not None:
        sync = [v - 1 for v in struct.unpack_from(f">{t[1]}I", data, t[0])]
    cto = None
    t = table(b"ctts")
    if t is not None:
        fmt = ">Ii" if data[t[0] - 8] == 1 else ">II"
        cto = []
        for i in range(t[1]):
            count, off = struct.unpack_from(fmt, data, t[0] + 8 * i)
            cto += [off] * count
        cto = (cto + [0] * len(sizes))[:len(sizes)]
    return Track(fourcc, width, height, 0, deltas[:len(sizes)], offsets, sizes, sync, config,
                 tkhd or Track.matrix, cto)


def _edit(data, s: int, e: int) -> Optional[Tuple[int, int]]:
    """(``media_time``, segment duration in the movie timescale) of the
    first non-empty edit of a ``trak``'s ``edts/elst``; None without one."""
    edts = _child(data, s, e, b"edts")
    elst = _child(data, *edts, b"elst") if edts else None
    if elst is None:
        return None
    version = data[elst[0]]
    (n,) = struct.unpack_from(">I", data, elst[0] + 4)
    fmt, step = (">Qq", 20) if version == 1 else (">Ii", 12)
    for i in range(n):
        duration, media_time = struct.unpack_from(fmt, data, elst[0] + 8 + step * i)
        if media_time != -1:
            return media_time, duration
    return None


def _media_time(data, s: int, e: int) -> int:
    """The ``media_time`` of the first non-empty edit of a ``trak``'s
    ``edts/elst``, or 0."""
    edit = _edit(data, s, e)
    return edit[0] if edit else 0


def _movie_duration(data, s: int, e: int) -> float:
    """``mvhd``'s duration over its timescale, in seconds (0 without one)."""
    mvhd = _child(data, s, e, b"mvhd")
    if mvhd is None:
        return 0.0
    if data[mvhd[0]] == 1:
        scale, duration = struct.unpack_from(">IQ", data, mvhd[0] + 20)
    else:
        scale, duration = struct.unpack_from(">II", data, mvhd[0] + 12)
    return duration / scale if scale else 0.0


def _video_trak(path: str, data):
    """(trak start, trak end, moov, stbl) of the first video track of the MP4
    file whose bytes are ``data``."""
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
        minf = _child(data, *mdia, b"minf")
        stbl = _child(data, *minf, b"stbl") if minf else None
        if stbl is None:
            raise UnsupportedVideo(f"{path}: MP4 video track without a sample table")
        return s, e, moov, stbl
    raise UnsupportedVideo(f"{path}: MP4 without a video track")


def parse(path: str, data) -> Track:
    """The first video track of the MP4 file whose bytes are ``data``."""
    s, e, moov, stbl = _video_trak(path, data)
    mdia = _child(data, s, e, b"mdia")
    matrix = None
    tkhd = _child(data, s, e, b"tkhd")
    if tkhd is not None:
        off = tkhd[0] + (52 if data[tkhd[0]] == 1 else 40)
        matrix = struct.unpack_from(">9i", data, off)
    mdhd = _child(data, *mdia, b"mdhd")
    timescale = 0
    if mdhd is not None:
        timescale = struct.unpack_from(">I", data, mdhd[0] + (20 if data[mdhd[0]] == 1 else 12))[0]
    track = _sample_table(data, *stbl, path, matrix)
    track.timescale = timescale
    track.media_time = _media_time(data, s, e)
    track.movie_duration = _movie_duration(data, *moov)
    return track


@dataclass
class AudioTrack:
    """The first audio track of an MP4 file: its sample entry's fourcc, for
    ``mp4a`` the ``esds``' objectTypeIndication and DecoderSpecificInfo (an
    AudioSpecificConfig for 0x40, MPEG-4 audio), the ``mdhd`` timescale, the
    sample table, and the first edit (the encoder's priming ``media_time``
    and the edit's length, in the media timescale; ``edit_duration`` None
    without an edit list)."""
    fourcc: str
    object_type: int
    config: bytes
    timescale: int
    sample_deltas: List[int]
    offsets: List[int]
    sizes: List[int]
    media_time: int = 0
    edit_duration: Optional[int] = None


def _movie_timescale(data, s: int, e: int) -> int:
    mvhd = _child(data, s, e, b"mvhd")
    if mvhd is None:
        return 0
    return struct.unpack_from(">I", data, mvhd[0] + (20 if data[mvhd[0]] == 1 else 12))[0]


def audio_track(path: str, data) -> Optional[AudioTrack]:
    """The first audio (``hdlr 'soun'``) track of the MP4 file whose bytes
    are ``data``, or None."""
    moov = _child(data, 0, len(data), b"moov")
    if moov is None:
        return None
    for kind, s, e in _boxes(data, *moov):
        if kind != b"trak":
            continue
        mdia = _child(data, s, e, b"mdia")
        hdlr = _child(data, *mdia, b"hdlr") if mdia else None
        if hdlr is None or bytes(data[hdlr[0] + 8:hdlr[0] + 12]) != b"soun":
            continue
        minf = _child(data, *mdia, b"minf")
        stbl = _child(data, *minf, b"stbl") if minf else None
        stsd = _child(data, *stbl, b"stsd") if stbl else None
        if stsd is None:
            raise UnsupportedVideo(f"{path}: MP4 audio track without a sample description")
        entries = list(_boxes(data, _full(data, stsd[0]) + 4, stsd[1]))
        if not entries:
            raise UnsupportedVideo(f"{path}: MP4 audio track without a sample entry")
        entry, es, ee = entries[0]
        version, = struct.unpack_from(">H", data, es + 8)
        children = es + 28 + {1: 16, 2: 36}.get(version, 0)
        object_type, config = 0, b""
        if entry == b"mp4a":
            esds = _child(data, children, ee, b"esds")
            if esds is not None:
                object_type, config = _esds(data, *esds)
        mdhd = _child(data, *mdia, b"mdhd")
        timescale = 0
        if mdhd is not None:
            timescale = struct.unpack_from(">I", data, mdhd[0] + (20 if data[mdhd[0]] == 1 else 12))[0]
        deltas, offsets, sizes = _samples(data, *stbl, path, "audio")
        track = AudioTrack(entry.decode("latin-1"), object_type, config, timescale, deltas, offsets, sizes)
        edit = _edit(data, s, e)
        if edit is not None:
            movie_scale = _movie_timescale(data, *moov)
            track.media_time = edit[0]
            track.edit_duration = edit[1] * timescale // movie_scale if movie_scale else None
        return track
    return None


def open_track(path: str):
    """The MP4 file at ``path`` opened and mapped, and its first video track
    -> (file, mmap, :class:`Track`); the caller closes the mmap, then the
    file."""
    f = open(path, "rb")
    try:
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except ValueError:
        f.close()
        raise UnsupportedVideo(f"{path}: empty file") from None
    try:
        return f, data, parse(path, data)
    except BaseException:
        data.close()
        f.close()
        raise


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
    """Appends video samples; :meth:`close` writes ``moov``.

    ``codec`` is ``"mp4v"`` (``config`` the VOS/VO/VOL headers) or ``"avc1"``
    (``config`` the ``avcC`` body).  The track's timescale is the frame rate's
    numerator doubled up to at least 10000 and every sample lasts
    ``timescale / fps``, as libavformat's mov muxer does; ``matrix`` is the
    ``tkhd`` display matrix."""

    def __init__(self, path: str, width: int, height: int, fps: float, config: bytes, codec: str = "mp4v",
                 matrix: Tuple[int, ...] = None):
        if codec not in ("mp4v", "avc1"):
            raise ValueError(f"Mp4Writer writes 'mp4v' or 'avc1', not {codec!r}")
        rate, scale = fps_rational(fps)
        self.path, self.width, self.height, self.config = path, width, height, config
        self.codec, self.matrix = codec, tuple(matrix or _IDENTITY)
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
        self._cto: List[int] = []
        self._audio = None

    def write(self, sample: bytes, sync: bool, composition_offset: int = 0) -> None:
        """Append one sample; ``composition_offset`` is in frame durations."""
        if sync:
            self._sync.append(len(self._sizes) + 1)
        self._f.write(sample)
        self._sizes.append(len(sample))
        self._cto.append(composition_offset * self.delta)
        self._pos += len(sample)

    def add_audio(self, config: bytes, sample_rate: int, channels: int, frames: Sequence[bytes],
                  priming: int = 1024) -> None:
        """An AAC track beside the video: its AudioSpecificConfig, rate,
        channels and access units (1024 samples each), written after the
        video samples as one chunk; an edit list starts it ``priming``
        samples in (the encoder's delay), as FFmpeg's mov muxer writes it."""
        self._audio = (config, sample_rate, channels, [bytes(f) for f in frames], priming)

    def close(self) -> None:
        if self._f is None:
            return
        try:
            if self._audio is not None:
                self._audio_at = self._pos
                for frame in self._audio[3]:
                    self._f.write(frame)
                    self._pos += len(frame)
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
        media_time = self._cto[0] if self._cto else 0
        audio_trak = self._audio_trak() if self._audio is not None else b""
        if self._audio is not None:
            movie_ms = max(movie_ms, self._audio_ms)
        mvhd = _fullbox(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, movie_ms),
                        struct.pack(">IH", 0x10000, 0x100), bytes(10), struct.pack(">9i", *_IDENTITY), bytes(24),
                        struct.pack(">I", 3 if self._audio is not None else 2))
        tkhd = _fullbox(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie_ms), bytes(8),
                        struct.pack(">hhH", 0, 0, 0), bytes(2), struct.pack(">9i", *self.matrix),
                        struct.pack(">II", self.width << 16, self.height << 16))
        edts = _box(b"edts", _fullbox(b"elst", 0, 0, struct.pack(">IIiHH", 1, movie_ms, media_time, 1, 0)))
        mdhd = _fullbox(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, self.timescale, duration),
                        struct.pack(">HH", 0x55C4, 0))
        hdlr = _fullbox(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"VideoHandler\x00")
        dinf = _box(b"dinf", _fullbox(b"dref", 0, 0, struct.pack(">I", 1), _fullbox(b"url ", 0, 1)))
        if self.codec == "avc1":
            decoder_config = _box(b"avcC", self.config)
        else:
            bitrate = int(sum(self._sizes) * 8 * self.timescale / max(duration, 1))
            dcd = _desc(0x04, bytes([0x20, 0x11]) + struct.pack(">I", max(self._sizes, default=0) * 8)[1:]
                        + struct.pack(">II", bitrate, bitrate) + _desc(0x05, self.config))
            decoder_config = _fullbox(b"esds", 0, 0, _desc(0x03, struct.pack(">HB", 1, 0) + dcd
                                                           + _desc(0x06, b"\x02")))
        entry = _box(self.codec.encode(), bytes(6), struct.pack(">H", 1), bytes(16),
                     struct.pack(">HHIIIH", self.width, self.height, 0x480000, 0x480000, 0, 1),
                     bytes(32), struct.pack(">Hh", 0x18, -1), decoder_config)
        stsd = _fullbox(b"stsd", 0, 0, struct.pack(">I", 1), entry)
        stts = _fullbox(b"stts", 0, 0, struct.pack(">III", 1, n, self.delta))
        ctts = b""
        if any(self._cto):
            runs: List[List[int]] = []
            for off in self._cto:
                if runs and runs[-1][1] == off:
                    runs[-1][0] += 1
                else:
                    runs.append([1, off])
            ctts = _fullbox(b"ctts", 0, 0, struct.pack(f">I{2 * len(runs)}I", len(runs),
                                                       *[v for run in runs for v in run]))
        stss = _fullbox(b"stss", 0, 0, struct.pack(f">I{len(self._sync)}I", len(self._sync), *self._sync))
        stsc = _fullbox(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
        stsz = _fullbox(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *self._sizes))
        stco = _fullbox(b"stco", 0, 0, struct.pack(">II", 1, self._mdat_at + 8))
        stbl = _box(b"stbl", stsd, stts, ctts, stss, stsc, stsz, stco)
        vmhd = _fullbox(b"vmhd", 0, 1, bytes(8))
        minf = _box(b"minf", vmhd, dinf, stbl)
        mdia = _box(b"mdia", mdhd, hdlr, minf)
        trak = _box(b"trak", tkhd, edts, mdia)
        udta = _box(b"udta", _fullbox(b"meta", 0, 0,
                                      _fullbox(b"hdlr", 0, 0, bytes(4), b"mdirappl", bytes(9)),
                                      _box(b"ilst", _box(b"\xa9too", _box(b"data", struct.pack(">II", 1, 0),
                                                                             _ENCODER)))))
        return _box(b"moov", mvhd, trak, audio_trak, udta)

    def _audio_trak(self) -> bytes:
        config, rate, channels, frames, priming = self._audio
        n = len(frames)
        duration = n * 1024
        self._audio_ms = max(0, duration - priming) * 1000 // rate
        tkhd = _fullbox(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 2, 0, self._audio_ms), bytes(8),
                        struct.pack(">hhH", 0, 1, 0x100), bytes(2), struct.pack(">9i", *_IDENTITY),
                        struct.pack(">II", 0, 0))
        edts = _box(b"edts", _fullbox(b"elst", 0, 0, struct.pack(">IIiHH", 1, self._audio_ms, priming, 1, 0)))
        mdhd = _fullbox(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, rate, duration), struct.pack(">HH", 0x55C4, 0))
        hdlr = _fullbox(b"hdlr", 0, 0, bytes(4), b"soun", bytes(12), b"SoundHandler\x00")
        dinf = _box(b"dinf", _fullbox(b"dref", 0, 0, struct.pack(">I", 1), _fullbox(b"url ", 0, 1)))
        bitrate = int(sum(map(len, frames)) * 8 * rate / max(duration, 1))
        dcd = _desc(0x04, bytes([0x40, 0x15]) + struct.pack(">I", max(map(len, frames), default=0))[1:]
                    + struct.pack(">II", bitrate, bitrate) + _desc(0x05, config))
        esds = _fullbox(b"esds", 0, 0, _desc(0x03, struct.pack(">HB", 2, 0) + dcd + _desc(0x06, b"\x02")))
        entry = _box(b"mp4a", bytes(6), struct.pack(">H", 1), bytes(8),
                     struct.pack(">HHHHI", channels, 16, 0, 0, min(rate, 0xFFFF) << 16), esds)
        stsd = _fullbox(b"stsd", 0, 0, struct.pack(">I", 1), entry)
        stts = _fullbox(b"stts", 0, 0, struct.pack(">III", 1, n, 1024))
        stsc = _fullbox(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
        stsz = _fullbox(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *map(len, frames)))
        stco = _fullbox(b"stco", 0, 0, struct.pack(">II", 1, self._audio_at))
        stbl = _box(b"stbl", stsd, stts, stsc, stsz, stco)
        minf = _box(b"minf", _fullbox(b"smhd", 0, 0, bytes(4)), dinf, stbl)
        return _box(b"trak", tkhd, edts, _box(b"mdia", mdhd, hdlr, minf))
