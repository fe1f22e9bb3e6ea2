"""MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile video: the bitstream.

The JAX package writes its clips with OpenCV's ``mp4v`` fourcc, which is
libavcodec's ``mpeg4`` encoder, and reads them back through libavcodec.  This
module is the port's own counterpart of the serial half of that codec, in
Python and numpy: the bit reader and writer, the VOS/VO/VOL/GOV/VOP headers,
the Annex B variable-length codes, and the macroblock layer of I- and P-VOPs.

:func:`decode_vop` parses one VOP into what reconstruction needs, per VOP
(``fvd_tpu_torch/ops/mpeg4.py`` does the rest, on the card or on the CPU):

* ``levels``: int16 ``[n_blocks, 64]``, the quantised levels of each 8x8
  block in raster order, after intra DC and AC prediction;
* ``qscale`` and ``intra``: int16 ``[n_mb]``;
* ``mv``: int16 ``[n_blocks, 2]``, each block's half-pel motion vector
  (x, y); the two chroma blocks of a macroblock hold its chroma vector;
* ``coded``: int16 ``[n_blocks]``, 1 where the block has a residual;
* ``rounding``: the VOP's ``rounding_type``.

Blocks are in macroblock raster order, six to a macroblock: Y0 Y1 Y2 Y3 Cb Cr.

:func:`encode_vop` writes an I- or P-VOP from quantised levels: I-VOPs with
DC prediction and no AC prediction, P-VOPs with the vector (0, 0) for every
coded macroblock and ``not_coded`` where all six blocks are zero.

Anything the Simple Profile lacks (B- and S-VOPs, interlace, quarter-pel,
``quant_type`` 1, data partitioning, resync markers, non-rectangular shape)
raises :class:`UnsupportedVideo` naming it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fvd_tpu_torch.utils.avi import UnsupportedVideo

VOS_START, VOS_END, USER_DATA, GOV_START, VO_START, VOP_START = 0x1B0, 0x1B1, 0x1B2, 0x1B3, 0x1B5, 0x1B6

# --- scans (Table 7-2, 7-3) -------------------------------------------------

ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
ALT_HORIZONTAL = (
    0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63)
ALT_VERTICAL = (
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63)

# --- variable-length codes (Annex B), as (code, length) ---------------------

#: MCBPC for I-VOPs (Table B-6): index = 4 * (mb_type - 3) + cbpc, 8 = stuffing
MCBPC_I = ((1, 1), (1, 3), (2, 3), (3, 3), (1, 4), (1, 6), (2, 6), (3, 6), (1, 9))
#: MCBPC for P-VOPs (Table B-7): index = 4 * mb_type + cbpc, 20 = stuffing;
#: mb_type 0 inter, 1 inter+q, 2 inter4v, 3 intra, 4 intra+q
MCBPC_P = ((1, 1), (3, 4), (2, 4), (5, 6), (3, 3), (7, 7), (6, 7), (5, 9),
           (2, 3), (5, 7), (4, 7), (5, 8), (3, 5), (4, 8), (3, 8), (3, 7),
           (4, 6), (4, 9), (3, 9), (2, 9), (1, 9))
#: CBPY (Table B-8), index = cbpy of an intra macroblock (15 - cbpy for inter)
CBPY = ((3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
        (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2))
#: MVD magnitude codes 0..32 (Table B-12), a sign bit follows all but 0
MVD = ((1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7),
       (11, 9), (10, 9), (9, 9), (17, 10), (16, 10), (15, 10), (14, 10), (13, 10),
       (12, 10), (11, 10), (10, 10), (9, 10), (8, 10), (7, 10), (6, 10), (5, 10),
       (4, 10), (7, 11), (6, 11), (5, 11), (4, 11), (3, 11), (2, 11), (3, 12), (2, 12))
#: dct_dc_size_luminance 0..12 (Table B-13)
DC_LUMA = ((3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6),
           (1, 7), (1, 8), (1, 9), (1, 10), (1, 11))
#: dct_dc_size_chrominance 0..12 (Table B-14)
DC_CHROMA = ((3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7),
             (1, 8), (1, 9), (1, 10), (1, 11), (1, 12))


def _runs_levels(lmax0, lmax1):
    """(last, run, level) of each table index from the LMAX of each run."""
    out = []
    for last, lmax in ((0, lmax0), (1, lmax1)):
        for run, top in enumerate(lmax):
            out += [(last, run, lvl) for lvl in range(1, top + 1)]
    return tuple(out)


#: TCOEF for intra blocks (Table B-16): codes without the sign bit; index 102
#: is the escape
TCOEF_INTRA_CODES = (
    (0x2, 2), (0x6, 3), (0xf, 4), (0xd, 5), (0xc, 5), (0x15, 6), (0x13, 6), (0x12, 6),
    (0x17, 7), (0x1f, 8), (0x1e, 8), (0x1d, 8), (0x25, 9), (0x24, 9), (0x23, 9), (0x21, 9),
    (0x21, 10), (0x20, 10), (0xf, 10), (0xe, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x21, 11),
    (0x50, 12), (0x51, 12), (0x52, 12), (0xe, 4), (0x14, 6), (0x16, 7), (0x1c, 8), (0x20, 9),
    (0x1f, 9), (0xd, 10), (0x22, 11), (0x53, 12), (0x55, 12), (0xb, 5), (0x15, 7), (0x1e, 9),
    (0xc, 10), (0x56, 12), (0x11, 6), (0x1b, 8), (0x1d, 9), (0xb, 10), (0x10, 6), (0x22, 9),
    (0xa, 10), (0xd, 6), (0x1c, 9), (0x8, 10), (0x12, 7), (0x1b, 9), (0x54, 12), (0x14, 7),
    (0x1a, 9), (0x57, 12), (0x19, 8), (0x9, 10), (0x18, 8), (0x23, 11), (0x17, 8), (0x19, 9),
    (0x18, 9), (0x7, 10), (0x58, 12), (0x7, 4), (0xc, 6), (0x16, 8), (0x17, 9), (0x6, 10),
    (0x5, 11), (0x4, 11), (0x59, 12), (0xf, 6), (0x16, 9), (0x5, 10), (0xe, 6), (0x4, 10),
    (0x11, 7), (0x24, 11), (0x10, 7), (0x25, 11), (0x13, 7), (0x5a, 12), (0x15, 8), (0x5b, 12),
    (0x14, 8), (0x13, 8), (0x1a, 8), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9),
    (0x26, 11), (0x27, 11), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12), (0x3, 7))
TCOEF_INTRA_RLL = _runs_levels((27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1),
                               (8, 3, 2, 2, 2, 2, 2) + (1,) * 14)
#: TCOEF for inter blocks (Table B-17), the H.263 table
TCOEF_INTER_CODES = (
    (0x2, 2), (0xf, 4), (0x15, 6), (0x17, 7), (0x1f, 8), (0x25, 9), (0x24, 9), (0x21, 10),
    (0x20, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x6, 3), (0x14, 6), (0x1e, 8), (0xf, 10),
    (0x21, 11), (0x50, 12), (0xe, 4), (0x1d, 8), (0xe, 10), (0x51, 12), (0xd, 5), (0x23, 9),
    (0xd, 10), (0xc, 5), (0x22, 9), (0x52, 12), (0xb, 5), (0xc, 10), (0x53, 12), (0x13, 6),
    (0xb, 10), (0x54, 12), (0x12, 6), (0xa, 10), (0x11, 6), (0x9, 10), (0x10, 6), (0x8, 10),
    (0x16, 7), (0x55, 12), (0x15, 7), (0x14, 7), (0x1c, 8), (0x1b, 8), (0x21, 9), (0x20, 9),
    (0x1f, 9), (0x1e, 9), (0x1d, 9), (0x1c, 9), (0x1b, 9), (0x1a, 9), (0x22, 11), (0x23, 11),
    (0x56, 12), (0x57, 12), (0x7, 4), (0x19, 9), (0x5, 11), (0xf, 6), (0x4, 11), (0xe, 6),
    (0xd, 6), (0xc, 6), (0x13, 7), (0x12, 7), (0x11, 7), (0x10, 7), (0x1a, 8), (0x19, 8),
    (0x18, 8), (0x17, 8), (0x16, 8), (0x15, 8), (0x14, 8), (0x13, 8), (0x18, 9), (0x17, 9),
    (0x16, 9), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9), (0x7, 10), (0x6, 10),
    (0x5, 10), (0x4, 10), (0x24, 11), (0x25, 11), (0x26, 11), (0x27, 11), (0x58, 12), (0x59, 12),
    (0x5a, 12), (0x5b, 12), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12), (0x3, 7))
TCOEF_INTER_RLL = _runs_levels((12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2) + (1,) * 16,
                               (3, 2) + (1,) * 39)
ESCAPE = 102

#: dc_scaler of Table 7-1 for qscale 0..31, luma and chroma
DC_SCALE_LUMA = tuple(0 if q == 0 else 8 if q <= 4 else 2 * q if q <= 8 else q + 8 if q <= 24
                      else 2 * q - 16 for q in range(32))
DC_SCALE_CHROMA = tuple(0 if q == 0 else 8 if q <= 4 else (q + 13) // 2 if q <= 24 else q - 6
                        for q in range(32))
#: intra_dc_vlc_thr 0..7 -> the qscale from which DC is coded as an AC coefficient
DC_THRESHOLD = (99, 13, 15, 17, 19, 21, 23, 0)
DQUANT = (-1, -2, 1, 2)


def _lut(codes, symbols=None):
    """(bits, table): ``table[peek(bits)] = (symbol, length)`` for a prefix code."""
    bits = max(n for _, n in codes)
    table: List[Optional[Tuple[int, int]]] = [None] * (1 << bits)
    for i, (code, n) in enumerate(codes):
        sym = i if symbols is None else symbols[i]
        base = code << (bits - n)
        for j in range(1 << (bits - n)):
            if table[base + j] is not None:
                raise AssertionError(f"code {i} is not prefix-free")
            table[base + j] = (sym, n)
    return bits, table


def _rl_tables(codes, rll):
    """The decode table and the per-(last, run) LMAX and per-(last, level)
    RMAX of one TCOEF table."""
    lmax: Dict[Tuple[int, int], int] = {}
    rmax: Dict[Tuple[int, int], int] = {}
    for last, run, level in rll:
        lmax[last, run] = max(lmax.get((last, run), 0), level)
        rmax[last, level] = max(rmax.get((last, level), 0), run)
    enc = {rl: codes[i] for i, rl in enumerate(rll)}
    return _lut(codes, list(rll) + [None]), lmax, rmax, enc


_INTRA = _rl_tables(TCOEF_INTRA_CODES, TCOEF_INTRA_RLL)
_INTER = _rl_tables(TCOEF_INTER_CODES, TCOEF_INTER_RLL)
_MCBPC_I = _lut(MCBPC_I)
_MCBPC_P = _lut(MCBPC_P)
_CBPY = _lut(CBPY)
_MVD = _lut(MVD)
_DC_LUMA = _lut(DC_LUMA)
_DC_CHROMA = _lut(DC_CHROMA)


# --- bit I/O ------------------------------------------------------------------

class BitReader:
    """MSB-first reader over a byte string."""

    __slots__ = ("buf", "pos", "size")

    def __init__(self, data: bytes, pos: int = 0):
        self.buf = bytes(data) + bytes(8)
        self.pos = pos
        self.size = len(data) * 8

    def peek(self, n: int) -> int:
        p = self.pos
        v = int.from_bytes(self.buf[p >> 3:(p >> 3) + 5], "big")
        return (v >> (40 - (p & 7) - n)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.peek(n)
        self.pos += n
        return v

    def bit(self) -> int:
        p = self.pos
        self.pos = p + 1
        return (self.buf[p >> 3] >> (7 - (p & 7))) & 1

    def vlc(self, lut):
        bits, table = lut
        entry = table[self.peek(bits)]
        if entry is None or self.pos + entry[1] > self.size:
            raise UnsupportedVideo(f"invalid variable-length code at bit {self.pos}")
        self.pos += entry[1]
        return entry[0]

    def marker(self, what: str) -> None:
        if not self.bit():
            raise UnsupportedVideo(f"missing marker bit after {what}")

    def left(self) -> int:
        return self.size - self.pos


class BitWriter:
    """MSB-first writer."""

    def __init__(self):
        self._out = bytearray()
        self._acc = 0
        self._n = 0

    def put(self, n: int, value: int) -> None:
        self._acc = (self._acc << n) | (value & ((1 << n) - 1))
        self._n += n
        if self._n >= 64:  # flush the whole bytes, keep the accumulator small
            rem = self._n & 7
            self._out += (self._acc >> rem).to_bytes(self._n >> 3, "big")
            self._acc &= (1 << rem) - 1
            self._n = rem

    def code(self, code: Tuple[int, int]) -> None:
        self.put(code[1], code[0])

    def stuffing(self) -> None:
        """MPEG-4 stuffing: a 0 and then 1s up to the byte boundary."""
        self.put(1, 0)
        if self._n & 7:
            self.put(8 - (self._n & 7), 0xFF)

    def align_zero(self) -> None:
        if self._n & 7:
            self.put(8 - (self._n & 7), 0)

    def start_code(self, code: int) -> None:
        self.align_zero()
        self.put(32, code)

    def getvalue(self) -> bytes:
        assert self._n % 8 == 0, "unaligned"
        return bytes(self._out) + self._acc.to_bytes(self._n >> 3, "big")


# --- headers ------------------------------------------------------------------

@dataclass
class VOL:
    """What decoding needs of a video object layer header."""
    width: int
    height: int
    time_resolution: int
    time_bits: int
    resync_marker_disable: int = 1
    quant_precision: int = 5

    @property
    def mb_w(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_h(self) -> int:
        return (self.height + 15) // 16


def start_codes(data: bytes) -> List[Tuple[int, int]]:
    """(code, offset of the payload) of each ``00 00 01 xx`` start code."""
    out, pos = [], 0
    while True:
        i = data.find(b"\x00\x00\x01", pos)
        if i < 0 or i + 3 >= len(data):
            return out
        out.append((0x100 | data[i + 3], i + 4))
        pos = i + 3


def parse_vol(data: bytes, off: int) -> VOL:
    """The video_object_layer header whose payload starts at byte ``off``."""
    r = BitReader(data, off * 8)
    r.bit()  # random_accessible_vol
    r.read(8)  # video_object_type_indication
    verid = 1
    if r.bit():  # is_object_layer_identifier
        verid = r.read(4)
        r.read(3)
    if r.read(4) == 15:  # aspect_ratio_info: extended PAR
        r.read(16)
    if r.bit():  # vol_control_parameters
        if r.read(2) != 1:
            raise UnsupportedVideo("MPEG-4 video with a chroma format other than 4:2:0")
        r.bit()  # low_delay
        if r.bit():  # vbv_parameters
            r.read(15); r.marker("first_half_bit_rate"); r.read(15); r.marker("latter_half_bit_rate")
            r.read(15); r.marker("first_half_vbv_buffer_size"); r.read(3); r.read(11)
            r.marker("first_half_vbv_occupancy"); r.read(15); r.marker("latter_half_vbv_occupancy")
    shape = r.read(2)
    if shape != 0:
        raise UnsupportedVideo(f"MPEG-4 video with non-rectangular shape ({shape})")
    r.marker("video_object_layer_shape")
    res = r.read(16)
    if res == 0:
        raise UnsupportedVideo("MPEG-4 video with vop_time_increment_resolution 0")
    time_bits = max(1, (res - 1).bit_length())
    r.marker("vop_time_increment_resolution")
    if r.bit():  # fixed_vop_rate
        r.read(time_bits)
    r.marker("fixed_vop_rate")
    width = r.read(13)
    r.marker("video_object_layer_width")
    height = r.read(13)
    r.marker("video_object_layer_height")
    if r.bit():
        raise UnsupportedVideo("interlaced MPEG-4 video")
    r.bit()  # obmc_disable
    if r.read(1 if verid == 1 else 2):
        raise UnsupportedVideo("MPEG-4 video with sprites (S-VOPs)")
    quant_precision = 5
    if r.bit():  # not_8_bit
        quant_precision = r.read(4)
        if r.read(4) != 8:
            raise UnsupportedVideo("MPEG-4 video of other than 8 bits a pixel")
    if r.bit():
        raise UnsupportedVideo("MPEG-4 video with quant_type 1 (MPEG quantisation matrices)")
    if verid != 1 and r.bit():
        raise UnsupportedVideo("MPEG-4 video with quarter-pel motion")
    if not r.bit():
        raise UnsupportedVideo("MPEG-4 video with a complexity estimation header")
    resync_disable = r.bit()
    if r.bit():
        raise UnsupportedVideo("MPEG-4 video with data partitioning")
    if verid != 1:
        if r.bit():
            raise UnsupportedVideo("MPEG-4 video with newpred")
        if r.bit():
            raise UnsupportedVideo("MPEG-4 video with reduced-resolution VOPs")
    if r.bit():
        raise UnsupportedVideo("MPEG-4 video with scalability")
    if width == 0 or height == 0:
        raise UnsupportedVideo(f"MPEG-4 video of size {width}x{height}")
    return VOL(width, height, res, time_bits, resync_disable, quant_precision)


def find_vol(data: bytes) -> Optional[VOL]:
    for code, off in start_codes(data):
        if 0x120 <= code <= 0x12F:
            return parse_vol(data, off)
    return None


def write_headers(width: int, height: int, time_resolution: int) -> bytes:
    """VOS, VO and VOL headers of a Simple Profile stream (the
    DecoderSpecificInfo of an ``mp4v`` sample entry)."""
    w = BitWriter()
    w.start_code(VOS_START)
    w.put(8, 0x01)            # Simple Profile, level 1
    w.start_code(VO_START)
    w.put(1, 1); w.put(4, 1); w.put(3, 1)  # is_visual_object_identifier, verid 1, priority 1
    w.put(4, 1)               # visual_object_type: video
    w.put(1, 0)               # video_signal_type
    w.stuffing()
    w.start_code(0x100)       # video_object_start_code
    w.start_code(0x120)       # video_object_layer_start_code
    w.put(1, 0)               # random_accessible_vol
    w.put(8, 1)               # video_object_type_indication: Simple
    w.put(1, 1); w.put(4, 1); w.put(3, 1)  # is_object_layer_identifier, verid 1, priority 1
    w.put(4, 1)               # aspect_ratio_info: square pixels
    w.put(1, 1); w.put(2, 1); w.put(1, 1); w.put(1, 0)  # vol_control: 4:2:0, low_delay, no vbv
    w.put(2, 0)               # rectangular
    w.put(1, 1); w.put(16, time_resolution); w.put(1, 1)
    w.put(1, 0)               # fixed_vop_rate
    w.put(1, 1); w.put(13, width); w.put(1, 1); w.put(13, height); w.put(1, 1)
    w.put(1, 0)               # interlaced
    w.put(1, 1)               # obmc_disable
    w.put(1, 0)               # sprite_enable
    w.put(1, 0)               # not_8_bit
    w.put(1, 0)               # quant_type: H.263
    w.put(1, 1)               # complexity_estimation_disable
    w.put(1, 1)               # resync_marker_disable
    w.put(1, 0)               # data_partitioned
    w.put(1, 0)               # scalability
    w.stuffing()
    return w.getvalue()


def write_gov() -> bytes:
    """A group_of_vop header at time code 0, closed."""
    w = BitWriter()
    w.start_code(GOV_START)
    w.put(5, 0); w.put(6, 0); w.put(1, 1); w.put(6, 0)  # time code
    w.put(1, 1)  # closed_gov
    w.put(1, 0)  # broken_link
    w.stuffing()
    return w.getvalue()


# --- the macroblock layer -----------------------------------------------------

@dataclass
class VopData:
    """One parsed VOP (see the module docstring)."""
    kind: str                 # "I", "P", or "N" (vop_coded 0: repeat the previous frame)
    rounding: int
    levels: np.ndarray        # int16 [n_blocks, 64]
    qscale: np.ndarray        # int16 [n_mb]
    intra: np.ndarray         # int16 [n_mb]
    mv: np.ndarray            # int16 [n_blocks, 2]
    coded: np.ndarray         # int16 [n_blocks]


def _median(a: int, b: int, c: int) -> int:
    return max(min(a, b), min(max(a, b), c))


_CHROMA_ROUND = (0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2)


def chroma_mv_1(v: int) -> int:
    """The chroma half-pel component of a 1MV macroblock's luma component."""
    return (v >> 1) | (v & 1)


def chroma_mv_4(total: int) -> int:
    """The chroma half-pel component from the sum of the four luma vectors'
    components (Table 7-9)."""
    return _CHROMA_ROUND[total & 15] + ((total >> 4) << 1)


class _IntraState:
    """DC values (scaled) and first row/column AC levels of the intra blocks of
    one VOP, for DC and AC prediction.  A fresh state per VOP: a neighbour that
    is outside the VOP or not intra in it keeps the defaults, 1024 and zeros."""

    _ZEROS = (0,) * 8

    def __init__(self, mb_w: int, mb_h: int):
        # luma grid (2 mb_h) x (2 mb_w), chroma grids mb_h x mb_w, flat, each
        # with a border row and column of defaults at index 0
        self.stride = (2 * mb_w + 1, mb_w + 1, mb_w + 1)
        self.dc = [[1024] * ((2 * mb_h + 1) * (2 * mb_w + 1)), [1024] * ((mb_h + 1) * (mb_w + 1)),
                   [1024] * ((mb_h + 1) * (mb_w + 1))]
        self.ac_left: Dict[Tuple[int, int], List[int]] = {}
        self.ac_top: Dict[Tuple[int, int], List[int]] = {}

    def where(self, n: int, mb_x: int, mb_y: int) -> Tuple[int, int]:
        """(grid, flat index) of block ``n`` of macroblock (mb_x, mb_y)."""
        if n < 4:
            return 0, (2 * mb_y + (n >> 1) + 1) * self.stride[0] + 2 * mb_x + (n & 1) + 1
        return n - 3, (mb_y + 1) * self.stride[1] + mb_x + 1

    def dc_pred(self, g: int, i: int, scale: int) -> Tuple[int, int]:
        """(predicted DC level, direction: 0 left, 1 top) of the block at
        flat index ``i`` of grid ``g``."""
        d = self.dc[g]
        up = i - self.stride[g]
        a, b, c = d[i - 1], d[up - 1], d[up]
        if abs(a - b) < abs(b - c):
            return (c + (scale >> 1)) // scale, 1
        return (a + (scale >> 1)) // scale, 0

    def store_dc(self, g: int, i: int, level: int, scale: int) -> None:
        v = level * scale
        self.dc[g][i] = 0 if v < 0 else 2047 if v > 2047 else v


def vop_header(sample: bytes, vol: VOL) -> Tuple[int, VOL]:
    """(byte offset of the VOP's payload, the VOL in force for it) of one
    MP4 sample: the headers before the VOP are read, a VOL among them
    replacing ``vol``; a sample without a VOP, or with a start code the
    Simple Profile does not use, raises."""
    for code, off in start_codes(sample):
        if 0x120 <= code <= 0x12F:
            vol = parse_vol(sample, off)
        elif code == VOP_START:
            return off, vol
        elif code in (VOS_START, VO_START, GOV_START, USER_DATA, VOS_END) or code <= 0x11F:
            continue
        else:
            raise UnsupportedVideo(f"MPEG-4 video with start code 0x{code:03X}")
    raise UnsupportedVideo("MPEG-4 sample without a VOP")


def scan_samples(samples: Sequence[bytes], vol: VOL) -> Tuple[bytes, List[Tuple[int, int, int]], List[int],
                                                              List[VOL]]:
    """The samples of a range of VOPs, the first parsed under ``vol``, as
    :func:`fvd_tpu_torch.ops.mpeg4.parse_vops` takes them: (their bytes
    joined, each VOP's (sample start, VOP payload start, sample end) in
    them, the index of the VOL in force for each, the VOLs from ``vol`` on,
    one more each time a sample holds a VOL header)."""
    offsets, vol_ids, vols = [], [], [vol]
    at = 0
    for sample in samples:
        vop, v = vop_header(sample, vols[-1])
        if v is not vols[-1]:
            vols.append(v)
        offsets.append((at, at + vop, at + len(sample)))
        vol_ids.append(len(vols) - 1)
        at += len(sample)
    return b"".join(samples), offsets, vol_ids, vols


def _rounded_div(a: int, b: int) -> int:
    return (a + (b >> 1)) // b if a >= 0 else -((-a + (b >> 1)) // b)


class Decoder:
    """Parses the VOPs of one stream in order; keeps the VOL."""

    def __init__(self, vol: VOL):
        self.vol = vol
        self.n_mb = vol.mb_w * vol.mb_h

    def decode(self, sample: bytes) -> VopData:
        """The VOP of one MP4 sample (headers before it are read and, for a
        VOL, adopted)."""
        vop_off, vol = vop_header(sample, self.vol)
        if vol is not self.vol:
            self.vol = vol
            self.n_mb = vol.mb_w * vol.mb_h
        return self._vop(sample, vop_off)

    def _vop(self, data: bytes, off: int) -> VopData:
        vol = self.vol
        r = BitReader(data, off * 8)
        ctype = r.read(2)
        if ctype == 2:
            raise UnsupportedVideo("MPEG-4 video with B-VOPs")
        if ctype == 3:
            raise UnsupportedVideo("MPEG-4 video with S-VOPs (sprites)")
        while r.bit():  # modulo_time_base
            if r.left() <= 0:
                raise UnsupportedVideo("truncated VOP header")
        r.marker("modulo_time_base")
        r.read(vol.time_bits)
        r.marker("vop_time_increment")
        n_blocks = self.n_mb * 6
        levels = np.zeros((n_blocks, 64), np.int16)
        mv = np.zeros((n_blocks, 2), np.int16)
        coded = np.zeros(n_blocks, np.int16)
        qscale = np.zeros(self.n_mb, np.int16)
        intra = np.zeros(self.n_mb, np.int16)
        if not r.bit():  # vop_coded
            return VopData("N", 0, levels, qscale, intra, mv, coded)
        rounding = r.bit() if ctype == 1 else 0
        dc_thr = DC_THRESHOLD[r.read(3)]
        q = r.read(vol.quant_precision)
        if q == 0:
            raise UnsupportedVideo("MPEG-4 VOP with vop_quant 0")
        f_code = r.read(3) if ctype == 1 else 1
        if f_code == 0:
            raise UnsupportedVideo("MPEG-4 VOP with vop_fcode_forward 0")
        self._mbs(r, ctype, q, f_code, dc_thr, levels, mv, coded, qscale, intra)
        return VopData("I" if ctype == 0 else "P", rounding, levels, qscale, intra, mv, coded)

    def _mbs(self, r: BitReader, ctype, q, f_code, dc_thr, levels, mv, coded, qscale, intra):
        vol = self.vol
        mb_w, mb_h = vol.mb_w, vol.mb_h
        st = _IntraState(mb_w, mb_h)
        # luma block vectors, flat, with a zero border: rows 2 mb_h + 1, cols 2 mb_w + 2
        stride = 2 * mb_w + 2
        mvx = [0] * ((2 * mb_h + 1) * stride)
        mvy = [0] * len(mvx)
        qlist: List[int] = []
        intra_mbs: List[int] = []
        intra_rows: List[List[int]] = []  # the intra blocks' levels, six a macroblock
        resync_bits = 0 if vol.resync_marker_disable else (17 if ctype == 0 else 16 + f_code)
        for mb_y in range(mb_h):
            for mb_x in range(mb_w):
                if resync_bits and r.peek(resync_bits) == 1:
                    raise UnsupportedVideo("MPEG-4 video with resync markers (video packets)")
                b0 = len(qlist) * 6
                if ctype == 1:
                    # not_coded, then MCBPC; a stuffing code repeats both
                    while True:
                        not_coded = r.bit()
                        if not_coded:
                            break
                        sym = r.vlc(_MCBPC_P)
                        if sym != 20:
                            break
                    if not_coded:  # the vector (0, 0), no residual
                        qlist.append(q)
                        continue
                    mb_type, cbpc = sym >> 2, sym & 3
                else:
                    while True:
                        sym = r.vlc(_MCBPC_I)
                        if sym != 8:
                            break
                    mb_type, cbpc = 3 + (sym >> 2), sym & 3
                is_intra = mb_type >= 3
                ac_pred = r.bit() if is_intra else 0
                cbpy = r.vlc(_CBPY)
                if not is_intra:
                    cbpy ^= 15
                use_dc_vlc = q < dc_thr
                if mb_type in (1, 4):
                    q = min(31, max(1, q + DQUANT[r.read(2)]))
                qlist.append(q)
                cbp = (cbpy << 2) | cbpc
                if is_intra:
                    intra_mbs.append(len(qlist) - 1)
                    for n in range(6):
                        intra_rows.append(self._intra_block(r, st, n, mb_x, mb_y, q, qlist,
                                                            (cbp >> (5 - n)) & 1, ac_pred, use_dc_vlc))
                    continue
                base = (2 * mb_y + 1) * stride + 2 * mb_x + 1
                if mb_type == 2:
                    vecs = []
                    for n in range(4):
                        px, py = self._pred_mv(mvx, mvy, stride, base, mb_x, mb_y, n)
                        v = (self._mvd(r, px, f_code), self._mvd(r, py, f_code))
                        i = base + (n >> 1) * stride + (n & 1)
                        mvx[i], mvy[i] = v
                        vecs.append(v)
                    cx = chroma_mv_4(sum(v[0] for v in vecs))
                    cy = chroma_mv_4(sum(v[1] for v in vecs))
                else:
                    px, py = self._pred_mv(mvx, mvy, stride, base, mb_x, mb_y, 0)
                    v = (self._mvd(r, px, f_code), self._mvd(r, py, f_code))
                    vecs = [v] * 4
                    for i in (base, base + 1, base + stride, base + stride + 1):
                        mvx[i], mvy[i] = v
                    cx, cy = chroma_mv_1(v[0]), chroma_mv_1(v[1])
                if any(vecs[0]) or any(vecs[1]) or any(vecs[2]) or any(vecs[3]):
                    mv[b0:b0 + 4] = vecs
                    mv[b0 + 4:b0 + 6] = (cx, cy)
                for n in range(6):
                    if (cbp >> (5 - n)) & 1:
                        self._tcoef(r, levels[b0 + n], 0, ZIGZAG, _INTER)
                        coded[b0 + n] = 1
        qscale[:] = qlist
        if intra_mbs:
            intra[intra_mbs] = 1
            blocks = (np.asarray(intra_mbs)[:, None] * 6 + np.arange(6)).reshape(-1)
            levels[blocks] = intra_rows
            coded[blocks] = 1

    @staticmethod
    def _pred_mv(mvx, mvy, stride, base, mb_x, mb_y, n):
        """The median predictor of block ``n`` (7.6.5) from the flat vector
        grids (``base``: block 0 of the macroblock): a candidate outside the
        VOP counts as 0, except on the first row where only the left one
        exists."""
        i = base + (n >> 1) * stride + (n & 1)
        a = i - 1
        if mb_y == 0 and n < 2:
            if n == 0 and mb_x == 0:
                return 0, 0
            return mvx[a], mvy[a]
        b = i - stride
        # above-right of the macroblock for blocks 0 and 1; within it for 2 and 3
        c = (b + 2 - (n & 1)) if n < 2 else (b + 1 - 2 * (n & 1))
        return (_median(mvx[a], mvx[b], mvx[c]), _median(mvy[a], mvy[b], mvy[c]))

    @staticmethod
    def _mvd(r: BitReader, pred: int, f_code: int) -> int:
        code = r.vlc(_MVD)
        if code == 0:
            return pred
        sign = r.bit()
        shift = f_code - 1
        val = code
        if shift:
            val = (((val - 1) << shift) | r.read(shift)) + 1
        if sign:
            val = -val
        val += pred
        bits = 5 + f_code  # modulo into [-32 f, 32 f - 1]
        val &= (1 << bits) - 1
        return val - (1 << bits) if val >= 1 << (bits - 1) else val

    def _intra_block(self, r, st: _IntraState, n, mb_x, mb_y, q, qlist, coded, ac_pred, use_dc_vlc):
        """One intra block's 64 levels (raster order, after prediction);
        ``qlist`` holds the qscale of every macroblock so far, this one last."""
        if n < 4:
            scale, g = DC_SCALE_LUMA[q], 0
            i = (2 * mb_y + (n >> 1) + 1) * st.stride[0] + 2 * mb_x + (n & 1) + 1
        else:
            scale, g = DC_SCALE_CHROMA[q], n - 3
            i = (mb_y + 1) * st.stride[g] + mb_x + 1
        d = st.dc[g]
        up = i - st.stride[g]
        a, b, c = d[i - 1], d[up - 1], d[up]
        if abs(a - b) < abs(b - c):
            pred_dc, direction = (c + (scale >> 1)) // scale, 1
        else:
            pred_dc, direction = (a + (scale >> 1)) // scale, 0
        blk = [0] * 64
        if use_dc_vlc:
            size = r.vlc(_DC_LUMA if n < 4 else _DC_CHROMA)
            diff = 0
            if size:
                v = r.read(size)
                diff = v if v >> (size - 1) else v - (1 << size) + 1
                if size > 8:
                    r.marker("dct_dc_differential")
            if coded:
                self._tcoef(r, blk, 1, (ALT_VERTICAL if direction == 0 else ALT_HORIZONTAL)
                            if ac_pred else ZIGZAG, _INTRA)
            dc = pred_dc + diff
        else:
            if coded:
                self._tcoef(r, blk, 0, (ALT_VERTICAL if direction == 0 else ALT_HORIZONTAL)
                            if ac_pred else ZIGZAG, _INTRA)
            dc = pred_dc + blk[0]
        blk[0] = dc
        v = dc * scale
        d[i] = 0 if v < 0 else 2047 if v > 2047 else v
        if ac_pred:
            mb = len(qlist) - 1
            if direction == 0:  # left: the first column
                nb = st.ac_left.get((g, i - 1), _IntraState._ZEROS)
                nq = qlist[mb - 1] if mb_x > 0 else q
                rescale = not (mb_x == 0 or nq == q or n in (1, 3))
                for k in range(1, 8):
                    blk[k * 8] += _rounded_div(nb[k] * nq, q) if rescale else nb[k]
            else:  # top: the first row
                nb = st.ac_top.get((g, up), _IntraState._ZEROS)
                nq = qlist[mb - self.vol.mb_w] if mb_y > 0 else q
                rescale = not (mb_y == 0 or nq == q or n in (2, 3))
                for k in range(1, 8):
                    blk[k] += _rounded_div(nb[k] * nq, q) if rescale else nb[k]
            st.ac_left[g, i] = blk[0:64:8]
            st.ac_top[g, i] = blk[0:8]
        elif any(blk[8:64:8]) or any(blk[1:8]):
            st.ac_left[g, i] = blk[0:64:8]
            st.ac_top[g, i] = blk[0:8]
        return blk

    @staticmethod
    def _tcoef(r: BitReader, out, i, scan, tables):
        """Run/level pairs into ``out`` (raster order) from scan position
        ``i``.  The common codes are read inline from the bytes (a 12-bit
        code and its sign bit fit in 3 bytes at any bit offset); escapes go
        through the reader."""
        (bits, table), lmax, rmax, _ = tables
        buf, p, size = r.buf, r.pos, r.size
        top = 24 - bits
        mask = (1 << bits) - 1
        i -= 1
        while True:
            q = p >> 3
            entry = table[(int.from_bytes(buf[q:q + 3], "big") >> (top - (p & 7))) & mask]
            if entry is None or p + entry[1] > size:
                raise UnsupportedVideo(f"invalid TCOEF code at bit {p}")
            rll, n = entry
            p += n
            if rll is None:  # escape
                r.pos = p
                last, run, level = Decoder._escape(r, bits, table, lmax, rmax)
                p = r.pos
            else:
                last, run, level = rll
                if (buf[p >> 3] >> (7 - (p & 7))) & 1:
                    level = -level
                p += 1
            i += run + 1
            if i > 63:
                raise UnsupportedVideo(f"TCOEF run past the block end at bit {p}")
            out[scan[i]] = level
            if last:
                r.pos = p
                return

    @staticmethod
    def _escape(r: BitReader, bits, table, lmax, rmax) -> Tuple[int, int, int]:
        """(last, run, signed level) of an escaped TCOEF (the escape code read)."""
        if not r.bit():  # type 1: level offset
            rll, n = table[r.peek(bits)] or (None, 0)
            if rll is None:
                raise UnsupportedVideo(f"invalid TCOEF escape at bit {r.pos}")
            r.pos += n
            last, run, level = rll
            level += lmax[last, run]
        elif not r.bit():  # type 2: run offset
            rll, n = table[r.peek(bits)] or (None, 0)
            if rll is None:
                raise UnsupportedVideo(f"invalid TCOEF escape at bit {r.pos}")
            r.pos += n
            last, run, level = rll
            run += rmax[last, level] + 1
        else:  # type 3: fixed length
            last = r.bit()
            run = r.read(6)
            r.marker("escape run")
            level = r.read(12)
            if level >= 2048:
                level -= 4096
            r.marker("escape level")
            if level == 0:
                raise UnsupportedVideo(f"TCOEF escape with level 0 at bit {r.pos}")
            return last, run, level
        return last, run, -level if r.bit() else level


# --- encoding -----------------------------------------------------------------

def _put_tcoef(w: BitWriter, coefs: List[Tuple[int, int]], tables) -> None:
    """(run, level) pairs, the last one flagged."""
    _, lmax, rmax, enc = tables
    esc = (TCOEF_INTRA_CODES if tables is _INTRA else TCOEF_INTER_CODES)[ESCAPE]
    for k, (run, level) in enumerate(coefs):
        last = int(k == len(coefs) - 1)
        a, s = abs(level), int(level < 0)
        code = enc.get((last, run, a))
        if code is not None:
            w.put(code[1] + 1, (code[0] << 1) | s)
            continue
        lm = lmax.get((last, run))
        if lm is not None and a > lm and (last, run, a - lm) in enc:
            w.code(esc); w.put(1, 0)
            w.code(enc[last, run, a - lm]); w.put(1, s)
            continue
        rm = rmax.get((last, a))
        if rm is not None and run > rm and (last, run - rm - 1, a) in enc:
            w.code(esc); w.put(2, 2)
            w.code(enc[last, run - rm - 1, a]); w.put(1, s)
            continue
        w.code(esc); w.put(2, 3)
        w.put(1, last); w.put(6, run); w.put(1, 1); w.put(12, level); w.put(1, 1)


def _block_runs(levels: np.ndarray, first: int) -> List[List[Tuple[int, int]]]:
    """The (run, level) pairs of every block ``[N, 64]`` in zigzag order from
    scan position ``first``."""
    zz = levels[:, np.asarray(ZIGZAG)]
    zz[:, :first] = 0
    rows, cols = np.nonzero(zz)
    out: List[List[Tuple[int, int]]] = [[] for _ in range(len(levels))]
    prev_row, prev = -1, first - 1
    for row, col, val in zip(rows.tolist(), cols.tolist(), zz[rows, cols].tolist()):
        if row != prev_row:
            prev_row, prev = row, first - 1
        out[row].append((col - prev - 1, val))
        prev = col
    return out


def encode_vop(vol: VOL, kind: str, levels: np.ndarray, q: int, modulo_time_base: int,
               time_increment: int, rounding: int = 0) -> bytes:
    """One I- or P-VOP ("I" or "P") of quantised levels int16 ``[n_blocks,
    64]`` (raster order; intra DC levels in ``[:, 0]``) at ``vop_quant`` q
    with ``intra_dc_vlc_thr`` 0; P-VOP macroblocks are inter with the vector
    (0, 0), or not_coded where all six blocks are zero.  ``modulo_time_base``
    is the number of whole seconds since the previous VOP's, and
    ``time_increment`` the ticks past the VOP's second."""
    mb_w, mb_h = vol.mb_w, vol.mb_h
    w = BitWriter()
    w.start_code(VOP_START)
    w.put(2, 0 if kind == "I" else 1)
    for _ in range(modulo_time_base):
        w.put(1, 1)
    w.put(1, 0); w.put(1, 1)
    w.put(vol.time_bits, time_increment); w.put(1, 1)
    w.put(1, 1)  # vop_coded
    if kind == "P":
        w.put(1, rounding)
    w.put(3, 0)  # intra_dc_vlc_thr
    w.put(5, q)
    if kind == "P":
        w.put(3, 1)  # f_code
    nz = levels.reshape(mb_h * mb_w, 6, 64).any(axis=2).tolist()
    runs = _block_runs(levels, 1 if kind == "I" else 0)
    if kind == "I":
        st = _IntraState(mb_w, mb_h)
        for mb_y in range(mb_h):
            for mb_x in range(mb_w):
                mb = mb_y * mb_w + mb_x
                blocks = levels[mb * 6:mb * 6 + 6]
                acs = runs[mb * 6:mb * 6 + 6]
                cbp = 0
                for n in range(6):
                    cbp |= int(bool(acs[n])) << (5 - n)
                w.code(MCBPC_I[cbp & 3])
                w.put(1, 0)  # ac_pred_flag
                w.code(CBPY[cbp >> 2])
                for n in range(6):
                    scale = DC_SCALE_LUMA[q] if n < 4 else DC_SCALE_CHROMA[q]
                    g, i = st.where(n, mb_x, mb_y)
                    pred, _ = st.dc_pred(g, i, scale)
                    dc = int(blocks[n, 0])
                    st.store_dc(g, i, dc, scale)
                    diff = dc - pred
                    size = abs(diff).bit_length()
                    w.code((DC_LUMA if n < 4 else DC_CHROMA)[size])
                    if size:
                        w.put(size, diff if diff > 0 else diff + (1 << size) - 1)
                        if size > 8:
                            w.put(1, 1)
                    if acs[n]:
                        _put_tcoef(w, acs[n], _INTRA)
    else:
        for mb in range(mb_h * mb_w):
            if not any(nz[mb]):
                w.put(1, 1)  # not_coded
                continue
            w.put(1, 0)
            cbp = 0
            for n in range(6):
                cbp |= int(nz[mb][n]) << (5 - n)
            w.code(MCBPC_P[cbp & 3])
            w.code(CBPY[(cbp >> 2) ^ 15])
            w.code(MVD[0]); w.code(MVD[0])  # the vector (0, 0); every predictor is 0
            for n in range(6):
                if nz[mb][n]:
                    _put_tcoef(w, runs[mb * 6 + n], _INTER)
    w.stuffing()
    return w.getvalue()
