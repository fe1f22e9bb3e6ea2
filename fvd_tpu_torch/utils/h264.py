"""H.264 (AVC) at the NAL layer, with the standard library: what the port
reads of an ``avc1``/``avc3`` track before the card's NVDEC decodes it.

* :class:`BitReader` and :class:`BitWriter`: fixed-width fields and ue/se
  Exp-Golomb codes (ITU-T H.264 section 9.1);
* NAL units: :func:`split_annexb`, :func:`split_length_prefixed`, and the
  emulation-prevention bytes (section 7.4.1) taken out by :func:`unescape`
  and put in by :func:`escape`;
* :func:`parse_sps`: the sequence parameter set (7.3.2.1.1) with its
  scaling lists skipped and the VUI's ``video_full_range_flag`` and
  ``bitstream_restriction`` read; :meth:`Sps.width` and :meth:`Sps.height`
  are the display size as libavcodec reports it (``vctx->width/height`` in
  ``native/decode_shim.cc``), the coded size less the frame cropping;
* :func:`parse_avcc` and :func:`write_avcc`: the ``avcC`` box of an MP4
  sample entry (ISO/IEC 14496-15 section 5.3.3.1);
* :func:`annexb_access_unit`: a length-prefixed MP4 sample as an Annex B
  access unit, the parameter sets ahead of each sync sample;
* :func:`check_supported`: raises :class:`UnsupportedVideo` naming the
  feature for what the port does not decode (more than 8 bits, chroma other
  than 4:2:0, interlace, full-range samples).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from fvd_tpu_torch.utils.avi import UnsupportedVideo

START_CODE = b"\x00\x00\x00\x01"

NAL_SLICE, NAL_IDR, NAL_SPS, NAL_PPS = 1, 5, 7, 8

#: the profiles whose SPS carries chroma_format_idc, the bit depths and the scaling lists
HIGH_PROFILES = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)


class BitReader:
    """Reads an RBSP (emulation prevention already taken out) MSB first."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.pos = 0
        self.nbits = 8 * len(self.data)

    def u(self, n: int) -> int:
        if n == 0:
            return 0
        end = self.pos + n
        if end > self.nbits:
            raise UnsupportedVideo("H.264: a header runs past the end of its NAL unit")
        first, last = self.pos >> 3, (end + 7) >> 3
        value = int.from_bytes(self.data[first:last], "big") >> ((last << 3) - end)
        self.pos = end
        return value & ((1 << n) - 1)

    def flag(self) -> bool:
        return bool(self.u(1))

    def ue(self) -> int:
        zeros = 0
        while not self.u(1):
            zeros += 1
            if zeros > 31:
                raise UnsupportedVideo("H.264: an Exp-Golomb code longer than 32 bits")
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


class BitWriter:
    """Writes an RBSP MSB first."""

    def __init__(self):
        self.out = bytearray()
        self._acc = 0
        self._n = 0

    def u(self, n: int, value: int) -> None:
        if n == 0:
            return
        if not 0 <= value < (1 << n):
            raise ValueError(f"{value} does not fit {n} bits")
        self._acc = (self._acc << n) | value
        self._n += n
        while self._n >= 8:
            self._n -= 8
            self.out.append((self._acc >> self._n) & 0xFF)
        self._acc &= (1 << self._n) - 1

    def flag(self, value: bool) -> None:
        self.u(1, int(bool(value)))

    def ue(self, value: int) -> None:
        if value < 0:
            raise ValueError(f"ue({value})")
        k = value + 1
        self.u(2 * k.bit_length() - 1, k)

    def se(self, value: int) -> None:
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align_zero(self) -> None:
        """Zero bits up to the next byte (``pcm_alignment_zero_bit``)."""
        if self._n:
            self.u(8 - self._n, 0)

    def raw(self, data: bytes) -> None:
        """Whole bytes at a byte boundary (``pcm_sample_*``)."""
        if self._n:
            raise ValueError("raw bytes off a byte boundary")
        self.out += data

    def trailing(self) -> bytes:
        """``rbsp_trailing_bits`` and the RBSP."""
        self.u(1, 1)
        self.align_zero()
        return bytes(self.out)


# --- NAL units -------------------------------------------------------------------

def escape(rbsp: bytes) -> bytes:
    """The RBSP with an emulation-prevention byte 0x03 after every two zero
    bytes that a byte of 0x00-0x03 follows, and after a final zero byte."""
    i = rbsp.find(b"\x00\x00")
    if i < 0:
        return bytes(rbsp)
    out, start, n = bytearray(), 0, len(rbsp)
    while i >= 0:
        if i + 2 < n and rbsp[i + 2] <= 3:
            out += rbsp[start:i + 2]
            out.append(3)
            start = i + 2
            i = rbsp.find(b"\x00\x00", i + 2)
        else:
            i = rbsp.find(b"\x00\x00", i + 1)
    out += rbsp[start:]
    if out[-1:] == b"\x00":
        out.append(3)
    return bytes(out)


def unescape(ebsp: bytes) -> bytes:
    """The RBSP of a NAL unit's payload: each 0x03 after two zero bytes dropped."""
    i = ebsp.find(b"\x00\x00\x03")
    if i < 0:
        return bytes(ebsp)
    out, start = bytearray(), 0
    while i >= 0:
        out += ebsp[start:i + 2]
        start = i + 3
        i = ebsp.find(b"\x00\x00\x03", start)
    out += ebsp[start:]
    return bytes(out)


def nal_unit(ref_idc: int, kind: int, rbsp: bytes) -> bytes:
    """A NAL unit: its header byte, then the escaped RBSP."""
    return bytes([(ref_idc << 5) | kind]) + escape(rbsp)


def nal_type(nal: bytes) -> int:
    return nal[0] & 0x1F


def split_annexb(stream: bytes) -> List[bytes]:
    """The NAL units of an Annex B byte stream, start codes and trailing zero
    bytes removed."""
    out: List[bytes] = []
    i = stream.find(b"\x00\x00\x01")
    while i >= 0:
        start = i + 3
        nxt = stream.find(b"\x00\x00\x01", start)
        end = len(stream) if nxt < 0 else nxt
        nal = stream[start:end].rstrip(b"\x00")
        if nal:
            out.append(bytes(nal))
        i = nxt
    return out


def split_length_prefixed(sample: bytes, length_size: int) -> List[bytes]:
    """The NAL units of an MP4 sample, each prefixed by its big-endian length."""
    out: List[bytes] = []
    pos = 0
    while pos < len(sample):
        if pos + length_size > len(sample):
            raise UnsupportedVideo("H.264 sample: a NAL length runs past the sample")
        n = int.from_bytes(sample[pos:pos + length_size], "big")
        pos += length_size
        if n == 0 or pos + n > len(sample):
            raise UnsupportedVideo(f"H.264 sample: a NAL unit of {n} bytes at byte {pos} does not fit "
                                   f"the sample's {len(sample)}")
        out.append(bytes(sample[pos:pos + n]))
        pos += n
    return out


# --- the sequence parameter set ---------------------------------------------------

@dataclass
class Sps:
    """What the port reads of a sequence parameter set."""
    profile_idc: int
    constraint_flags: int
    level_idc: int
    sps_id: int
    chroma_format_idc: int = 1
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    scaling_matrix_present: bool = False
    log2_max_frame_num: int = 4
    pic_order_cnt_type: int = 0
    log2_max_poc_lsb: int = 4
    max_num_ref_frames: int = 0
    mb_width: int = 0
    map_units_height: int = 0
    frame_mbs_only: bool = True
    crop: Tuple[int, int, int, int] = (0, 0, 0, 0)   # left, right, top, bottom in crop units
    full_range: bool = False
    max_num_reorder_frames: Optional[int] = None
    max_dec_frame_buffering: Optional[int] = None

    @property
    def mb_height(self) -> int:
        """Frame height in macroblocks."""
        return self.map_units_height * (2 - self.frame_mbs_only)

    @property
    def crop_units(self) -> Tuple[int, int]:
        """(CropUnitX, CropUnitY), equations 7-19 to 7-22."""
        if self.chroma_format_idc == 0:
            return 1, 2 - self.frame_mbs_only
        sub_w = 1 if self.chroma_format_idc == 3 else 2
        sub_h = 2 if self.chroma_format_idc == 1 else 1
        return sub_w, sub_h * (2 - self.frame_mbs_only)

    @property
    def width(self) -> int:
        left, right, _, _ = self.crop
        return 16 * self.mb_width - self.crop_units[0] * (left + right)

    @property
    def height(self) -> int:
        _, _, top, bottom = self.crop
        return 16 * self.mb_height - self.crop_units[1] * (top + bottom)


def _skip_scaling_list(r: BitReader, size: int) -> None:
    last = nxt = 8
    for _ in range(size):
        if nxt:
            nxt = (last + r.se() + 256) % 256
        last = nxt or last


def _skip_hrd(r: BitReader) -> None:
    count = r.ue() + 1
    r.u(8)  # bit_rate_scale, cpb_size_scale
    for _ in range(count):
        r.ue()
        r.ue()
        r.u(1)
    r.u(20)  # four 5-bit lengths


def _read_vui(r: BitReader, sps: Sps) -> None:
    if r.flag():  # aspect_ratio_info_present_flag
        if r.u(8) == 255:
            r.u(32)
    if r.flag():  # overscan_info_present_flag
        r.u(1)
    if r.flag():  # video_signal_type_present_flag
        r.u(3)
        sps.full_range = r.flag()
        if r.flag():  # colour_description_present_flag
            r.u(24)
    if r.flag():  # chroma_loc_info_present_flag
        r.ue()
        r.ue()
    if r.flag():  # timing_info_present_flag
        r.u(32)
        r.u(32)
        r.u(1)
    nal_hrd = r.flag()
    if nal_hrd:
        _skip_hrd(r)
    vcl_hrd = r.flag()
    if vcl_hrd:
        _skip_hrd(r)
    if nal_hrd or vcl_hrd:
        r.u(1)  # low_delay_hrd_flag
    r.u(1)  # pic_struct_present_flag
    if r.flag():  # bitstream_restriction_flag
        r.u(1)
        for _ in range(4):
            r.ue()
        sps.max_num_reorder_frames = r.ue()
        sps.max_dec_frame_buffering = r.ue()


def parse_sps(nal: bytes) -> Sps:
    """The sequence parameter set of NAL unit ``nal`` (its header byte
    included, emulation prevention not yet taken out)."""
    if not nal or nal_type(nal) != NAL_SPS:
        raise UnsupportedVideo("H.264: not a sequence parameter set")
    r = BitReader(unescape(nal[1:]))
    sps = Sps(profile_idc=r.u(8), constraint_flags=r.u(8), level_idc=r.u(8), sps_id=r.ue())
    if sps.profile_idc in HIGH_PROFILES:
        sps.chroma_format_idc = r.ue()
        if sps.chroma_format_idc == 3:
            r.u(1)  # separate_colour_plane_flag
        sps.bit_depth_luma = r.ue() + 8
        sps.bit_depth_chroma = r.ue() + 8
        r.u(1)  # qpprime_y_zero_transform_bypass_flag
        sps.scaling_matrix_present = r.flag()
        if sps.scaling_matrix_present:
            for i in range(8 if sps.chroma_format_idc != 3 else 12):
                if r.flag():
                    _skip_scaling_list(r, 16 if i < 6 else 64)
    sps.log2_max_frame_num = r.ue() + 4
    sps.pic_order_cnt_type = r.ue()
    if sps.pic_order_cnt_type == 0:
        sps.log2_max_poc_lsb = r.ue() + 4
    elif sps.pic_order_cnt_type == 1:
        r.u(1)
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    sps.max_num_ref_frames = r.ue()
    r.u(1)  # gaps_in_frame_num_value_allowed_flag
    sps.mb_width = r.ue() + 1
    sps.map_units_height = r.ue() + 1
    sps.frame_mbs_only = r.flag()
    if not sps.frame_mbs_only:
        r.u(1)  # mb_adaptive_frame_field_flag
    r.u(1)  # direct_8x8_inference_flag
    if r.flag():  # frame_cropping_flag
        sps.crop = (r.ue(), r.ue(), r.ue(), r.ue())
    if r.flag():  # vui_parameters_present_flag
        _read_vui(r, sps)
    if sps.width <= 0 or sps.height <= 0:
        raise UnsupportedVideo(f"H.264 SPS: cropping leaves {sps.width}x{sps.height}")
    return sps


def check_supported(sps: Sps, path: str) -> None:
    """Raise :class:`UnsupportedVideo` naming the first feature of ``sps``
    that the port does not decode."""
    if sps.bit_depth_luma > 8 or sps.bit_depth_chroma > 8:
        raise UnsupportedVideo(f"{path}: H.264 of bit depth {sps.bit_depth_luma}/{sps.bit_depth_chroma}; "
                               f"the port decodes 8-bit H.264 only")
    if sps.chroma_format_idc != 1:
        name = {0: "4:0:0 (monochrome)", 2: "4:2:2", 3: "4:4:4"}.get(sps.chroma_format_idc,
                                                                        str(sps.chroma_format_idc))
        raise UnsupportedVideo(f"{path}: H.264 with {name} chroma; the port decodes 4:2:0 only")
    if not sps.frame_mbs_only:
        raise UnsupportedVideo(f"{path}: interlaced H.264 (frame_mbs_only_flag 0: fields or MBAFF); "
                               f"the port decodes progressive frames only")
    if sps.full_range:
        raise UnsupportedVideo(f"{path}: full-range H.264 (video_full_range_flag 1); the port converts "
                               f"limited-range samples only")


# --- avcC -----------------------------------------------------------------------

@dataclass
class AvcConfig:
    """An ``avcC`` box: the NAL length size and the parameter sets."""
    length_size: int
    sps: List[bytes] = field(default_factory=list)
    pps: List[bytes] = field(default_factory=list)


def parse_avcc(body: bytes) -> AvcConfig:
    """The ``avcC`` box body (an AVCDecoderConfigurationRecord)."""
    body = bytes(body)
    if len(body) < 7 or body[0] != 1:
        raise UnsupportedVideo("MP4 avcC: not an AVCDecoderConfigurationRecord of version 1")
    cfg = AvcConfig(length_size=(body[4] & 3) + 1)
    pos = 5
    for sets, count_mask in ((cfg.sps, 0x1F), (cfg.pps, 0xFF)):
        if pos >= len(body):
            raise UnsupportedVideo("MP4 avcC: cut inside its parameter sets")
        count = body[pos] & count_mask
        pos += 1
        for _ in range(count):
            if pos + 2 > len(body):
                raise UnsupportedVideo("MP4 avcC: cut inside its parameter sets")
            (n,) = struct.unpack_from(">H", body, pos)
            if pos + 2 + n > len(body):
                raise UnsupportedVideo("MP4 avcC: a parameter set runs past the box")
            sets.append(body[pos + 2:pos + 2 + n])
            pos += 2 + n
    return cfg


def write_avcc(sps: bytes, pps: bytes) -> bytes:
    """The ``avcC`` body for one SPS and one PPS NAL unit, 4-byte lengths; a
    High-profile record carries its chroma format and bit depths."""
    info = parse_sps(sps)
    out = bytes([1, sps[1], sps[2], sps[3], 0xFC | 3, 0xE0 | 1]) + struct.pack(">H", len(sps)) + sps
    out += bytes([1]) + struct.pack(">H", len(pps)) + pps
    if info.profile_idc in (100, 110, 122, 144):
        out += bytes([0xFC | info.chroma_format_idc, 0xF8 | (info.bit_depth_luma - 8),
                      0xF8 | (info.bit_depth_chroma - 8), 0])
    return out


def annexb_access_unit(sample: bytes, config: AvcConfig, sync: bool) -> bytes:
    """An MP4 sample as an Annex B access unit: start codes for the length
    prefixes, and the ``avcC``'s SPS and PPS ahead of a sync sample."""
    head = b"".join(START_CODE + n for n in config.sps + config.pps) if sync else b""
    return head + b"".join(START_CODE + n for n in split_length_prefixed(sample, config.length_size))
