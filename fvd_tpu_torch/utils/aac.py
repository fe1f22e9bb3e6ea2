"""AAC-LC (ISO/IEC 14496-3 General Audio, object type 2): the host half of
the decode the JAX package gets from libavcodec's ``aac`` decoder
(``native/decode_shim.cc`` ``fvd_extract_audio``).

:func:`parse_asc` reads an AudioSpecificConfig; :class:`Decoder` reads
``raw_data_block``\\ s in order and :func:`decode` a track's: single and
channel pair elements (``common_window``, the M/S mask), data stream and
fill elements skipped, ``ics_info`` for all four window sequences and both
window shapes with the scale-factor grouping, section data, scale factors
(with the intensity positions and the noise energies), pulse data, TNS data
and the spectral Huffman codes (codebook 11's escapes included).  It then
gives the dequantised spectra, as libavcodec does: ``sign(q) |q|^(4/3)
2^((sf - 100) / 4)``, pulses added to ``|q|``, M/S and intensity stereo,
perceptual noise (libavcodec's LCG, carried across frames and channels in
decode order, each band scaled to its energy), and TNS's all-pole filters.
The IMDCT, windowing and overlap-add run in ``fvd_tpu_torch/ops/aac.py``.

Anything else raises :class:`UnsupportedVideo` naming it: SBR (explicit, or
implicit through an ``EXT_SBR_DATA`` fill element), PS, the Main and LTP
object types (and prediction), 960-sample frames, more than two channels,
LFE, CCE and PCE elements, gain control (SSR).
"""

from __future__ import annotations

import math
from array import array
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np

from fvd_tpu_torch.utils import aac_tables as T
from fvd_tpu_torch.utils.avi import UnsupportedVideo

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3
SCE, CPE, CCE, LFE, DSE, PCE, FIL, END = range(8)
EXT_SBR_DATA, EXT_SBR_DATA_CRC = 13, 14
OBJECT_NAMES = {1: "AAC Main", 3: "AAC SSR", 4: "AAC LTP", 5: "HE-AAC (SBR)", 29: "HE-AAC v2 (PS)",
                6: "AAC Scalable", 17: "ER AAC-LC", 19: "ER AAC LTP", 20: "ER AAC Scalable", 23: "ER AAC-LD",
                39: "ER AAC-ELD"}


class Bits:
    """MSB-first reader; bits past the end read as zero (``left`` goes
    negative)."""

    __slots__ = ("buf", "pos", "size")

    def __init__(self, data: bytes):
        self.buf = bytes(data) + bytes(8)
        self.pos = 0
        self.size = len(data) * 8

    def peek(self, n: int) -> int:
        p = self.pos
        v = int.from_bytes(self.buf[p >> 3:(p >> 3) + 4], "big")
        return (v >> (32 - (p & 7) - n)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if n > 24:
            hi = self.read(n - 16)
            return (hi << 16) | self.read(16)
        v = self.peek(n)
        self.pos += n
        return v

    def bit(self) -> int:
        p = self.pos
        self.pos = p + 1
        return (self.buf[p >> 3] >> (7 - (p & 7))) & 1

    def left(self) -> int:
        return self.size - self.pos

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


@lru_cache(maxsize=None)
def _lut(book: int) -> Tuple[int, array]:
    """(bits, table): ``table[peek(bits)] = (index << 5) | length`` of the
    scalefactor codebook (``book`` 0) or spectral codebook ``book``; -1 where
    no code starts."""
    codes = T.SF_CODES if book == 0 else T.SPECTRAL[book]
    bits = max(n for _, n in codes)
    table = np.full(1 << bits, -1, np.int32)
    for i, (code, n) in enumerate(codes):
        base = code << (bits - n)
        table[base:base + (1 << (bits - n))] = (i << 5) | n
    return bits, array("i", table.tolist())


def _vlc(r: Bits, book: int, what: str) -> int:
    bits, table = _lut(book)
    e = table[r.peek(bits)]
    if e < 0 or r.pos + (e & 31) > r.size:
        raise UnsupportedVideo(f"AAC: invalid {what} code at bit {r.pos}")
    r.pos += e & 31
    return e >> 5


@dataclass
class AudioConfig:
    """An AudioSpecificConfig: object type, sampling rate and its table
    index, channels."""
    object_type: int
    sample_rate: int
    sampling_index: int
    channels: int


def parse_asc(asc: bytes) -> AudioConfig:
    """The AudioSpecificConfig ``asc`` of an AAC-LC track; anything else
    raises :class:`UnsupportedVideo` naming it."""
    if not asc:
        raise UnsupportedVideo("AAC track without an AudioSpecificConfig")
    r = Bits(asc)

    def object_type():
        t = r.read(5)
        return 32 + r.read(6) if t == 31 else t

    aot = object_type()
    index = r.read(4)
    rate = r.read(24) if index == 15 else (T.SAMPLE_RATES[index] if index < 13 else 0)
    channels = r.read(4)
    if aot in (5, 29):
        raise UnsupportedVideo(f"AAC: {OBJECT_NAMES[aot]} (explicit signalling); the port decodes AAC-LC only")
    if aot != 2:
        raise UnsupportedVideo(f"AAC: object type {aot} ({OBJECT_NAMES.get(aot, 'not AAC-LC')}); "
                               f"the port decodes AAC-LC only")
    if not rate:
        raise UnsupportedVideo(f"AAC: sampling frequency index {index}")
    if r.bit():
        raise UnsupportedVideo("AAC: 960-sample frames (frameLengthFlag); the port decodes 1024")
    if r.bit():  # dependsOnCoreCoder
        r.read(14)
    r.bit()      # extensionFlag (0 for AAC-LC)
    if channels == 0:
        raise UnsupportedVideo("AAC: channel configuration 0 (a program config element)")
    if channels > 2:
        raise UnsupportedVideo(f"AAC: channel configuration {channels}; the port decodes 1 or 2 channels")
    # backward-compatible explicit SBR and PS signalling after the config
    if r.left() >= 16 and r.read(11) == 0x2B7:
        if object_type() == 5 and r.bit():
            raise UnsupportedVideo("AAC: HE-AAC (SBR, backward-compatible signalling); the port decodes "
                                   "AAC-LC only")
        if r.left() >= 12 and r.read(11) == 0x548 and r.bit():
            raise UnsupportedVideo("AAC: HE-AAC v2 (PS); the port decodes AAC-LC only")
    return AudioConfig(aot, rate, index if index < 13 else T.sampling_index(rate), channels)


def _lcg(state: int) -> int:
    return (state * 1664525 + 1013904223) & 0xFFFFFFFF


def _signed32(v: int) -> int:
    return v - (1 << 32) if v >= 1 << 31 else v


@lru_cache(maxsize=1)
def _pow43() -> np.ndarray:
    return np.arange(8192, dtype=np.float64) ** (4.0 / 3.0)


def _tns_coef(raw: int, bits: int, res_bits: int) -> float:
    """A TNS reflection coefficient as libavcodec's tables hold it (the
    standard's with its sign flipped)."""
    q = raw - (1 << bits) if raw >= 1 << (bits - 1) else raw
    half = 1 << (res_bits - 1)
    return -math.sin(q / ((half - 0.5) / (math.pi / 2) if q >= 0 else (half + 0.5) / (math.pi / 2)))


class _Ics:
    """One channel's individual channel stream: ``ics_info`` (with the
    previous frame's window sequence and shape kept, as libavcodec keeps
    them), band types and scale factors of the current frame."""

    def __init__(self):
        self.seq = [ONLY_LONG, ONLY_LONG]      # current, previous
        self.shape = [0, 0]
        self.max_sfb = 0
        self.group_len = [1]
        self.num_windows = 1
        self.swb: Sequence[int] = ()
        self.num_swb = 0
        self.tns_max_bands = 0

    def copy_info(self, other: "_Ics") -> None:
        """A channel pair's common window: the second channel takes the
        first's ``ics_info``, keeping its own previous window shape."""
        prev_shape = self.shape[0]
        self.seq = list(other.seq)
        self.shape = [other.shape[0], prev_shape]
        self.max_sfb, self.group_len, self.num_windows = other.max_sfb, list(other.group_len), other.num_windows
        self.swb, self.num_swb, self.tns_max_bands = other.swb, other.num_swb, other.tns_max_bands


class Decoder:
    """Decodes the ``raw_data_block``\\ s of one AAC-LC track in order."""

    def __init__(self, cfg: AudioConfig):
        self.cfg = cfg
        self.ics = [_Ics() for _ in range(cfg.channels)]
        self.random_state = 0x1F2E3D4C

    # --- ics_info, sections, scale factors ---------------------------------

    def _ics_info(self, r: Bits, ics: _Ics) -> None:
        if r.bit():
            raise UnsupportedVideo("AAC: reserved bit set in ics_info")
        ics.seq = [r.read(2), ics.seq[0]]
        ics.shape = [r.bit(), ics.shape[0]]
        idx = self.cfg.sampling_index
        if ics.seq[0] == EIGHT_SHORT:
            ics.max_sfb = r.read(4)
            ics.group_len = [1]
            for _ in range(7):
                if r.bit():
                    ics.group_len[-1] += 1
                else:
                    ics.group_len.append(1)
            ics.num_windows = 8
            ics.swb, ics.num_swb, ics.tns_max_bands = T.SWB_OFFSET_128[idx], len(T.SWB_OFFSET_128[idx]) - 1, \
                T.TNS_MAX_BANDS_128[idx]
        else:
            ics.max_sfb = r.read(6)
            ics.group_len = [1]
            ics.num_windows = 1
            ics.swb, ics.num_swb, ics.tns_max_bands = T.SWB_OFFSET_1024[idx], len(T.SWB_OFFSET_1024[idx]) - 1, \
                T.TNS_MAX_BANDS_1024[idx]
            if r.bit():
                raise UnsupportedVideo("AAC: prediction (AAC Main or LTP) in an AAC-LC stream")
        if ics.max_sfb > ics.num_swb:
            raise UnsupportedVideo(f"AAC: max_sfb {ics.max_sfb} past the {ics.num_swb} bands")

    @staticmethod
    def _sections(r: Bits, ics: _Ics) -> List[int]:
        """Band type per (group, band), group-major."""
        bits = 3 if ics.seq[0] == EIGHT_SHORT else 5
        esc = (1 << bits) - 1
        types: List[int] = []
        for _ in ics.group_len:
            k = 0
            while k < ics.max_sfb:
                cb = r.read(4)
                if cb == 12:
                    raise UnsupportedVideo(f"AAC: reserved section codebook 12 at bit {r.pos}")
                end = k
                while True:
                    inc = r.read(bits)
                    end += inc
                    if r.left() < 0 or end > ics.max_sfb:
                        raise UnsupportedVideo(f"AAC: section past max_sfb at bit {r.pos}")
                    if inc != esc:
                        break
                types += [cb] * (end - k)
                k = end
        return types

    @staticmethod
    def _scalefactors(r: Bits, types: List[int], global_gain: int) -> List[float]:
        """Per (group, band): the band's scale (2^((sf - 100) / 4) for a
        spectral band, the noise energy's square root for a noise band, the
        intensity position's scale 2^(-pos / 4)), 0 for a zero band."""
        offset = [global_gain, global_gain - 90, 0]
        noise_first = True
        out: List[float] = []
        for t in types:
            if t == T.ZERO_HCB:
                out.append(0.0)
            elif t in (T.INTENSITY_HCB, T.INTENSITY_HCB2):
                offset[2] += _vlc(r, 0, "scalefactor") - 60
                out.append(2.0 ** (-max(-155, min(100, offset[2])) / 4.0))
            elif t == T.NOISE_HCB:
                if noise_first:
                    offset[1] += r.read(9) - 256
                    noise_first = False
                else:
                    offset[1] += _vlc(r, 0, "scalefactor") - 60
                out.append(2.0 ** (max(-100, min(155, offset[1])) / 4.0))
            else:
                offset[0] += _vlc(r, 0, "scalefactor") - 60
                if not 0 <= offset[0] <= 255:
                    raise UnsupportedVideo(f"AAC: scalefactor {offset[0]} out of range at bit {r.pos}")
                out.append(2.0 ** ((offset[0] - 100) / 4.0))
        return out

    # --- one channel's stream ----------------------------------------------

    def _ics(self, r: Bits, ch: int, common_window: bool):
        """One individual_channel_stream -> (spectrum float64 [1024], band
        types, TNS filters)."""
        ics = self.ics[ch]
        global_gain = r.read(8)
        if not common_window:
            self._ics_info(r, ics)
        types = self._sections(r, ics)
        scales = self._scalefactors(r, types, global_gain)
        pulses = None
        if r.bit():
            if ics.seq[0] == EIGHT_SHORT:
                raise UnsupportedVideo("AAC: pulse data in an eight-short sequence")
            n = r.read(2) + 1
            band = r.read(6)
            if band >= ics.num_swb:
                raise UnsupportedVideo(f"AAC: pulse start band {band} past the bands")
            pos = ics.swb[band] + r.read(5)
            pulses = [(pos, r.read(4))]
            for _ in range(n - 1):
                pos += r.read(5)
                pulses.append((pos, r.read(4)))
            if any(p >= ics.swb[ics.num_swb] for p, _ in pulses):
                raise UnsupportedVideo("AAC: pulse past the spectrum")
        tns = self._tns(r, ics) if r.bit() else None
        if r.bit():
            raise UnsupportedVideo("AAC: gain control (AAC SSR)")
        spec = self._spectrum(r, ics, types, scales, pulses)
        return spec, types, scales, tns

    def _tns(self, r: Bits, ics: _Ics):
        short = ics.seq[0] == EIGHT_SHORT
        filters = []
        for w in range(ics.num_windows):
            n_filt = r.read(1 if short else 2)
            win = []
            if n_filt:
                coef_res = r.bit()
                for _ in range(n_filt):
                    length = r.read(4 if short else 6)
                    order = r.read(3 if short else 5)
                    if order > (7 if short else 12):
                        raise UnsupportedVideo(f"AAC: TNS filter order {order}")
                    direction, coefs = 0, []
                    if order:
                        direction = r.bit()
                        compress = r.bit()
                        bits = coef_res + 3 - compress
                        coefs = [_tns_coef(r.read(bits), bits, coef_res + 3) for _ in range(order)]
                    win.append((length, order, direction, coefs))
            filters.append(win)
        return filters

    def _spectrum(self, r: Bits, ics: _Ics, types, scales, pulses) -> np.ndarray:
        coef = np.zeros(1024, np.float64)
        pow43 = _pow43()
        swb = ics.swb
        idx = 0
        win0 = 0
        for glen in ics.group_len:
            for band in range(ics.max_sfb):
                t, scale = types[idx], scales[idx]
                lo, hi = swb[band], swb[band + 1]
                width = hi - lo
                if t == T.NOISE_HCB:
                    for w in range(win0, win0 + glen):
                        vals = np.empty(width, np.float64)
                        for k in range(width):
                            self.random_state = _lcg(self.random_state)
                            vals[k] = float(np.float32(_signed32(self.random_state)))
                        energy = float(np.dot(vals, vals))
                        coef[w * 128 + lo:w * 128 + hi] = vals * (scale / math.sqrt(energy))
                elif t in (T.ZERO_HCB, T.INTENSITY_HCB, T.INTENSITY_HCB2):
                    pass
                else:
                    dim = T.CODEBOOK_DIM[t]
                    signed, mod, off = T.CODEBOOK_SIGNED[t], T.CODEBOOK_MOD[t], T.CODEBOOK_OFF[t]
                    for w in range(win0, win0 + glen):
                        q = np.zeros(width, np.int64)
                        for k in range(0, width, dim):
                            i = _vlc(r, t, f"spectral (codebook {t})")
                            if dim == 4:
                                vals = [i // 27, (i // 9) % 3, (i // 3) % 3, i % 3]
                            else:
                                vals = [i // mod, i % mod]
                            if signed:
                                vals = [v - off for v in vals]
                            else:
                                vals = [-v if v and r.bit() else v for v in vals]
                                if t == T.ESC_HCB:
                                    vals = [self._escape(r, v) if abs(v) == 16 else v for v in vals]
                            q[k:k + dim] = vals
                        mag = pow43[np.abs(q)]
                        coef[w * 128 + lo:w * 128 + hi] = np.where(q < 0, -mag, mag) * scale
                idx += 1
            win0 += glen
        if pulses:
            for pos, amp in pulses:
                band = next(b for b in range(ics.num_swb) if swb[b + 1] > pos)
                if types[band] == T.NOISE_HCB or not scales[band]:
                    continue
                co = coef[pos] / scales[band]
                q = round(math.copysign(abs(co) ** 0.75, co)) if co else 0
                q = q + amp if q > 0 else q - amp
                coef[pos] = math.copysign(abs(q) ** (4.0 / 3.0), q) * scales[band]
        return coef

    @staticmethod
    def _escape(r: Bits, v: int) -> int:
        n = 0
        while r.bit():
            n += 1
            if n > 8:
                raise UnsupportedVideo(f"AAC: escape sequence too long at bit {r.pos}")
        n += 4
        val = (1 << n) + r.read(n)
        return -val if v < 0 else val

    # --- stereo and TNS ----------------------------------------------------

    @staticmethod
    def _band_windows(ics: _Ics):
        """(group-major band index, band, first window, windows) of each band."""
        idx, win0 = 0, 0
        for glen in ics.group_len:
            for band in range(ics.max_sfb):
                yield idx, band, win0, glen
                idx += 1
            win0 += glen

    def _apply_tns(self, coef: np.ndarray, ics: _Ics, filters) -> None:
        mmm = min(ics.tns_max_bands, ics.max_sfb)
        if not mmm:
            return
        for w, win in enumerate(filters):
            bottom = ics.num_swb
            for length, order, direction, coefs in win:
                top = bottom
                bottom = max(0, top - length)
                if not order:
                    continue
                lpc = [0.0] * order
                for i in range(order):
                    rr = -coefs[i]
                    lpc[i] = rr
                    for j in range((i + 1) >> 1):
                        f, b = lpc[j], lpc[i - 1 - j]
                        lpc[j] = f + rr * b
                        lpc[i - 1 - j] = b + rr * f
                start = ics.swb[min(bottom, mmm)]
                end = ics.swb[min(top, mmm)]
                size = end - start
                if size <= 0:
                    continue
                inc = -1 if direction else 1
                pos = (end - 1 if direction else start) + w * 128
                for m in range(size):
                    acc = coef[pos]
                    for i in range(1, min(m, order) + 1):
                        acc -= coef[pos - i * inc] * lpc[i - 1]
                    coef[pos] = acc
                    pos += inc

    # --- one raw_data_block -------------------------------------------------

    def frame(self, payload: bytes):
        """One access unit -> (spectra float64 ``[channels, 1024]``, window
        sequence, window shape, previous window sequence, previous window
        shape, each int ``[channels]``)."""
        r = Bits(payload)
        chans = self.cfg.channels
        out = np.zeros((chans, 1024), np.float64)
        done = False
        while True:
            if r.left() < 3:
                raise UnsupportedVideo(f"AAC: raw_data_block without an END element ({len(payload)} bytes)")
            kind = r.read(3)
            if kind == END:
                break
            tag = r.read(4)  # element_instance_tag; a fill element's count
            if kind == SCE:
                if chans != 1 or done:
                    raise UnsupportedVideo(f"AAC: a single channel element in a {chans}-channel stream")
                spec, _, _, tns = self._ics(r, 0, False)
                if tns:
                    self._apply_tns(spec, self.ics[0], tns)
                out[0] = spec
                done = True
            elif kind == CPE:
                if chans != 2 or done:
                    raise UnsupportedVideo(f"AAC: a channel pair element in a {chans}-channel stream")
                self._cpe(r, out)
                done = True
            elif kind == DSE:
                align = r.bit()
                count = r.read(8)
                if count == 255:
                    count += r.read(8)
                if align:
                    r.align()
                r.pos += 8 * count
            elif kind == FIL:
                count = tag
                if count == 15:
                    count += r.read(8) - 1
                if count and r.left() >= 4 and r.peek(4) in (EXT_SBR_DATA, EXT_SBR_DATA_CRC):
                    raise UnsupportedVideo("AAC: HE-AAC (SBR, implicit signalling in a fill element); the port "
                                           "decodes AAC-LC only")
                r.pos += 8 * count
            elif kind == LFE:
                raise UnsupportedVideo("AAC: an LFE channel element; the port decodes 1 or 2 channels")
            elif kind == CCE:
                raise UnsupportedVideo("AAC: a coupling channel element (CCE)")
            else:
                raise UnsupportedVideo("AAC: a program config element (PCE) in the stream")
            if r.left() < 0:
                raise UnsupportedVideo("AAC: raw_data_block runs past its access unit")
        if not done:
            raise UnsupportedVideo("AAC: an access unit without its channel element")
        seq = [ics.seq[0] for ics in self.ics]
        shape = [ics.shape[0] for ics in self.ics]
        return out, seq, shape, [ics.seq[1] for ics in self.ics], [ics.shape[1] for ics in self.ics]

    def _cpe(self, r: Bits, out: np.ndarray) -> None:
        left, right = self.ics
        common = r.bit()
        ms = 0
        mask: List[int] = []
        if common:
            self._ics_info(r, left)
            right.copy_info(left)
            ms = r.read(2)
            if ms == 3:
                raise UnsupportedVideo("AAC: reserved ms_mask_present 3")
            n = len(left.group_len) * left.max_sfb
            mask = [r.bit() for _ in range(n)] if ms == 1 else [1] * n if ms == 2 else [0] * n
        s0, t0, _, tns0 = self._ics(r, 0, bool(common))
        s1, t1, sc1, tns1 = self._ics(r, 1, bool(common))
        if common and ms:
            for idx, band, w0, glen in self._band_windows(left):
                if mask[idx] and t0[idx] < T.NOISE_HCB and t1[idx] < T.NOISE_HCB:
                    lo, hi = left.swb[band], left.swb[band + 1]
                    for w in range(w0, w0 + glen):
                        a, b = s0[w * 128 + lo:w * 128 + hi].copy(), s1[w * 128 + lo:w * 128 + hi].copy()
                        s0[w * 128 + lo:w * 128 + hi] = a + b
                        s1[w * 128 + lo:w * 128 + hi] = a - b
        for idx, band, w0, glen in self._band_windows(right):
            if t1[idx] in (T.INTENSITY_HCB, T.INTENSITY_HCB2):
                c = -1.0 + 2.0 * (t1[idx] - T.INTENSITY_HCB2)
                if ms:
                    c *= 1 - 2 * mask[idx]
                lo, hi = right.swb[band], right.swb[band + 1]
                for w in range(w0, w0 + glen):
                    s1[w * 128 + lo:w * 128 + hi] = s0[w * 128 + lo:w * 128 + hi] * (c * sc1[idx])
        if tns0:
            self._apply_tns(s0, left, tns0)
        if tns1:
            self._apply_tns(s1, right, tns1)
        out[0], out[1] = s0, s1


@dataclass
class Spectra:
    """A track's dequantised spectra: ``coef`` float32 ``[frames, channels,
    1024]`` (a short frame's eight windows of 128 one after another), and per
    frame and channel int8 ``[frames, channels]`` the window sequence and
    shape, and the previous frame's as the decoder held them."""
    coef: np.ndarray
    sequence: np.ndarray
    shape: np.ndarray
    prev_sequence: np.ndarray
    prev_shape: np.ndarray


def decode(cfg: AudioConfig, frames: Sequence[bytes]) -> Spectra:
    """Every access unit of a track, in order -> its :class:`Spectra`."""
    dec = Decoder(cfg)
    n, c = len(frames), cfg.channels
    coef = np.zeros((n, c, 1024), np.float32)
    meta = np.zeros((4, n, c), np.int8)
    for i, payload in enumerate(frames):
        spec, seq, shape, pseq, pshape = dec.frame(payload)
        coef[i] = spec
        meta[:, i] = (seq, shape, pseq, pshape)
    return Spectra(coef, meta[0], meta[1], meta[2], meta[3])
