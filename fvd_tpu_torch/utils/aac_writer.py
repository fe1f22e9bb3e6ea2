"""Known-answer AAC-LC for the tests and the card's smoke run: a writer of
``raw_data_block``\\ s from given quantised spectra, and a plain encoder.

:func:`write_frame` codes one :class:`FrameSpec`: a single channel element
or a channel pair (with or without ``common_window``, an M/S mask), any of
the four window sequences and both window shapes, the short windows'
grouping, and per channel the quantised values, the scale factors, noise
(PNS) and intensity bands, pulse data and TNS filters.  Each band takes the
smallest spectral codebook that holds its values (the even or the odd one
of a pair, by ``FrameSpec.book_parity``), or the one a channel forces, so
that every codebook and codebook 11's escapes are reached.
:func:`covering_frames` draws a stream that reaches every syntax path of
``fvd_tpu_torch/utils/aac.py``.

:func:`encode_signal` is the plain encoder: a forward MDCT of the signal
with the sine window, long windows only, one global gain, every band in
codebook 11.  It puts a real signal (a clip's speech) into AAC.  An MP4
carries a stream through ``write_mp4v(..., audio=...)``
(``fvd_tpu_torch/providers/native_decode.py``) or
``Mp4Writer.add_audio`` (``fvd_tpu_torch/utils/mp4.py``).

This is the tests' and the smoke run's writer: the port's ``write_video``
writes no audio, as the JAX package's does not.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fvd_tpu_torch.utils import aac_tables as T
from fvd_tpu_torch.utils.aac import EIGHT_SHORT, LONG_START, LONG_STOP, ONLY_LONG
from fvd_tpu_torch.utils.mpeg4v import BitWriter

@dataclass
class ChannelSpec:
    """One channel of a frame.  ``q`` int ``[1024]`` (a short frame's eight
    windows of 128 one after another) holds the coded values; ``sf`` one
    scale factor per (group, band) for the spectral bands (absolute, 0-255,
    within 60 of the previous one); ``noise`` and ``intensity`` map a
    (group-major) band index to its noise energy offset or intensity
    position (absolute, as the decoder accumulates them); ``books`` forces a
    band's codebook; ``pulses`` (long windows) are (position, amplitude);
    ``tns`` per window a list of filters (length, order, direction,
    coef_res, compress, raw coefficient codes)."""
    q: np.ndarray
    sf: Sequence[int]
    global_gain: int = 100
    noise: Dict[int, int] = field(default_factory=dict)
    intensity: Dict[int, int] = field(default_factory=dict)
    books: Dict[int, int] = field(default_factory=dict)
    pulses: Sequence[Tuple[int, int]] = ()
    tns: Optional[List[List[Tuple[int, int, int, int, int, List[int]]]]] = None


@dataclass
class FrameSpec:
    sequence: int
    shape: int
    max_sfb: int
    channels: List[ChannelSpec]
    groups: Sequence[int] = (1,)
    common_window: bool = True
    ms: int = 0                     # ms_mask_present: 0, 1 (the mask), 2 (all)
    ms_mask: Sequence[int] = ()
    book_parity: int = 0
    fill: int = 0                   # bytes of a fill element before END
    data: int = 0                   # bytes of a data stream element before the channels


def _book_for(peak: int, parity: int) -> int:
    if peak == 0:
        return T.ZERO_HCB
    for lo in (1, 3, 5, 7, 9):
        if peak <= T.CODEBOOK_LAV[lo]:
            return lo + parity
    return T.ESC_HCB


def _put_value_escape(w: BitWriter, a: int) -> None:
    n = a.bit_length() - 1              # 2^n <= a < 2^(n+1), n >= 4
    if not 4 <= n <= 12:
        raise ValueError(f"an escaped value {a} outside 16..8191")
    for _ in range(n - 4):
        w.put(1, 1)
    w.put(1, 0)
    w.put(n, a - (1 << n))


def _put_codeword(w: BitWriter, book: int, vals: Sequence[int]) -> None:
    dim, signed = T.CODEBOOK_DIM[book], T.CODEBOOK_SIGNED[book]
    mod, off = T.CODEBOOK_MOD[book], T.CODEBOOK_OFF[book]
    mags = [v + off if signed else min(abs(v), 16) for v in vals]
    idx = 0
    for m in mags:
        idx = idx * mod + m
    w.code(T.SPECTRAL[book][idx])
    if not signed:
        for v in vals:
            if v:
                w.put(1, int(v < 0))
        if book == T.ESC_HCB:
            for v in vals:
                if abs(v) >= 16:
                    _put_value_escape(w, abs(v))


def _band_layout(spec: FrameSpec, sampling_index: int):
    short = spec.sequence == EIGHT_SHORT
    swb = (T.SWB_OFFSET_128 if short else T.SWB_OFFSET_1024)[sampling_index]
    groups = list(spec.groups) if short else [1]
    return short, swb, groups


def _choose_books(ch: ChannelSpec, spec: FrameSpec, swb, groups) -> List[int]:
    books = []
    idx, win0 = 0, 0
    for glen in groups:
        for band in range(spec.max_sfb):
            if idx in ch.noise:
                books.append(T.NOISE_HCB)
            elif idx in ch.intensity:
                books.append(ch.books.get(idx, T.INTENSITY_HCB))
            else:
                lo, hi = swb[band], swb[band + 1]
                peak = max(int(np.abs(ch.q[w * 128 + lo:w * 128 + hi]).max()) for w in range(win0, win0 + glen))
                book = ch.books.get(idx, _book_for(peak, spec.book_parity))
                if peak > T.CODEBOOK_LAV[book] and book != T.ESC_HCB:
                    raise ValueError(f"band {idx}: values up to {peak} do not fit codebook {book}")
                books.append(book)
            idx += 1
        win0 += glen
    return books


def _put_grouping(w: BitWriter, groups: Sequence[int]) -> None:
    flags: List[int] = []
    for g in groups:
        flags += [1] * (g - 1) + [0]
    if len(flags) != 8:
        raise ValueError(f"groups {groups} do not cover 8 windows")
    for f in flags[:7]:
        w.put(1, f)


def _put_info(w: BitWriter, spec: FrameSpec) -> None:
    w.put(1, 0)
    w.put(2, spec.sequence)
    w.put(1, spec.shape)
    if spec.sequence == EIGHT_SHORT:
        w.put(4, spec.max_sfb)
        _put_grouping(w, spec.groups)
    else:
        w.put(6, spec.max_sfb)
        w.put(1, 0)  # predictor_data_present


def _put_ics(w: BitWriter, spec: FrameSpec, ch: ChannelSpec, common_window: bool, sampling_index: int) -> None:
    short, swb, groups = _band_layout(spec, sampling_index)
    w.put(8, ch.global_gain)
    if not common_window:
        _put_info(w, spec)
    books = _choose_books(ch, spec, swb, groups)
    # section data
    bits, esc = (3, 7) if short else (5, 31)
    for g in range(len(groups)):
        row = books[g * spec.max_sfb:(g + 1) * spec.max_sfb]
        k = 0
        while k < len(row):
            end = k
            while end < len(row) and row[end] == row[k]:
                end += 1
            w.put(4, row[k])
            n = end - k
            while n >= esc:
                w.put(bits, esc)
                n -= esc
            w.put(bits, n)
            k = end
    # scale factors
    offset = [ch.global_gain, ch.global_gain - 90, 0]
    first_noise = True
    for idx, book in enumerate(books):
        if book == T.ZERO_HCB:
            continue
        if book in (T.INTENSITY_HCB, T.INTENSITY_HCB2):
            delta = ch.intensity[idx] - offset[2]
            offset[2] = ch.intensity[idx]
        elif book == T.NOISE_HCB:
            delta = ch.noise[idx] - offset[1]
            offset[1] = ch.noise[idx]
            if first_noise:
                w.put(9, delta + 256)
                first_noise = False
                continue
        else:
            delta = ch.sf[idx] - offset[0]
            offset[0] = ch.sf[idx]
        if not -60 <= delta <= 60:
            raise ValueError(f"band {idx}: a scale factor difference of {delta}")
        w.code(T.SF_CODES[delta + 60])
    # pulse data
    if ch.pulses:
        w.put(1, 1)
        w.put(2, len(ch.pulses) - 1)
        start = max(b for b in range(len(swb) - 1) if swb[b] <= ch.pulses[0][0] and ch.pulses[0][0] - swb[b] < 32)
        w.put(6, start)
        prev = swb[start]
        for pos, amp in ch.pulses:
            w.put(5, pos - prev)
            w.put(4, amp)
            prev = pos
    else:
        w.put(1, 0)
    # TNS
    if ch.tns:
        w.put(1, 1)
        for win in ch.tns:
            w.put(1 if short else 2, len(win))
            if win:
                w.put(1, win[0][3])
                for length, order, direction, coef_res, compress, raw in win:
                    w.put(4 if short else 6, length)
                    w.put(3 if short else 5, order)
                    if order:
                        w.put(1, direction)
                        w.put(1, compress)
                        for r in raw:
                            w.put(coef_res + 3 - compress, r)
    else:
        w.put(1, 0)
    w.put(1, 0)  # gain_control_data_present
    # spectral data
    idx, win0 = 0, 0
    for glen in groups:
        for band in range(spec.max_sfb):
            book = books[idx]
            idx += 1
            if book in (T.ZERO_HCB, T.NOISE_HCB, T.INTENSITY_HCB, T.INTENSITY_HCB2):
                continue
            lo, hi = swb[band], swb[band + 1]
            dim = T.CODEBOOK_DIM[book]
            for win in range(win0, win0 + glen):
                vals = ch.q[win * 128 + lo:win * 128 + hi]
                for k in range(0, hi - lo, dim):
                    _put_codeword(w, book, [int(v) for v in vals[k:k + dim]])
        win0 += glen


def write_frame(spec: FrameSpec, sampling_index: int) -> bytes:
    """One ``raw_data_block`` of ``spec`` (one channel: an SCE; two: a
    CPE), byte-aligned."""
    w = BitWriter()
    if spec.data:
        w.put(3, 4); w.put(4, 0)          # DSE: tag, no byte alignment, count
        w.put(1, 0); w.put(8, spec.data)
        for i in range(spec.data):
            w.put(8, i & 0xFF)
    if len(spec.channels) == 1:
        w.put(3, 0); w.put(4, 0)
        _put_ics(w, spec, spec.channels[0], False, sampling_index)
    else:
        w.put(3, 1); w.put(4, 0)
        w.put(1, int(spec.common_window))
        if spec.common_window:
            _put_info(w, spec)
            w.put(2, spec.ms)
            if spec.ms == 1:
                for m in spec.ms_mask:
                    w.put(1, m)
        for ch in spec.channels:
            _put_ics(w, spec, ch, spec.common_window, sampling_index)
    if spec.fill:
        w.put(3, 6)
        if spec.fill < 15:
            w.put(4, spec.fill)
        else:
            w.put(4, 15); w.put(8, spec.fill - 14)
        w.put(4, 0)                        # EXT_FILL
        w.put(4, 0)
        for _ in range(spec.fill - 1):
            w.put(8, 0xA5)
    w.put(3, 7)                            # END
    w.align_zero()
    return w.getvalue()


def audio_specific_config(sample_rate: int, channels: int, explicit_rate: bool = False) -> bytes:
    """An AAC-LC AudioSpecificConfig (1024-sample frames)."""
    w = BitWriter()
    w.put(5, 2)
    if explicit_rate or sample_rate not in T.SAMPLE_RATES:
        w.put(4, 15); w.put(24, sample_rate)
    else:
        w.put(4, T.SAMPLE_RATES.index(sample_rate))
    w.put(4, channels)
    w.put(3, 0)  # 1024 frames, no core coder, no extension
    w.align_zero()
    return w.getvalue()


# --- a covering stream -----------------------------------------------------------

_SEQUENCES = (ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP, ONLY_LONG, ONLY_LONG, LONG_START, EIGHT_SHORT,
              EIGHT_SHORT, LONG_STOP)


def _values(rng, n, peak):
    v = rng.randint(-peak, peak + 1, n)
    v[rng.rand(n) < 0.4] = 0
    return v


def _sf_for(peak: int, target: float) -> int:
    """The scale factor that puts a band whose largest value is ``peak``
    near ``target`` in the standard's spectral units."""
    return int(round(100 + 4 * math.log2(target / max(peak, 1) ** (4.0 / 3.0))))


def covering_frames(channels: int, sample_rate: int, n: int = 24, seed: int = 0,
                    target: float = 2e4) -> List[FrameSpec]:
    """``n`` frames that reach every syntax path of the parser: the four
    window sequences in the standard's order, both shapes, grouped short
    windows, all eleven codebooks and codebook 11's escapes, noise bands,
    pulses, TNS (long and short windows, both resolutions, compressed or
    not, both directions), a data stream and a fill element; with two
    channels, M/S (by mask and for all bands), intensity (both signs) and a
    frame without a common window.  Bands sit near ``target`` (spectral
    units), a signal of about a tenth of full scale."""
    rng = np.random.RandomState(seed)
    index = T.SAMPLE_RATES.index(sample_rate)
    frames: List[FrameSpec] = []
    for t in range(n):
        seq = _SEQUENCES[t % len(_SEQUENCES)]
        shape = (t // 3) % 2
        short = seq == EIGHT_SHORT
        swb = (T.SWB_OFFSET_128 if short else T.SWB_OFFSET_1024)[index]
        n_swb = len(swb) - 1
        groups = [(3, 2, 1, 2), (1,) * 8, (8,), (2, 2, 2, 2)][t % 4] if short else (1,)
        max_sfb = n_swb - (t % 3)
        chans = []
        for c in range(channels):
            q = np.zeros(1024, np.int64)
            sf, noise = [], {}
            idx = 0
            cur = None
            for g, glen in enumerate(groups):
                for band in range(max_sfb):
                    lo, hi = swb[band], swb[band + 1]
                    kind = (band + t + c) % 9
                    peak = [1, 2, 4, 7, 12, 30, 3, 0, 1][kind]
                    if band < 2:
                        peak = 4 * (kind % 2) + 1
                    if peak == 30 and rng.rand() < 0.5:
                        peak = 3000          # codebook 11's escapes
                    first = sum(groups[:g])
                    for win in range(first, first + glen):
                        q[win * 128 + lo:win * 128 + hi] = _values(rng, hi - lo, peak)
                    want = _sf_for(peak, target) + rng.randint(-3, 4)
                    cur = want if cur is None else int(np.clip(want, cur - 60, cur + 60))
                    sf.append(int(np.clip(cur, 0, 255)))
                    if kind == 7 and band > 3 and not (c == 1 and t % 2):
                        noise[idx] = 60 + rng.randint(-10, 6)
                    idx += 1
            chans.append(ChannelSpec(q, sf, global_gain=sf[0], noise=noise))
        spec = FrameSpec(seq, shape, max_sfb, chans, groups=groups, book_parity=t % 2,
                         fill=[0, 3, 0, 20][t % 4], data=[0, 0, 5, 0][t % 4])
        if channels == 2:
            spec.common_window = t % 6 != 5
            if spec.common_window:
                spec.ms = [1, 2, 0][t % 3]
                n_bands = len(groups) * max_sfb
                spec.ms_mask = [int(rng.rand() < 0.5) for _ in range(n_bands)] if spec.ms == 1 else []
                # intensity: the right channel's top bands, both signs
                right = chans[1]
                for idx in range(n_bands):
                    if idx % max_sfb >= max_sfb - 3 and idx not in right.noise and idx not in chans[0].noise:
                        right.intensity[idx] = int(rng.randint(-8, 9))
                        right.books[idx] = T.INTENSITY_HCB if (idx + t) % 2 else T.INTENSITY_HCB2
        for c, ch in enumerate(chans):
            if not short and (t + c) % 4 == 1:
                # pulses on a spectral band near the start
                band = 3
                lo, hi = swb[band], swb[band + 1]
                ch.q[lo:hi] = np.clip(np.where(ch.q[lo:hi] == 0, 2, ch.q[lo:hi]), -12, 12)
                ch.noise.pop(band, None)
                ch.intensity.pop(band, None)
                ch.pulses = [(lo + 1, 3), (lo + 4, 15), (lo + 9, 1)]
            if (t + c) % 3 == 0:
                if short:
                    ch.tns = [[(4, 3, w % 2, w % 2, 0, [1, 2, 3])] if w % 3 == 0 else [] for w in range(8)]
                else:
                    ch.tns = [[(10, 4, 0, 1, 1, [1, 3, 7, 2]), (12, 6, 1, 1, 0, [1, 2, 9, 4, 15, 6])]]
        for ch in chans:
            _chain_scalefactors(ch, spec, swb, groups)
        frames.append(spec)
    return frames


def _chain_scalefactors(ch: ChannelSpec, spec: FrameSpec, swb, groups) -> None:
    """Pull each coded spectral band's scale factor within 60 of the last
    coded one's (the codebook's range), the global gain to the first."""
    last = None
    for idx, book in enumerate(_choose_books(ch, spec, swb, groups)):
        if book in (T.ZERO_HCB, T.NOISE_HCB, T.INTENSITY_HCB, T.INTENSITY_HCB2):
            continue
        if last is None:
            ch.global_gain = ch.sf[idx]
        else:
            ch.sf[idx] = int(np.clip(ch.sf[idx], last - 60, last + 60))
        last = ch.sf[idx]


# --- the plain encoder ---------------------------------------------------------------

def _mdct_matrix(n: int) -> np.ndarray:
    """``[2n, n]``: the standard's forward MDCT, twice the cosine sum, whose
    inverse (the decoder's, 2 / 2n times the cosine sum) windowed and
    overlap-added with the sine window gives the signal back."""
    k = np.arange(n)[None, :]
    m = np.arange(2 * n)[:, None]
    return 2.0 * np.cos(2 * np.pi / (2 * n) * (m + 0.5 + n / 2) * (k + 0.5))


def encode_signal(x: np.ndarray, sample_rate: int, gain: int = 136) -> Tuple[bytes, List[bytes]]:
    """float ``[n]`` or ``[n, channels]`` in [-1, 1] -> (AudioSpecificConfig,
    access units): sine-window long frames, 1024 samples of priming (the
    first frame's first half), every band in codebook 11 at scale factor
    ``gain``."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n, channels = x.shape
    index = T.SAMPLE_RATES.index(sample_rate)
    swb = T.SWB_OFFSET_1024[index]
    frames_n = (n + 1024) // 1024 + 1
    padded = np.zeros(((frames_n + 1) * 1024, channels))
    padded[1024:1024 + n] = x * T.PCM_SCALE
    win = np.concatenate([T.sine_window(1024), T.sine_window(1024)[::-1]])
    basis = _mdct_matrix(1024)
    step = 2.0 ** ((gain - 100) / 4.0)
    out = []
    for f in range(frames_n):
        block = padded[f * 1024:f * 1024 + 2048] * win[:, None]
        spec = block.T @ basis                       # [channels, 1024]
        q = np.sign(spec) * np.floor((np.abs(spec) / step) ** 0.75 + 0.4054)
        q = np.clip(q, -8191, 8191).astype(np.int64)
        chans = [ChannelSpec(q[c], [gain] * (len(swb) - 1), global_gain=gain,
                             books={i: T.ESC_HCB for i in range(len(swb) - 1)}) for c in range(channels)]
        spec_f = FrameSpec(ONLY_LONG, 0, len(swb) - 1, chans, common_window=channels == 2)
        out.append(write_frame(spec_f, index))
    return audio_specific_config(sample_rate, channels), out
