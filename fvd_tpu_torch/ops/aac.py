"""AAC synthesis and the audio rate conversion: the parallel halves of what
the JAX package gets from libavcodec's ``aac`` decoder and libswresample
(``native/decode_shim.cc`` ``fvd_extract_audio``).  Two functions, each with
a plain version and a CUDA kernel:

* :func:`imdct_synth` (``csrc/aac_synth.cu`` ``aac_synth``): each frame's
  IMDCT (one of 2048, or eight of 256), windowed with the sine or KBD
  window of the current and the previous frame's shapes, and overlap-added,
  as libavcodec's ``imdct_and_windowing`` does: a long window meets a long
  one only from an ONLY_LONG or LONG_STOP frame into an ONLY_LONG or
  LONG_START one, any other pair meets as short windows (the standard's
  transitions, and libavcodec's reading of the others).  The output drops
  the track's priming samples and the frames past its edit, as libavformat
  does;
* :func:`resample` (``csrc/audio_resample.cu`` ``audio_resample``):
  libswresample's stereo-to-mono rematrix (both channels times 1/sqrt(2)),
  then where the rates differ its default polyphase resampler: a Kaiser
  windowed sinc (32 taps at the output rate's cutoff 0.97, beta 9, one
  phase per output position of the exact rational ratio), the input
  mirrored about its first sample, the flush mirroring its end, and as many
  samples as ``swr_convert`` gives the shim's calls.

A wrapper takes the plain version for CPU tensors; on a CUDA tensor it
launches its kernel (counted in ``fvd_tpu_torch._kernels``) and raises if
the build or the launch fails.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from fractions import Fraction
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from fvd_tpu_torch.ops.mpeg4 import _launch
from fvd_tpu_torch.utils import aac_tables as T
from fvd_tpu_torch.utils.aac import EIGHT_SHORT, LONG_START, LONG_STOP, ONLY_LONG



# --- synthesis ----------------------------------------------------------------------

@lru_cache(maxsize=4)
def _imdct_basis(n: int) -> np.ndarray:
    """``[n / 2, n]`` float64: the IMDCT of length ``n``, (2 / n) cos(2 pi / n
    (i + 1/2 + n/4) (k + 1/2)), over ``aac_tables.PCM_SCALE``."""
    k = np.arange(n // 2)[:, None]
    i = np.arange(n)[None, :]
    m = ((2 * i + 1 + n // 2) * (2 * k + 1)) % (4 * n)
    return np.cos(np.pi * m / (2 * n)) * (2.0 / n) / T.PCM_SCALE


def _halves(coef: np.ndarray, seq: int) -> np.ndarray:
    """One frame's IMDCT, float64 ``[2048]`` long or ``[8, 256]`` short."""
    if seq == EIGHT_SHORT:
        return coef.reshape(8, 128) @ _imdct_basis(256)
    return coef @ _imdct_basis(2048)


def _long_overlap(prev_seq: int, seq: int) -> bool:
    return prev_seq in (ONLY_LONG, LONG_STOP) and seq in (ONLY_LONG, LONG_START)


def _short_frame(x: np.ndarray, shape: int, prev_shape: int) -> np.ndarray:
    """The eight windowed short IMDCTs overlap-added at 448 + 128 w in a
    frame of 2048 (the first window rising with the previous shape)."""
    out = np.zeros(2048)
    fall = T.window(shape, 128)[::-1]
    for w in range(8):
        rise = T.window(prev_shape if w == 0 else shape, 128)
        out[448 + 128 * w:448 + 128 * w + 256] += x[w] * np.concatenate([rise, fall])
    return out


def _left(x, seq, shape, prev_seq, prev_shape) -> np.ndarray:
    """Frame f's first 1024 windowed samples."""
    if seq == EIGHT_SHORT:
        return _short_frame(x, shape, prev_shape)[:1024]
    if _long_overlap(prev_seq, seq):
        return x[:1024] * T.window(prev_shape, 1024)
    win = np.concatenate([np.zeros(448), T.window(prev_shape, 128), np.ones(448)])
    return x[:1024] * win


def _right(x, seq, shape, next_prev_seq, next_seq, next_prev_shape) -> np.ndarray:
    """Frame f's last 1024 windowed samples as frame f + 1 overlaps them."""
    if seq == EIGHT_SHORT:
        return _short_frame(x, shape, shape)[1024:]
    if _long_overlap(next_prev_seq, next_seq):
        return x[1024:] * T.window(next_prev_shape, 1024)[::-1]
    win = np.concatenate([np.ones(448), T.window(next_prev_shape, 128)[::-1], np.zeros(448)])
    return x[1024:] * win


def imdct_synth_plain(coef: np.ndarray, sequence: np.ndarray, shape: np.ndarray, prev_sequence: np.ndarray,
                      prev_shape: np.ndarray) -> np.ndarray:
    """Plain version of ``aac_synth`` in float64, rounded to float32:
    spectra float32 ``[F, C, 1024]`` and per frame and channel the window
    sequence, shape and the previous frame's as the decoder held them ->
    PCM float32 ``[C, F * 1024]`` (frame f's output is the overlap of frame
    f - 1's second half and frame f's first; frame 0 overlaps silence)."""
    f_n, c_n, _ = coef.shape
    out = np.zeros((c_n, f_n * 1024))
    for c in range(c_n):
        prev_x = None
        for f in range(f_n):
            seq, shp, pseq, pshp = (int(a[f, c]) for a in (sequence, shape, prev_sequence, prev_shape))
            x = _halves(coef[f, c].astype(np.float64), seq)
            block = _left(x, seq, shp, pseq, pshp)
            if prev_x is not None:
                block = block + _right(prev_x, int(sequence[f - 1, c]), int(shape[f - 1, c]), pseq, seq, pshp)
            out[c, f * 1024:(f + 1) * 1024] = block
            prev_x = x
    return out.astype(np.float32)


def output_range(frames: int, deltas, media_time: int, edit_duration: Optional[int]) -> Tuple[int, int]:
    """(first, end) samples of a track's decoded PCM that libavformat and
    libavcodec give: the first ``media_time`` samples dropped (the encoder's
    priming), and the frames whose timestamp lies at or past the edit's end
    never output."""
    kept = frames
    if edit_duration is not None:
        t, kept = 0, 0
        for d in deltas[:frames]:
            if t >= media_time + edit_duration:
                break
            kept += 1
            t += d
    return min(media_time, kept * 1024), kept * 1024


# --- resampling ---------------------------------------------------------------------

#: libswresample's defaults: filter_size, phase_shift, cutoff, Kaiser beta
SWR_FILTER_SIZE, SWR_PHASE_SHIFT, SWR_CUTOFF, SWR_KAISER_BETA = 32, 10, 0.97, 9.0


def _bessel(x: float) -> float:
    """libswresample's zeroth-order modified Bessel function (its series,
    summed in its order)."""
    x = x * x / 4
    t, v, last, i = x, 1 + x, 0.0, 1
    while v != last:
        t *= x / ((i + 1) * (i + 1))
        v += t
        last = v
        t *= x / ((i + 2) * (i + 2))
        v += t
        i += 2
    return v


@dataclass(frozen=True)
class Resampler:
    """libswresample's polyphase filter for ``in_rate`` -> ``out_rate``:
    ``phases`` phases (the reduced output rate; output k reads input sample
    ``floor(k step / phases) - center`` on with phase ``(k step) mod
    phases``), ``taps`` float32 ``[phases, length]``."""
    in_rate: int
    out_rate: int
    phases: int
    step: int
    length: int
    taps: np.ndarray

    @property
    def center(self) -> int:
        return (self.length - 1) // 2


@lru_cache(maxsize=8)
def resampler(in_rate: int, out_rate: int) -> Resampler:
    """The filter bank swr builds by default (``build_filter``: a Kaiser
    windowed sinc in float64, normalised to phase 0's sum, rounded to
    float32; an even phase count mirrors the upper phases)."""
    factor = min(out_rate * SWR_CUTOFF / in_rate, 1.0)
    g = math.gcd(in_rate, out_rate)
    phases = 1 << SWR_PHASE_SHIFT
    if out_rate // g <= phases:
        phases = out_rate // g
    else:
        raise ValueError(f"resampling {in_rate} -> {out_rate} Hz needs an inexact phase count")
    length = max(int(math.ceil(SWR_FILTER_SIZE / factor)), 1)
    if length > 1:
        length = (length + 1) & ~1
    center = (length - 1) // 2
    ph_nb = phases if phases % 2 else phases // 2 + 1
    sin_lut = [math.sin(math.pi * ph / phases) * (1 if center & 1 else -1) for ph in range(ph_nb)] \
        if factor == 1.0 else None
    taps = np.zeros((phases + 1, length), np.float32)
    norm = 0.0
    for ph in range(ph_nb):
        s = sin_lut[ph] if sin_lut else 0.0
        tab = []
        for i in range(length):
            x = math.pi * ((i - center) - ph / phases) * factor
            if x == 0:
                y = 1.0
            elif factor == 1.0:
                y = s / x
            else:
                y = math.sin(x) / x
            w = 2.0 * x / (factor * length * math.pi)
            y *= _bessel(SWR_KAISER_BETA * math.sqrt(max(1 - w * w, 0)))
            tab.append(y)
            s = -s
            if not ph:
                norm += y
        taps[ph] = np.asarray(tab) / norm
        if phases % 2 == 0:
            taps[phases - ph] = taps[ph][::-1]
    return Resampler(in_rate, out_rate, phases, in_rate // g, length, taps[:phases].copy())


def resample_count(n: int, rs: Resampler) -> int:
    """How many samples the shim's calls get from swr for ``n`` input
    samples: every output whose window fits the input, then the flush's,
    whose input end is mirrored over half the samples left (at most half a
    filter) and whose output is capped at ``swr_get_delay``'s estimate
    (rounded to nearest) converted to the output rate and rounded up."""
    if n == 0:
        return 0

    def fitting(end):  # outputs k whose window ends inside ``end`` samples
        return max(0, -(-((end - rs.length + rs.center + 1) * rs.phases) // rs.step))

    before = fitting(n)
    left = n - ((before * rs.step) // rs.phases - rs.center)
    reflection = (min(left, rs.length) + 1) // 2
    num = Fraction(n) - Fraction(before * rs.step, rs.phases)
    delay = math.floor(abs(num) + Fraction(1, 2)) * (1 if num >= 0 else -1)
    cap = -(-delay * rs.out_rate // rs.in_rate)
    if cap <= 0:
        cap = 1024
    return before + min(cap, fitting(n + reflection) - before)


def resample_plain(x: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """Plain version of ``audio_resample`` in float64, rounded to float32:
    PCM float32 ``[C, n]`` (1 or 2 channels) -> mono float32 at
    ``out_rate``: the channels' sum times 1/sqrt(2) for two, then, where the
    rates differ, swr's polyphase filter over the input mirrored about its
    first sample and past its end (:func:`resample_count` samples)."""
    x = np.asarray(x, np.float64)
    mono = x[0] if x.shape[0] == 1 else (x[0] + x[1]) * math.sqrt(0.5)
    if in_rate == out_rate:
        return mono.astype(np.float32)
    rs = resampler(in_rate, out_rate)
    n = mono.shape[0]
    m = resample_count(n, rs)
    pad = rs.length + 1
    ext = np.concatenate([mono[1:pad + 1][::-1] if n > pad else np.zeros(pad), mono,
                          mono[::-1][:pad] if n >= pad else np.zeros(pad)])
    k = np.arange(m)
    first = (k * rs.step) // rs.phases - rs.center + pad
    phase = (k * rs.step) % rs.phases
    idx = first[:, None] + np.arange(rs.length)[None, :]
    out = (ext[idx] * rs.taps[phase].astype(np.float64)).sum(axis=1)
    return out.astype(np.float32)


# --- the wrappers ---------------------------------------------------------------------

class _SynthArgs(ctypes.Structure):
    """``SynthArgs`` in ``csrc/aac_synth.cu``."""
    _fields_ = [(f, ctypes.c_int) for f in ("frames", "channels", "tab_len")]


class _ResampleArgs(ctypes.Structure):
    """``ResampleArgs`` in ``csrc/audio_resample.cu``."""
    _fields_ = [("n_in", ctypes.c_longlong), ("n_out", ctypes.c_longlong), ("row_stride", ctypes.c_longlong),
                ("channels", ctypes.c_int), ("phases", ctypes.c_int), ("step", ctypes.c_int),
                ("length", ctypes.c_int)]


def synth_table() -> np.ndarray:
    """``aac_synth``'s float64 table: cos(pi m / 4096) for m < 8192, then the
    rising halves of the long sine and KBD windows and of the short ones."""
    return np.concatenate([np.cos(np.pi * np.arange(8192) / 4096), T.window(0, 1024), T.window(1, 1024),
                           T.window(0, 128), T.window(1, 128)])


@lru_cache(maxsize=4)
def _synth_table_on(device: str) -> torch.Tensor:
    return torch.from_numpy(synth_table()).to(device)


def imdct_synth(coef: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """Spectra float32 ``[F, C, 1024]`` and int8 ``[4, F, C]`` (window
    sequence, shape, previous sequence, previous shape) -> PCM float32 ``[C,
    F * 1024]``: one launch of ``aac_synth`` on CUDA tensors,
    :func:`imdct_synth_plain` on the CPU."""
    if coef.device.type == "cpu" and meta.device.type == "cpu":
        m = meta.numpy()
        return torch.from_numpy(imdct_synth_plain(coef.numpy(), m[0], m[1], m[2], m[3]))
    dev = coef.device
    if dev.type != "cuda" or meta.device != dev:
        raise ValueError(f"imdct_synth: tensors on {coef.device} and {meta.device}; need one CUDA device or the CPU")
    f_n, c_n, width = coef.shape
    if width != 1024 or tuple(meta.shape) != (4, f_n, c_n) or not f_n:
        raise ValueError(f"imdct_synth: spectra {tuple(coef.shape)} and meta {tuple(meta.shape)}")
    coef = coef.to(torch.float32).contiguous()
    meta = meta.to(torch.int8).contiguous()
    tab = _synth_table_on(str(dev))
    out = torch.empty((c_n, f_n * 1024), dtype=torch.float32, device=dev)
    args = _SynthArgs(f_n, c_n, tab.numel())
    _launch("aac_synth", dev, coef.data_ptr(), meta.data_ptr(), tab.data_ptr(), out.data_ptr(),
            ctypes.addressof(args))
    return out


@lru_cache(maxsize=8)
def _taps_on(in_rate: int, out_rate: int, device: str) -> torch.Tensor:
    return torch.from_numpy(resampler(in_rate, out_rate).taps).to(device)


def resample(pcm: torch.Tensor, in_rate: int, out_rate: int) -> torch.Tensor:
    """PCM float32 ``[C, n]`` (1 or 2 channels, rows at any stride) at
    ``in_rate`` -> mono float32 at ``out_rate``, as the shim's swr gives it:
    one launch of ``audio_resample`` on a CUDA tensor (the downmix alone
    where the rates match), :func:`resample_plain` on the CPU."""
    if pcm.dim() != 2 or pcm.shape[0] not in (1, 2):
        raise ValueError(f"resample: PCM {tuple(pcm.shape)} is not [1 or 2, n]")
    if pcm.device.type == "cpu":
        return torch.from_numpy(resample_plain(pcm.numpy(), in_rate, out_rate))
    dev = pcm.device
    if dev.type != "cuda":
        raise ValueError(f"resample: a tensor on {dev}; need a CUDA device or the CPU")
    if pcm.dtype != torch.float32 or pcm.stride(1) != 1:
        pcm = pcm.to(torch.float32).contiguous()
    n = pcm.shape[1]
    if in_rate == out_rate:
        n_out, taps, phases, step, length = n, pcm, 0, 0, 0
    else:
        rs = resampler(in_rate, out_rate)
        n_out, phases, step, length = resample_count(n, rs), rs.phases, rs.step, rs.length
        taps = _taps_on(in_rate, out_rate, str(dev))
    out = torch.empty(n_out, dtype=torch.float32, device=dev)
    if n_out == 0 or n == 0:
        return out
    args = _ResampleArgs(n, n_out, pcm.stride(0), pcm.shape[0], phases, step, length)
    _launch("audio_resample", dev, pcm.data_ptr(), taps.data_ptr(), out.data_ptr(), ctypes.addressof(args))
    return out
