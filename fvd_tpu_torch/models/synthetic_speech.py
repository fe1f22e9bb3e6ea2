"""Formant-synthesized speech for ASR training: the counterpart of
``fvd_tpu/models/synthetic_speech.py``.

The base family, :func:`formant_speech`, is the port's one copy of the
synthesiser (``fvd_tpu_torch/synthetic.py``: a glottal pulse train through
per-phoneme resonators, shaped-noise bursts and closures, formants
interpolated across phoneme boundaries).  :func:`formant_speech_hard` adds
the harder family's four variation axes.  Both are numpy and scipy on the
host, and draw from the caller's ``RandomState`` in the JAX package's order,
so one seed gives the same samples and leaves the same state behind.
"""

from __future__ import annotations

import numpy as np

from fvd_tpu_torch.synthetic import F0, PHONE_S, _FRICATIVES, _SONORANTS, _STOPS, _VOWELS
from fvd_tpu_torch.synthetic import FORMANT_SR as SR
from fvd_tpu_torch.synthetic import _glottal_source, _resonator, _segments, formant_speech

ALPHABET = "abcdefghijklmnopqrstuvwxyz "

__all__ = ["SR", "F0", "PHONE_S", "ALPHABET", "formant_speech", "formant_speech_hard"]


def formant_speech_hard(text: str, rng: np.random.RandomState | None = None,
                        f0: float | None = None,
                        variability: float = 1.0) -> np.ndarray:
    """The harder speech family: the source-filter synthesis of
    :func:`formant_speech` plus four variation axes of real speech that the
    fixed-grid family lacks:

    * **rate variation**: per-segment duration jitter (log-normal), the
      total renormalised to the nominal utterance budget, so the mel window
      the trainer pads to never overflows;
    * **coarticulation undershoot**: voiced formant targets pulled toward
      their neighbours' mean;
    * **prosodic F0 drift**: a slow random pitch contour instead of a
      constant glottal period;
    * **room reverb**: convolution with an exponentially decaying noise
      impulse response (``scipy.signal.fftconvolve``; wet mix scaled by
      ``variability``).

    ``variability=0`` degenerates to (approximately) the base family.
    """
    rng = rng or np.random.RandomState(0)
    v = float(variability)
    f0 = f0 or F0 * (1.0 + 0.15 * (rng.rand() - 0.5))
    segs = _segments(text.lower())
    if not segs:
        return np.zeros(int(PHONE_S * SR), np.float32)

    n_nom = int(PHONE_S * SR)
    total = n_nom * len(segs)

    # per-segment durations: log-normal jitter, renormalised to the nominal
    # total (duration redistributes between segments; budget never grows)
    rates = np.exp(rng.uniform(-0.45, 0.45, len(segs)) * v)
    rates *= len(segs) / rates.sum()
    seg_lens = np.maximum((rates * n_nom).astype(int), n_nom // 3)
    seg_lens[-1] = max(total - int(seg_lens[:-1].sum()), n_nom // 3)
    bounds = np.concatenate([[0], np.cumsum(seg_lens)]).astype(int)
    total = int(bounds[-1])

    targets = np.full((len(segs), 3), np.nan)
    voiced_amp = np.zeros(len(segs))
    for i, (kind, ch) in enumerate(segs):
        if kind == "vowel":
            targets[i] = _VOWELS[ch]
            voiced_amp[i] = 1.0
        elif kind == "sonorant":
            targets[i] = _SONORANTS[ch]
            voiced_amp[i] = 0.7
        elif kind == "fricative" and _FRICATIVES[ch][2]:
            voiced_amp[i] = 0.25

    # coarticulation undershoot: pull each voiced target toward the mean of
    # its voiced neighbours
    voiced_idx = np.where(~np.isnan(targets[:, 0]))[0]
    if len(voiced_idx) >= 2 and v > 0:
        pulled = targets[voiced_idx].copy()
        for j, i in enumerate(voiced_idx):
            nb = [voiced_idx[k] for k in (j - 1, j + 1) if 0 <= k < len(voiced_idx)]
            alpha = rng.uniform(0.0, 0.35) * v
            pulled[j] = (1 - alpha) * targets[i] + alpha * targets[nb].mean(axis=0)
        targets[voiced_idx] = pulled

    centers = (bounds[:-1] + bounds[1:]) / 2.0
    sample_t = np.arange(total)
    tracks = np.zeros((3, total), np.float32)
    for k in range(3):
        if len(voiced_idx) == 0:
            tracks[k] = 500.0 * (k + 1)
        else:
            tracks[k] = np.interp(sample_t, centers[voiced_idx], targets[voiced_idx, k])

    # amplitude envelope with per-segment edge ramps
    amp = np.zeros(total, np.float32)
    for i in range(len(segs)):
        lo, hi = bounds[i], bounds[i + 1]
        n_i = hi - lo
        ramp = np.ones(n_i, np.float32)
        edge = max(1, n_i // 6)
        ramp[:edge] = np.linspace(0, 1, edge)
        ramp[-edge:] = np.linspace(1, 0, edge)
        amp[lo:hi] = voiced_amp[i] * ramp

    # prosodic F0 drift: smooth random contour (random walk low-passed)
    if v > 0:
        knots = 1.0 + 0.12 * v * np.cumsum(rng.randn(8))
        knots /= np.abs(knots).mean() + 1e-9
        f0_track = (f0 * np.interp(sample_t, np.linspace(0, total - 1, 8),
                                   np.clip(knots, 0.7, 1.4))).astype(np.float32)
    else:
        f0_track = None
    source = _glottal_source(total, f0, rng, f0_track=f0_track) * amp

    voiced = np.zeros(total, np.float32)
    for i in range(len(segs)):
        lo, hi = bounds[i], bounds[i + 1]
        if voiced_amp[i] <= 0:
            continue
        seg = source[lo:hi]
        acc = np.zeros(hi - lo, np.float32)
        for k, bw in enumerate((60.0, 90.0, 150.0)):
            fk = float(np.mean(tracks[k, lo:hi]))
            acc += _resonator(seg, fk, bw).astype(np.float32) * (1.0, 0.63, 0.32)[k]
        voiced[lo:hi] = acc

    noise_part = np.zeros(total, np.float32)
    for i, (kind, ch) in enumerate(segs):
        lo, hi = bounds[i], bounds[i + 1]
        n_i = hi - lo
        if kind == "fricative":
            band, bw, _ = _FRICATIVES[ch]
            noise = rng.randn(n_i).astype(np.float32)
            noise_part[lo:hi] += 0.5 * _resonator(noise, band, bw).astype(np.float32)
        elif kind == "stop":
            band, voiced_stop = _STOPS[ch]
            burst = np.zeros(n_i, np.float32)
            b0 = int(n_i * 0.6)
            burst[b0:] = rng.randn(n_i - b0)
            burst[b0:] *= np.exp(-np.linspace(0, 6, n_i - b0))
            noise_part[lo:hi] += 0.9 * _resonator(burst, band, 800.0).astype(np.float32)
            if voiced_stop:
                noise_part[lo:hi] += 0.15 * _glottal_source(n_i, f0, rng)

    out = voiced + noise_part

    # room reverb: exponentially decaying noise IR, truncated convolution
    if v > 0 and rng.rand() < 0.8:
        from scipy.signal import fftconvolve

        ir_len = int(SR * rng.uniform(0.06, 0.14))
        tt = np.arange(ir_len) / SR
        ir = rng.randn(ir_len).astype(np.float32) * np.exp(-tt / rng.uniform(0.015, 0.05)).astype(np.float32)
        ir[0] = 1.0
        ir /= np.abs(ir).sum() + 1e-9
        wet = rng.uniform(0.1, 0.35) * v
        out = (1 - wet) * out + wet * fftconvolve(out, ir)[:total].astype(np.float32)

    peak = np.max(np.abs(out)) + 1e-9
    return (0.4 * out / peak).astype(np.float32)
