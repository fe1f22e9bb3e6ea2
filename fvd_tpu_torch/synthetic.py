"""Synthetic media and model stand-ins for the port: ``make_face_video`` and
the gated and tone-coded audio it uses, ``make_synthetic_video`` and the
deterministic providers of ``hermetic_providers``, the counterparts of those
in ``fvd_tpu/synthetic.py``, drawn with numpy (``fvd_tpu_torch/utils/draw.py``)
so that they can be made where OpenCV is not installed.

The clip is an elliptical face whose mouth aperture follows the same gate as
its audio track, with a slow centre drift that exercises IoU tracking; it is
written as a raw-RGBA AVI with a sibling ``.wav``.  By default the face is
drawn with pixel-centre shapes; ``opencv=True`` draws OpenCV's, and then the
frames equal the JAX package's before its mp4 encoding, manipulation levers
included.

:func:`formant_speech` is the port's copy of
``fvd_tpu/models/synthetic_speech.py``'s source-filter synthesizer (the
domain of the shipped Whisper checkpoint), the same samples for the same
seed.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from fvd_tpu_torch.providers.media import write_video
from fvd_tpu_torch.providers.vision import FaceBox
from fvd_tpu_torch.utils import cv, draw
from fvd_tpu_torch.utils.wav import write_wav


def make_synthetic_video(
    dirpath: str,
    name: str = "clip",
    duration: float = 6.0,
    fps: float = 10.0,
    width: int = 160,
    height: int = 120,
    gate_hz: float = 1.0,
    sr: int = 16000,
) -> str:
    """Bright-square 'face' video + gated-tone sibling wav; the mouth strip
    and the audio share the same gate -> positive lip-sync correlation.

    The frames and samples are the JAX package's; the file is a raw-RGBA AVI
    at the path the JAX package uses, ``<name>.mp4`` (IN and ``VideoReader``
    read by content, and OpenCV reads it too)."""
    os.makedirs(dirpath, exist_ok=True)
    n = int(fps * duration)
    x1, y1 = int(width * 0.25), int(height * 0.17)
    x2, y2 = int(width * 0.69), int(height * 0.75)
    frames = np.zeros((n, height, width, 3), np.uint8)
    for i in range(n):
        frames[i, :, :] = 16
        frames[i, y1:y2, x1:x2] = 200
        gate = 0.5 * (1 + np.sin(2 * np.pi * gate_hz * (i / fps)))
        mh = int(4 + 10 * gate)
        my = int(height * 0.58)
        frames[i, my: my + mh, int(width * 0.38): int(width * 0.56)] = 60
    video_path = os.path.join(dirpath, f"{name}.mp4")
    write_video(video_path, frames, fps)

    t = np.arange(int(sr * duration)) / sr
    gate = (np.sin(2 * np.pi * gate_hz * t) > 0).astype(np.float32)
    sig = 0.5 * np.sin(2 * np.pi * 330 * t).astype(np.float32) * gate
    write_wav(os.path.join(dirpath, f"{name}.wav"), sig, sr)
    return video_path


def _build_template() -> np.ndarray:
    """68-point template in a unit face box (x, y in [0, 1]), iBUG-68
    topology: 0-16 jaw, 17-26 brows, 27-35 nose, 36-47 eyes, 48-67 mouth."""
    t = np.zeros((68, 2))
    ang = np.linspace(np.pi * 0.1, np.pi * 0.9, 17)
    t[:17, 0] = 0.5 + 0.48 * np.cos(ang[::-1])
    t[:17, 1] = 0.55 + 0.45 * np.sin(ang[::-1])
    for i, x in enumerate(np.linspace(0.2, 0.42, 5)):
        t[17 + i] = [x, 0.3]
    for i, x in enumerate(np.linspace(0.58, 0.8, 5)):
        t[22 + i] = [x, 0.3]
    for i, y in enumerate(np.linspace(0.38, 0.58, 4)):
        t[27 + i] = [0.5, y]
    for i, x in enumerate(np.linspace(0.42, 0.58, 5)):
        t[31 + i] = [x, 0.62]
    for base, cx in ((36, 0.31), (42, 0.69)):
        ex, ey, rw, rh = cx, 0.4, 0.08, 0.03
        a = np.array([0, 60, 120, 180, 240, 300]) * np.pi / 180
        t[base: base + 6, 0] = ex + rw * np.cos(a)
        t[base: base + 6, 1] = ey - rh * np.sin(a)
    a = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    t[48:60, 0] = 0.5 + 0.16 * np.cos(a)
    t[48:60, 1] = 0.78 + 0.07 * np.sin(a)
    a = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    t[60:68, 0] = 0.5 + 0.1 * np.cos(a)
    t[60:68, 1] = 0.78 + 0.045 * np.sin(a)
    return t


TEMPLATE_68 = _build_template()


def draw_face(img: np.ndarray, cx: float, cy: float, fw: float, fh: float, skin: np.ndarray,
              aperture: float | None = None, opencv: bool = True) -> np.ndarray:
    """Draw one face into ``img`` (in place) with its mouth open by
    ``aperture`` in [0, 1]; -> landmarks [68, 2] px.  ``None`` keeps the
    fixed mouth of the template, which the detector and pose batches draw.
    ``opencv``: OpenCV's rasterisation, the JAX package's pixels; else the
    pixel-centre shapes the synthetic clips are drawn with."""
    fill_ellipse, polyline = ((draw.fill_ellipse, draw.polyline) if opencv
                              else (draw.fill_ellipse_centres, draw.polyline_centres))
    fill_ellipse(img, (int(cx), int(cy)), (int(fw / 2), int(fh / 2)), skin.tolist())
    x1, y1 = cx - fw / 2, cy - fh / 2
    pts = TEMPLATE_68.copy()
    if aperture is not None:
        out_ry = 0.02 + 0.09 * float(aperture)
        in_ry = out_ry * 0.64
        pts[48:60, 1] = 0.78 + out_ry * np.sin(np.linspace(0, 2 * np.pi, 12, endpoint=False))
        pts[60:68, 1] = 0.78 + in_ry * np.sin(np.linspace(0, 2 * np.pi, 8, endpoint=False))
    pts[:, 0] = x1 + pts[:, 0] * fw
    pts[:, 1] = y1 + pts[:, 1] * fh

    dark = (skin * 0.35).astype(int).tolist()
    for base in (36, 42):  # eyes
        center = pts[base: base + 6].mean(axis=0).astype(int)
        fill_ellipse(img, center, (max(2, int(fw * 0.08)), max(1, int(fw * 0.035))), dark)
    for sl in (slice(17, 22), slice(22, 27)):  # brows
        polyline(img, pts[sl].astype(np.int32), max(1, int(fw * 0.02)), dark)
    mouth_c = pts[48:60].mean(axis=0).astype(int)  # vertical radius follows the aperture
    mouth_ry = max(1, int(fh * out_ry)) if aperture is not None else max(1, int(fw * 0.06))
    fill_ellipse(img, mouth_c, (max(2, int(fw * 0.16)), mouth_ry), (120, 40, 40))
    polyline(img, pts[27:31].astype(np.int32), max(1, int(fw * 0.015)), dark)  # nose
    return pts.astype(np.float32)


TONE_ALPHABET = "abcdefghijklmnopqrstuvwxyz "
TONE_SR = 16000
TONE_CHAR_S = 0.08
TONE_BASE_HZ = 300.0
TONE_STEP_HZ = 60.0


def tone_speech(text: str, rng: np.random.RandomState | None = None) -> np.ndarray:
    """Tone-coded 'speech': each character is a Hann-windowed sine on a
    frequency ladder."""
    n = int(TONE_SR * TONE_CHAR_S)
    t = np.arange(n) / TONE_SR
    chunks = []
    for ch in text:
        k = TONE_ALPHABET.index(ch)
        f = TONE_BASE_HZ + k * TONE_STEP_HZ
        chunks.append(0.4 * np.sin(2 * np.pi * f * t) * np.hanning(n))
    audio = np.concatenate(chunks) if chunks else np.zeros(n)
    if rng is not None:
        audio = audio + 0.01 * rng.randn(len(audio))
    return audio.astype(np.float32)


def gated_speech(text: str, duration: float, gate_hz: float = 1.0, sr: int = TONE_SR,
                 rng: np.random.RandomState | None = None, renderer: str = "tone") -> np.ndarray:
    """Tone-coded speech (``renderer="formant"``: :func:`formant_speech`)
    phrased into the gate's on-windows: words are packed greedily into
    successive gate-on half-periods (the mouth-open phases of the face), with
    silence between; text beyond the clip is dropped."""
    if renderer.startswith("formant"):
        char_s, render = PHONE_S, formant_speech
    else:
        char_s, render = TONE_CHAR_S, tone_speech
    n_total = int(sr * duration)
    audio = np.zeros(n_total, np.float32)
    on_s = 0.5 / gate_hz  # gate = sin(2*pi*gate_hz*t) > 0: first half-period
    period = 1.0 / gate_hz
    max_chars = min(int(on_s / char_s), 10)
    words = [w for w in text.split() if w]
    wi = 0
    k = 0
    while wi < len(words) and k * period < duration:
        phrase = ""
        while wi < len(words):
            cand = words[wi] if not phrase else f"{phrase} {words[wi]}"
            if len(cand) > max_chars:
                break
            phrase = cand
            wi += 1
        if not phrase:
            # a word longer than any window: render it anyway, spilling past
            # the gate-on phase
            phrase = words[wi][: max_chars + 4]
            wi += 1
        a = render(phrase, rng)
        i0 = int(k * period * sr)
        i1 = min(i0 + len(a), n_total)
        audio[i0:i1] = a[: i1 - i0]
        k += 1
    return audio


FORMANT_SR = 16000
F0 = 115.0          # glottal pitch (Hz); jittered per utterance
PHONE_S = 0.095     # nominal per-letter duration

#: vowels: (F1, F2, F3) steady-state targets (classic Peterson-Barney-ish)
_VOWELS: Dict[str, Tuple[float, float, float]] = {
    "a": (730.0, 1090.0, 2440.0),
    "e": (530.0, 1840.0, 2480.0),
    "i": (270.0, 2290.0, 3010.0),
    "o": (570.0, 840.0, 2410.0),
    "u": (300.0, 870.0, 2240.0),
    "y": (300.0, 2100.0, 2900.0),
}

#: approximants/nasals: voiced, with their own formant targets
_SONORANTS: Dict[str, Tuple[float, float, float]] = {
    "l": (360.0, 1300.0, 2700.0),
    "r": (420.0, 1300.0, 1600.0),
    "m": (250.0, 1000.0, 2200.0),
    "n": (250.0, 1700.0, 2600.0),
    "w": (290.0, 700.0, 2300.0),
    "h": (500.0, 1500.0, 2500.0),
}

#: fricatives: (noise band center, bandwidth, voiced?)
_FRICATIVES: Dict[str, Tuple[float, float, bool]] = {
    "s": (5500.0, 2500.0, False),
    "z": (5500.0, 2500.0, True),
    "f": (4200.0, 3500.0, False),
    "v": (4200.0, 3500.0, True),
    "x": (3400.0, 2400.0, False),
    "j": (2800.0, 1800.0, True),
    "c": (3000.0, 2000.0, False),
    "q": (2200.0, 1500.0, False),
}

#: stops: (burst band center, voiced?) — closure gap then a noise burst
_STOPS: Dict[str, Tuple[float, bool]] = {
    "p": (1200.0, False),
    "b": (1200.0, True),
    "t": (4000.0, False),
    "d": (4000.0, True),
    "k": (2200.0, False),
    "g": (2200.0, True),
}


def _resonator(x: np.ndarray, freq: float, bw: float, sr: int = FORMANT_SR) -> np.ndarray:
    """Second-order all-pole resonator (the formant filter of a classic
    Klatt-style synthesizer), streamed with scipy's lfilter."""
    from scipy.signal import lfilter

    r = np.exp(-np.pi * bw / sr)
    theta = 2.0 * np.pi * freq / sr
    a = [1.0, -2.0 * r * np.cos(theta), r * r]
    gain = (1.0 - r) * np.sqrt(1.0 - 2.0 * r * np.cos(2 * theta) + r * r)
    return lfilter([gain], a, x)


def _glottal_source(n: int, f0: float, rng: np.random.RandomState,
                    f0_track: np.ndarray | None = None) -> np.ndarray:
    """Impulse-ish train with shimmer/jitter — the voiced excitation.

    ``f0_track`` (optional, [n]): per-sample pitch for prosodic drift —
    each pulse period is read from the local track value."""
    out = np.zeros(n, np.float32)
    t = 0.0
    while t < n:
        i = int(t)
        if i < n:
            out[i] = 1.0 + 0.1 * rng.randn()
        local_f0 = float(f0_track[min(i, n - 1)]) if f0_track is not None else f0
        t += (FORMANT_SR / max(local_f0, 40.0)) * (1.0 + 0.01 * rng.randn())
    # one-pole lowpass to soften the pulses (glottal rolloff)
    from scipy.signal import lfilter

    return lfilter([1.0], [1.0, -0.9], out).astype(np.float32)


def _segments(text: str) -> List[Tuple[str, str]]:
    """letters -> (kind, char) segment list; kinds: vowel / sonorant /
    fricative / stop / space."""
    segs = []
    for ch in text:
        if ch in _VOWELS:
            segs.append(("vowel", ch))
        elif ch in _SONORANTS:
            segs.append(("sonorant", ch))
        elif ch in _FRICATIVES:
            segs.append(("fricative", ch))
        elif ch in _STOPS:
            segs.append(("stop", ch))
        else:
            segs.append(("space", ch))
    return segs


def formant_speech(text: str, rng: np.random.RandomState | None = None,
                   f0: float | None = None) -> np.ndarray:
    """Synthesize ``text`` (lowercase letters + spaces) -> float32 PCM at
    16 kHz.  Voiced segments share one continuous glottal source filtered
    through formant tracks that interpolate across segment boundaries;
    consonants contribute closures and shaped noise."""
    rng = rng or np.random.RandomState(0)
    f0 = f0 or F0 * (1.0 + 0.15 * (rng.rand() - 0.5))
    segs = _segments(text.lower())
    if not segs:
        return np.zeros(int(PHONE_S * FORMANT_SR), np.float32)

    n_seg = int(PHONE_S * FORMANT_SR)
    total = n_seg * len(segs)

    # formant target track per segment (NaN: unvoiced/silent)
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
            voiced_amp[i] = 0.25  # voiced fricatives keep some buzz

    # continuous formant tracks: linear interp between voiced segment
    # centers (coarticulation); unvoiced gaps inherit neighbors
    centers = (np.arange(len(segs)) + 0.5) * n_seg
    sample_t = np.arange(total)
    tracks = np.zeros((3, total), np.float32)
    voiced_idx = np.where(~np.isnan(targets[:, 0]))[0]
    for k in range(3):
        if len(voiced_idx) == 0:
            tracks[k] = 500.0 * (k + 1)
        else:
            tracks[k] = np.interp(sample_t, centers[voiced_idx],
                                  targets[voiced_idx, k])

    # voiced amplitude envelope with soft onsets/offsets
    amp = np.repeat(voiced_amp, n_seg).astype(np.float32)
    ramp = np.ones(n_seg, np.float32)
    edge = max(1, n_seg // 6)
    ramp[:edge] = np.linspace(0, 1, edge)
    ramp[-edge:] = np.linspace(1, 0, edge)
    amp *= np.tile(ramp, len(segs))

    source = _glottal_source(total, f0, rng) * amp

    # piecewise-constant formant filtering per segment (tracks move slowly;
    # per-segment resonators with interpolated center freqs approximate a
    # time-varying filter without per-sample IIR updates)
    voiced = np.zeros(total, np.float32)
    for i in range(len(segs)):
        lo, hi = i * n_seg, (i + 1) * n_seg
        if voiced_amp[i] <= 0:
            continue
        seg = source[lo:hi]
        acc = np.zeros(n_seg, np.float32)
        for k, bw in enumerate((60.0, 90.0, 150.0)):
            fk = float(np.mean(tracks[k, lo:hi]))
            acc += _resonator(seg, fk, bw).astype(np.float32) * (1.0, 0.63, 0.32)[k]
        voiced[lo:hi] = acc

    # consonant noise: fricative bands and stop bursts
    noise_part = np.zeros(total, np.float32)
    for i, (kind, ch) in enumerate(segs):
        lo, hi = i * n_seg, (i + 1) * n_seg
        if kind == "fricative":
            band, bw, _ = _FRICATIVES[ch]
            noise = rng.randn(n_seg).astype(np.float32)
            noise_part[lo:hi] += 0.5 * _resonator(noise, band, bw).astype(np.float32)
        elif kind == "stop":
            band, voiced_stop = _STOPS[ch]
            # closure (silence) for the first 60%, then a burst
            burst = np.zeros(n_seg, np.float32)
            b0 = int(n_seg * 0.6)
            burst[b0:] = rng.randn(n_seg - b0)
            burst[b0:] *= np.exp(-np.linspace(0, 6, n_seg - b0))
            noise_part[lo:hi] += 0.9 * _resonator(burst, band, 800.0).astype(np.float32)
            if voiced_stop:
                noise_part[lo:hi] += 0.15 * _glottal_source(n_seg, f0, rng)

    out = voiced + noise_part
    peak = np.max(np.abs(out)) + 1e-9
    return (0.4 * out / peak).astype(np.float32)


def make_face_video(
    dirpath: str,
    name: str = "face",
    duration: float = 6.0,
    fps: float = 10.0,
    width: int = 320,
    height: int = 240,
    gate_hz: float = 1.0,
    sr: int = 16000,
    seed: int = 0,
    speech_text: str | None = None,
    audio_offset_s: float = 0.0,
    texture_noise: float = 0.0,
    sensor_noise: float = 0.0,
    pose_jitter: float = 0.0,
    mouth_gate_hz: float | None = None,
    speech: str = "tone",
    heldout: bool = False,
    opencv: bool = False,
    container: str = "avi",
    device=None,
) -> str:
    """A face clip ``<dirpath>/<name>.avi`` and its audio ``<name>.wav``;
    with ``container="mp4"``, ``<name>.mp4`` in ``mp4v`` as the JAX function
    writes it, encoded on ``device`` (default the card).

    The mouth opens with ``0.5 * (1 + sin(2 pi mouth_gate_hz t))`` and the
    audio is a 330 Hz tone gated by ``sin(2 pi gate_hz t) > 0`` (or tone-coded
    ``speech_text`` in the gate's on-windows; with ``speech="formant"``,
    ``speech_text`` as one :func:`formant_speech` utterance from 0.5 s; with
    ``speech="formant_gated"``, formant phrases in the gate's on-windows, the
    JAX package's ``speech_renderer="formant"``; both formant kinds at 16 kHz
    only).  ``opencv``: draw the face with OpenCV's rasterisation
    (:func:`draw_face`), the JAX package's pixels; else pixel-centre shapes.

    Deepfake-style manipulation levers (the labeled-corpus generator's,
    mirroring the signals the reference's LR weights act on —
    lr_weights.json: texture +0.82, lip_sync -0.46, headpose_jerk +0.08):

    * ``audio_offset_s`` — delay the audio track relative to the mouth
      gate (circular shift).  C1 searches lags up to ±max_lag_s (0.5 s),
      and a periodic gate realigns at full periods — a true lip-sync break
      needs ``mouth_gate_hz``.
    * ``mouth_gate_hz`` (default ``gate_hz``) — drive the mouth at a
      different (incommensurate) frequency than the audio gate: the
      dubbed/face-swapped mouth that no lag can align, collapsing C1's score.
    * ``texture_noise`` — additive Gaussian noise (that sigma) inside the
      face region only: the blend-seam/GAN-artifact analog V5's forensic
      analysis reacts to.
    * ``pose_jitter`` — per-frame random head-centre displacement (pixels):
      raises V4's headpose_jerk and destabilizes landmark tracks.
    * ``sensor_noise`` — additive Gaussian noise over the WHOLE frame: not
      a manipulation but real-world capture degradation (low-light sensor
      noise, heavy recompression).  Applied to label-real clips it builds
      the classic false-positive hard case: V5's forensic texture score
      rises and landmark and lip tracking degrade on a genuine video, the
      signature of the reference corpus's noisy reals (its BBC News real
      carries texture 0.65).
    * ``heldout`` — the held-out face distribution as a video: a striped
      gradient background, eccentricity and skin outside the training
      ranges, glasses and hair the training renderer never draws (always
      with OpenCV's rasterisation, whatever ``opencv`` says) — whether the
      pipeline's signals survive on faces the models never trained on.

    Every random draw comes from one ``RandomState(seed)`` in the JAX
    package's order: background and skin, then per frame the jitter pair,
    the face-region noise and the whole-frame noise."""
    formant = speech in ("formant", "formant_gated")
    if speech not in ("tone", "formant", "formant_gated") or (formant and sr != FORMANT_SR):
        raise ValueError(f"speech={speech!r} at {sr} Hz: tone at any rate, or formant at {FORMANT_SR} Hz")
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.RandomState(seed)
    fh = 0.62 * height
    if heldout:
        background = np.zeros((height, width, 3), np.uint8)
        base = rng.rand(3) * 150
        grad = np.linspace(0, 80, height)[:, None]
        for c in range(3):
            background[..., c] = np.clip(
                base[c] + grad + 25 * np.sin(np.arange(width)[None, :] / rng.uniform(6, 18)), 0, 255)
        skin = np.array([rng.randint(130, 255), rng.randint(100, 210), rng.randint(80, 200)])
        fw = fh / 1.52  # eccentricity outside the training [1.1, 1.4]
    else:
        background = cv.blur_u8((rng.rand(height, width, 3) * 60 + rng.rand(3) * 120).astype(np.uint8), 5)
        skin = np.array([rng.randint(160, 230), rng.randint(120, 190), rng.randint(100, 170)])
        fw = fh / 1.25
    n = int(fps * duration)
    frames = np.zeros((n, height, width, 3), np.uint8)
    mouth_hz = gate_hz if mouth_gate_hz is None else mouth_gate_hz
    for i in range(n):
        t = i / fps
        gate = 0.5 * (1 + np.sin(2 * np.pi * mouth_hz * t))
        cx = width / 2 + 0.06 * width * np.sin(2 * np.pi * 0.05 * t)
        cy = height / 2 + 0.04 * height * np.cos(2 * np.pi * 0.07 * t)
        if pose_jitter > 0:
            cx += pose_jitter * rng.randn()
            cy += pose_jitter * rng.randn()
        frame = background.copy()
        pts = draw_face(frame, cx, cy, fw, fh, skin, aperture=gate, opencv=opencv)
        if heldout:  # glasses rings, their bridge, the hair arc
            dark = tuple((skin * 0.3).astype(int).tolist())
            for base_i in (36, 42):
                c = pts[base_i: base_i + 6].mean(axis=0).astype(int)
                draw.circle(frame, c, max(3, int(fw * 0.12)), dark, 2)
            left = pts[36:42].mean(axis=0).astype(int)
            right = pts[42:48].mean(axis=0).astype(int)
            draw.line(frame, left, right, 2, dark)
            draw.fill_ellipse(frame, (int(cx), int(cy - 0.1 * fh)), (int(fw * 0.55), int(fh * 0.5)), dark,
                              0.0, 180, 360)
        if texture_noise > 0:
            # only the top-left corner is clamped: numpy's slice clipping
            # sets how many draws the region takes at the far edges
            y0, y1 = int(cy - fh / 2), int(cy + fh / 2)
            x0, x1 = int(cx - fw / 2), int(cx + fw / 2)
            y0, x0 = max(y0, 0), max(x0, 0)
            region = frame[y0:y1, x0:x1].astype(np.float32)
            region += texture_noise * rng.randn(*region.shape)
            frame[y0:y1, x0:x1] = np.clip(region, 0, 255).astype(np.uint8)
        if sensor_noise > 0:
            noisy = frame.astype(np.float32) + sensor_noise * rng.randn(*frame.shape)
            frame = np.clip(noisy, 0, 255).astype(np.uint8)
        frames[i] = frame
    video_path = os.path.join(dirpath, f"{name}.{container}")
    write_video(video_path, frames, fps, container=container, device=device)

    if speech_text is not None and speech == "formant":
        sig = np.zeros(int(sr * duration), np.float32)
        utterance = formant_speech(speech_text, np.random.RandomState(seed))[:len(sig) - sr // 2]
        sig[sr // 2:sr // 2 + len(utterance)] = utterance
    elif speech_text is not None:
        sig = gated_speech(speech_text, duration, gate_hz=gate_hz, sr=sr,
                           renderer="formant" if formant else "tone")
    else:
        t = np.arange(int(sr * duration)) / sr
        gate = (np.sin(2 * np.pi * gate_hz * t) > 0).astype(np.float32)
        sig = 0.5 * np.sin(2 * np.pi * 330 * t).astype(np.float32) * gate
    if audio_offset_s:
        sig = np.roll(sig, int(audio_offset_s * sr))
    write_wav(os.path.join(dirpath, f"{name}.wav"), sig, sr)
    return video_path


def _bright_boxes(frames: np.ndarray):
    """Vectorized bright-square bounding boxes over a frame batch.

    Returns (has, x1, y1, x2, y2) with inclusive int pixel extents.
    ``sum > 360`` on uint16 is exactly ``mean(axis=-1) > 120``.
    """
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:  # the fast paths below assume uint8 frames
        frames = np.clip(frames, 0, 255).astype(np.uint8)
    sums = frames[..., 0].astype(np.uint16)
    sums += frames[..., 1]
    sums += frames[..., 2]
    mask = sums > 360  # [B, H, W]
    rows = mask.any(axis=2)  # [B, H]
    cols = mask.any(axis=1)  # [B, W]
    has = rows.any(axis=1)
    y1 = rows.argmax(axis=1)
    y2 = rows.shape[1] - 1 - rows[:, ::-1].argmax(axis=1)
    x1 = cols.argmax(axis=1)
    x2 = cols.shape[1] - 1 - cols[:, ::-1].argmax(axis=1)
    return has, x1, y1, x2, y2


class SyntheticFaceDetector:
    """Finds the bright square — a deterministic FaceDetectorProvider."""

    model_name = "synthetic_blob"

    def detect_batch(self, frames: np.ndarray) -> List[List[FaceBox]]:
        has, x1, y1, x2, y2 = _bright_boxes(frames)
        return [
            [FaceBox(float(x1[i]), float(y1[i]), float(x2[i] + 1), float(y2[i] + 1), 0.95)] if has[i] else []
            for i in range(len(has))
        ]


class SyntheticLandmarks:
    """68-point landmark + pose provider driven by the bright-square layout.

    Mouth aperture follows the configured gate so C1 sees a syncable MAR
    track; eyes get plausible EAR geometry; poses drift smoothly.
    """

    model_name = "synthetic_landmarks"

    def __init__(self, fps: float = 10.0, gate_hz: float = 1.0):
        self.fps = fps
        self.gate_hz = gate_hz
        self._call = 0

    def landmarks_batch(self, frames: np.ndarray, device_frames=None) -> List[List[np.ndarray]]:
        """One vectorized pass over the batch; ``device_frames`` is unused:
        this fixture computes on the host."""
        frames = np.asarray(frames)
        if frames.dtype != np.uint8:  # the mouth-strip range check is uint8
            frames = np.clip(frames, 0, 255).astype(np.uint8)
        b = len(frames)
        if b == 0:
            return []
        has, x1, y1, x2, y2 = _bright_boxes(frames)
        cx = (x1 + x2) / 2
        cy = (y1 + y2) / 2
        half = np.maximum((x2 - x1) / 2, 12)

        # aperture measured from the rendered mouth strip (content-based, so
        # chunked streaming sees identical landmarks regardless of batch
        # boundaries; the strip height encodes the gate). |v-60|<10 on uint8
        # == 51..69 inclusive; the wraparound subtract needs one pass.
        in_range = (frames - np.uint8(51)) <= np.uint8(18)
        mouth_mask = in_range[..., 0] & in_range[..., 1] & in_range[..., 2]
        strip = mouth_mask.any(axis=2)  # [B, H]
        has_strip = strip.any(axis=1)
        r1 = strip.argmax(axis=1)
        r2 = strip.shape[1] - 1 - strip[:, ::-1].argmax(axis=1)
        i = np.arange(b)
        gate = 0.5 * (1 + np.sin(2 * np.pi * self.gate_hz * (i / self.fps)))
        aperture = np.where(has_strip, 2 + (r2 - r1), 2 + 10 * gate)

        pts = np.zeros((b, 68, 2))
        ang = np.linspace(0, 2 * np.pi, 48, endpoint=False)
        pts[:, :48, 0] = cx[:, None] + 0.8 * half[:, None] * np.cos(ang)
        pts[:, :48, 1] = cy[:, None] + 0.8 * half[:, None] * np.sin(ang)
        ey = cy - 0.3 * half
        for base, ex in ((36, cx - 0.4 * half), (42, cx + 0.4 * half)):
            pts[:, base + 0] = np.stack([ex - 6, ey], axis=1)
            pts[:, base + 3] = np.stack([ex + 6, ey], axis=1)
            pts[:, base + 1] = np.stack([ex - 2, ey - 2], axis=1)
            pts[:, base + 2] = np.stack([ex + 2, ey - 2], axis=1)
            pts[:, base + 4] = np.stack([ex + 2, ey + 2], axis=1)
            pts[:, base + 5] = np.stack([ex - 2, ey + 2], axis=1)
        mcx, mcy = cx, cy + 0.5 * half
        outer = np.linspace(0, 2 * np.pi, 12, endpoint=False)
        pts[:, 48:60, 0] = mcx[:, None] + 12 * np.cos(outer)
        pts[:, 48:60, 1] = mcy[:, None] + aperture[:, None] * np.sin(outer)
        inner = np.linspace(0, 2 * np.pi, 8, endpoint=False)
        pts[:, 60:68, 0] = mcx[:, None] + 8 * np.cos(inner)
        pts[:, 60:68, 1] = mcy[:, None] + 0.7 * aperture[:, None] * np.sin(inner)
        return [[pts[k]] if has[k] else [] for k in range(b)]

    def pose_batch(self, crops: np.ndarray) -> np.ndarray:
        n = len(crops)
        idx = np.arange(self._call, self._call + n)
        self._call += n
        return np.stack([10 + 2 * np.sin(idx / 5.0), (idx * 0.5) % 20.0, np.full(n, 5.0)], axis=1)


def hermetic_providers(fps: float = 10.0, gate_hz: float = 1.0, device=None):
    """Provider bundle with no network and no weights: the energy VAD on
    ``device`` (default the card), deterministic everything else."""
    from fvd_tpu_torch.providers import Providers
    from fvd_tpu_torch.providers.asr import EnergyVAD

    return Providers(
        asr=EnergyVAD(device=device),
        face_detector=SyntheticFaceDetector(),
        landmarks=SyntheticLandmarks(fps=fps, gate_hz=gate_hz),
    )
