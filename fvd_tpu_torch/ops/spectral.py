"""Spectral ops: the counterpart of ``fvd_tpu/ops/spectral.py``.

Framing, the Hann-window power STFT (``torch.fft.rfft``), the slaney mel
filterbank, the spectral-flux onset envelope, peak picking, the RMS envelope
and its interpolation onto the video's frame grid: everything A3 computes.
Every tensor op runs on its input's device and takes leading batch
dimensions, so one call serves a coalesced group of videos.

Peak picking's last step (a peak must come more than ``wait`` frames after
the previous accepted one) is sequential; the JAX package runs it as a
``lax.scan`` on the device.  Here the candidates are fetched with the
envelope in one copy and the scan is a host loop over the frames
(:func:`apply_wait`), with the same result.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Framing / STFT
# ---------------------------------------------------------------------------
def frame_signal(x: torch.Tensor, frame_length: int, hop: int, center: bool = True) -> torch.Tensor:
    """[..., n] -> [..., num_frames, frame_length]; zero-pads like librosa center mode."""
    if center:
        x = F.pad(x, (frame_length // 2, frame_length // 2))
    n = x.shape[-1]
    num_frames = max(1 + (n - frame_length) // hop, 1)
    idx = (torch.arange(num_frames, device=x.device)[:, None] * hop
           + torch.arange(frame_length, device=x.device)[None, :])
    return x[..., idx]


def stft_power(x: torch.Tensor, n_fft: int = 2048, hop: int = 512) -> torch.Tensor:
    """Power spectrogram |STFT|^2 -> [..., frames, n_fft//2+1] (Hann window)."""
    frames = frame_signal(x, n_fft, hop, center=True)
    window = torch.from_numpy(np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(x.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    return (spec.real ** 2 + spec.imag ** 2).to(torch.float32)


# ---------------------------------------------------------------------------
# Mel filterbank (HTK-free slaney-style triangles, as librosa defaults)
# ---------------------------------------------------------------------------
def _hz_to_mel(f):
    # Slaney scale: linear below 1 kHz, log above.
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3)
    log_region = f >= 1000.0
    mel = np.where(
        log_region,
        15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / (np.log(6.4) / 27.0),
        mel,
    )
    return mel


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3)
    log_region = m >= 15.0
    f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
    return f


@lru_cache(maxsize=16)
def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128, fmax: float | None = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular filters, slaney-normalized."""
    fmax = fmax or sr / 2
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        # slaney normalization: constant energy per band
        fb[i] *= 2.0 / (hi - lo)
    return fb.astype(np.float32)


def mel_spectrogram(x: torch.Tensor, sr: int, n_fft: int = 2048, hop: int = 512,
                    n_mels: int = 128) -> torch.Tensor:
    power = stft_power(x, n_fft, hop)  # [..., T, F]
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(x.device)
    return power @ fb.T  # [..., T, n_mels]


def power_to_db(S: torch.Tensor, top_db: float = 80.0) -> torch.Tensor:
    """dB against each signal's own maximum over its [T, n_mels] spectrogram."""
    ref = torch.clamp(S.amax(dim=(-2, -1), keepdim=True), min=1e-10)
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=1e-10) / ref)
    return torch.clamp(log_spec, min=-top_db)


# ---------------------------------------------------------------------------
# Onset strength + peak picking
# ---------------------------------------------------------------------------
def onset_strength(x: torch.Tensor, sr: int, n_fft: int = 2048, hop: int = 512,
                   n_mels: int = 128) -> torch.Tensor:
    """Spectral-flux onset envelope: half-wave-rectified frame-to-frame
    increase of the dB mel spectrogram, averaged over bands."""
    S = power_to_db(mel_spectrogram(x, sr, n_fft, hop, n_mels))  # [..., T, n_mels]
    diff = S[..., 1:, :] - S[..., :-1, :]
    flux = torch.mean(torch.clamp(diff, min=0.0), dim=-1)
    # prepend a zero so envelope index t refers to frame t (librosa shifts
    # by the same one-frame lag)
    return F.pad(flux, (1, 0))


def _window_max(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    return F.pad(x, (before, after), value=-float("inf")).unfold(-1, before + after + 1, 1).amax(-1)


def _window_mean(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    size = before + after + 1
    s = F.pad(x, (before, after)).unfold(-1, size, 1).sum(-1)
    cnt = F.pad(torch.ones_like(x), (before, after)).unfold(-1, size, 1).sum(-1)
    return s / cnt


def peak_candidates(env: torch.Tensor, pre_max: int, post_max: int, pre_avg: int, post_avg: int,
                    delta: float) -> torch.Tensor:
    """Frames that are the max of their local max-window and at least
    ``delta`` above their local mean: librosa.util.peak_pick before its
    ``wait`` rule."""
    is_max = env >= _window_max(env, pre_max, post_max) - 1e-12
    above_mean = env >= _window_mean(env, pre_avg, post_avg) + delta
    return torch.logical_and(is_max, above_mean)


def apply_wait(candidates: np.ndarray, wait: int) -> np.ndarray:
    """Keep a candidate only if more than ``wait`` frames passed since the
    previous kept one (the sequential step of peak picking) over the last
    axis of a host boolean array."""
    cand = np.asarray(candidates, bool)
    mask = np.zeros_like(cand)
    age = np.full(cand.shape[:-1], wait + 1, np.int64)
    for t in range(cand.shape[-1]):
        take = cand[..., t] & (age > wait)
        mask[..., t] = take
        age = np.where(take, 0, age + 1)
    return mask


def peak_pick_mask(env: torch.Tensor, pre_max: int, post_max: int, pre_avg: int, post_avg: int,
                   delta: float, wait: int) -> np.ndarray:
    """Vectorized equivalent of librosa.util.peak_pick -> host boolean mask."""
    cand = peak_candidates(env, pre_max, post_max, pre_avg, post_avg, delta)
    return apply_wait(cand.cpu().numpy(), wait)


def detect_onsets(
    x: torch.Tensor,
    sr: int,
    n_fft: int = 2048,
    hop: int = 512,
    n_mels: int = 128,
    pre_max_s: float = 0.03,
    post_max_s: float = 0.0,
    pre_avg_s: float = 0.10,
    post_avg_s: float = 0.10,
    wait_s: float = 0.03,
    delta: float = 0.07,
) -> np.ndarray:
    """Onset times in seconds (the ``librosa.onset.onset_detect`` +
    ``frames_to_time`` analog, reference a3:25-27)."""
    env = onset_strength(x, sr, n_fft, hop, n_mels)
    # normalize envelope to [0, 1] so delta is scale-free
    env = env / torch.clamp(torch.max(env), min=1e-10)
    frames_per_s = sr / hop
    to_frames = lambda s: max(int(round(s * frames_per_s)), 1)  # noqa: E731
    mask = peak_pick_mask(
        env,
        pre_max=to_frames(pre_max_s),
        post_max=max(int(round(post_max_s * frames_per_s)), 0) + 1,
        pre_avg=to_frames(pre_avg_s),
        post_avg=to_frames(post_avg_s) + 1,
        delta=delta,
        wait=to_frames(wait_s),
    )
    frames = np.nonzero(mask)[0]
    return frames * hop / sr


# ---------------------------------------------------------------------------
# RMS envelope (reference a3:39-49)
# ---------------------------------------------------------------------------
def rms_envelope(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    frames = frame_signal(x, frame_length, hop, center=True)
    return torch.sqrt(torch.mean(frames ** 2, dim=-1))


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for increasing ``xp``: linear between the
    points, ``fp[0]`` left of ``xp[0]`` and ``fp[-1]`` right of ``xp[-1]``;
    ``fp`` may carry leading batch dimensions."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[..., i] - fp[..., i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = torch.finfo(xp.dtype).eps
    dx0 = dx.abs() <= eps * eps  # np.spacing(eps), as jnp.interp guards dx
    f = torch.where(dx0, fp[..., i - 1],
                    fp[..., i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


def interp_to_length(y: torch.Tensor, target_len: int) -> torch.Tensor:
    """``np.interp(linspace(0,1,target), linspace(0,1,len(y)), y)`` over the
    last axis."""
    xq = torch.linspace(0.0, 1.0, target_len, device=y.device, dtype=y.dtype)
    xp = torch.linspace(0.0, 1.0, y.shape[-1], device=y.device, dtype=y.dtype)
    return interp(xq, xp, y)


def audio_frontend_program(
    x: torch.Tensor,
    sr: int,
    n_fft: int,
    hop: int,
    n_mels: int,
    pre_max: int,
    post_max: int,
    pre_avg: int,
    post_avg: int,
    wait: int,
    delta: float,
    env_frame: int,
    env_hop: int,
    env_target: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """The whole A3 front-end for ``x [..., n]`` on its device: onset peak
    mask and the fps-aligned RMS envelope, fetched to the host together in
    one copy -> (bool [..., F], float32 [..., T]) numpy arrays.  Over
    same-length signals ``[B, n]`` it is the JAX package's
    ``audio_frontend_program_batch``: one device pass and one fetch for a
    coalesced group of videos."""
    env_strength = onset_strength(x, sr, n_fft, hop, n_mels)
    env_strength = env_strength / torch.clamp(env_strength.amax(-1, keepdim=True), min=1e-10)
    cand = peak_candidates(env_strength, pre_max, post_max, pre_avg, post_avg, delta)
    rms = rms_envelope(x, frame_length=env_frame, hop=env_hop)
    if env_target > 0 and rms.shape[-1] != env_target:
        rms = interp_to_length(rms, env_target)
    n_frames = cand.shape[-1]
    host = torch.cat([cand.to(rms.dtype), rms], dim=-1).cpu().numpy()  # one fetch
    return apply_wait(host[..., :n_frames] > 0, wait), host[..., n_frames:]


def fps_aligned_envelope(x: torch.Tensor, sr: int, fps: float, duration: float | None) -> torch.Tensor:
    """RMS envelope sampled at video fps, interpolated to duration*fps
    samples — the exact A3 recipe (a3:39-49: hop=int(sr/fps),
    frame_length=2*hop, center=True)."""
    hop = int(sr / fps)
    rms = rms_envelope(x, frame_length=2 * hop, hop=hop)
    if duration:
        target = int(duration * fps)
        if rms.shape[-1] != target:
            rms = interp_to_length(rms, target)
    return rms
