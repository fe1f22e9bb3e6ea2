"""Whisper's log-mel frontend on the device: the counterpart of
``fvd_tpu/ops/whisper_frontend.py``, and of the ``mel_filters`` matrix of
transformers' ``WhisperFeatureExtractor`` that the JAX provider passes in.

:func:`whisper_log_mel` is the extractor's ``__call__`` on one 16 kHz clip:
the audio cut or zero-padded to the 30 s window, a hann-windowed 400/160
STFT with reflect ``center`` padding, the power spectrum with the last frame
dropped, the slaney mel bank, ``log10`` clamped at 1e-10 and at the global
max minus 8, and ``(x + 4) / 4``.  The geometry (rate, ``n_fft``, hop, mel
count, window length) comes from ``preprocessor_config.json``; the defaults
are Whisper's.  :func:`mel_filter_bank` is transformers'
``audio_utils.mel_filter_bank`` with slaney scale and norm, in float64
numpy, as the extractor builds it.

:func:`phrase_power_mel`, :func:`compose_canvas` and
:func:`compose_canvas_batch` serve ``tools/pretrain_hf_whisper.py``: each
training sample is a 30 s canvas assembled on the device from a pool of
phrase power-mels, so the host ships only integer indices and offsets.  A
tile's row 0 is the frame one hop before its content, the canvas has a
one-frame lead margin and room for a tile placed at the last frame
(``1 + N_FRAMES + F`` rows), a ``-1`` slot adds nothing, offsets are
clipped to ``[0, N_FRAMES]``, and each canvas gets ``finish_log_mel``'s
clamp at its own max minus 8.  The batch is one scatter-add of every slot's
tile into ``[B, 1 + N_FRAMES + F, n_mels]``, where the JAX package loops
over the slots with ``dynamic_update_slice``: tiles placed at least
``F / 2`` frames apart overlap two at a time at most, and a sum of two
terms onto zero is exact in either order, so the canvases are the same.
"""

from __future__ import annotations

import numpy as np
import torch

SR = 16000
N_FFT = 400
HOP = 160
N_FRAMES = 3000          # whisper's fixed 30 s window (1500 encoder positions)
WINDOW_SAMPLES = N_FRAMES * HOP
TILE_FRAMES_DEFAULT = 104  # phrase tile: <=0.95 s content + boundary frames


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, np.float64)
    mels = 3.0 * freq / 200.0
    log_region = freq >= 1000.0
    return np.where(log_region, 15.0 + np.log(np.maximum(freq, 1e-300) / 1000.0) * (27.0 / np.log(6.4)), mels)


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, np.float64)
    freq = 200.0 * mels / 3.0
    return np.where(mels >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (mels - 15.0)), freq)


def mel_filter_bank(num_frequency_bins: int = N_FFT // 2 + 1, num_mel_filters: int = 80,
                    min_frequency: float = 0.0, max_frequency: float = 8000.0,
                    sampling_rate: int = SR) -> np.ndarray:
    """[num_frequency_bins, num_mel_filters] float64 triangular filters on
    the slaney mel scale, each divided by its band's width in Hz (slaney
    norm): the extractor's ``mel_filters``."""
    mel_freqs = np.linspace(_hz_to_mel_slaney(min_frequency), _hz_to_mel_slaney(max_frequency),
                            num_mel_filters + 2)
    filter_freqs = _mel_to_hz_slaney(mel_freqs)
    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)
    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / filter_diff[:-1]
    up = slopes[:, 2:] / filter_diff[1:]
    filters = np.maximum(np.zeros(1), np.minimum(down, up))
    enorm = 2.0 / (filter_freqs[2:num_mel_filters + 2] - filter_freqs[:num_mel_filters])
    return filters * enorm[None, :]


def hann_window(n_fft: int = N_FFT) -> np.ndarray:
    """The extractor's periodic hann (numpy's symmetric hann of ``n_fft + 1``
    with the last sample dropped)."""
    return np.hanning(n_fft + 1)[:n_fft].astype(np.float32)


def stft_power_frames(audio: torch.Tensor, n_frames: int, n_fft: int = N_FFT,
                      hop: int = HOP) -> torch.Tensor:
    """[n] audio -> [n_frames, n_fft // 2 + 1] power spectrum: reflect-pad
    ``n_fft // 2`` on both sides (center=True), hann frames every ``hop``
    samples, ``|rfft|^2``."""
    pad = n_fft // 2
    x = torch.nn.functional.pad(audio[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = x.unfold(0, n_fft, hop)[:n_frames]
    window = torch.from_numpy(hann_window(n_fft)).to(audio.device)
    return torch.fft.rfft(frames * window, n=n_fft, dim=-1).abs() ** 2


def finish_log_mel(power_mel: torch.Tensor) -> torch.Tensor:
    """[T, n_mels] power-mel -> whisper-scaled log-mel [n_mels, T]."""
    logspec = torch.log10(torch.clamp(power_mel, min=1e-10))
    logspec = torch.maximum(logspec, logspec.max() - 8.0)
    return ((logspec + 4.0) / 4.0).T


def whisper_log_mel(audio: torch.Tensor, mel_filters: torch.Tensor, n_samples: int = WINDOW_SAMPLES,
                    n_fft: int = N_FFT, hop: int = HOP) -> torch.Tensor:
    """One window's features: [n] float32 audio on the device + the
    [n_fft // 2 + 1, n_mels] float32 filter bank -> [n_mels, n_samples //
    hop] ``input_features``."""
    audio = audio[:n_samples]
    audio = torch.nn.functional.pad(audio, (0, n_samples - audio.shape[0]))
    n_frames = n_samples // hop
    power = stft_power_frames(audio, n_frames + 1, n_fft, hop)[:-1]   # the extractor drops the last
    return finish_log_mel(power @ mel_filters)


def phrase_power_mel(audio: torch.Tensor, mel_filters: torch.Tensor,
                     out_frames: int = TILE_FRAMES_DEFAULT) -> torch.Tensor:
    """Power-mel tiles of pre-rendered phrases, zero-context framing:
    [..., n] audio + [201, n_mels] bank -> [..., out_frames, n_mels].  Tile
    frame ``f`` covers content samples ``[(f - 1) * HOP - 200, (f - 1) *
    HOP + 200)``: the frames a phrase placed at a hop-aligned offset of a
    silent window produces there, one hop of lead included."""
    n = audio.shape[-1]
    length = out_frames * HOP + N_FFT
    if n > length:
        raise ValueError(f"a phrase of {n} samples does not fit a tile of {out_frames} frames")
    start = min(N_FFT // 2 + HOP, length - n)   # where jax's dynamic_update_slice puts it
    buf = torch.zeros(*audio.shape[:-1], length, dtype=torch.float32, device=audio.device)
    buf[..., start:start + n] = audio.to(torch.float32)
    frames = buf.unfold(-1, N_FFT, HOP)[..., :out_frames, :]
    window = torch.from_numpy(hann_window()).to(audio.device)
    return (torch.fft.rfft(frames * window, n=N_FFT, dim=-1).abs() ** 2) @ mel_filters


def compose_canvas_batch(pool: torch.Tensor, phrase_idx: torch.Tensor, frame_offsets: torch.Tensor) -> torch.Tensor:
    """Assemble 30 s log-mel canvases from pooled phrase power-mels.

    pool          [M, F, n_mels] phrase power-mels (F frames per tile)
    phrase_idx    [B, K] int     pool rows; -1 = unused slot
    frame_offsets [B, K] int     placement frame of each phrase

    -> [B, n_mels, N_FRAMES] whisper-scaled log-mel, each canvas clamped at
    its own max minus 8."""
    b, k = phrase_idx.shape
    _, f, c = pool.shape
    rows = 1 + N_FRAMES + f
    tiles = pool[phrase_idx.clamp(min=0)]                                   # [B, K, F, C]
    tiles = torch.where((phrase_idx >= 0)[..., None, None], tiles, torch.zeros((), dtype=pool.dtype,
                                                                                device=pool.device))
    at = frame_offsets.clamp(0, N_FRAMES)[..., None] + torch.arange(f, device=pool.device)   # [B, K, F]
    at = at + (torch.arange(b, device=pool.device) * rows)[:, None, None]
    canvas = torch.zeros(b * rows, c, dtype=pool.dtype, device=pool.device)
    canvas.index_add_(0, at.reshape(-1), tiles.reshape(-1, c))
    power = canvas.view(b, rows, c)[:, 1:1 + N_FRAMES]
    logspec = torch.log10(torch.clamp(power, min=1e-10))
    logspec = torch.maximum(logspec, logspec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((logspec + 4.0) / 4.0).transpose(1, 2)


def compose_canvas(pool: torch.Tensor, phrase_idx: torch.Tensor, frame_offsets: torch.Tensor) -> torch.Tensor:
    """One canvas of :func:`compose_canvas_batch`: [K] slots -> [n_mels, N_FRAMES]."""
    return compose_canvas_batch(pool, phrase_idx[None], frame_offsets[None])[0]
