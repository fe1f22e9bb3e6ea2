"""Minimal WAV I/O on the stdlib ``wave`` module: the port's copy of
``fvd_tpu/utils/wav.py``.

The reference shells out to ffmpeg via MoviePy for all audio I/O
(``a1_demux_audio_extract.py:22-31``).  Here audio DSP runs on the device,
so host I/O is just PCM <-> numpy with no native deps.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 samples in [-1, 1] shaped [n] or
    [n, channels], sample_rate)."""
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        sr = w.getframerate()
        n_frames = w.getnframes()
        raw = w.readframes(n_frames)

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported sample width: {sampwidth}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels)
    return data, sr


def write_wav(path: str, samples: np.ndarray, sr: int) -> None:
    """Write float samples in [-1, 1] as 16-bit PCM."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        n_channels = 1
    else:
        n_channels = samples.shape[1]
    pcm = np.clip(np.round(samples * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(n_channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def to_mono(samples: np.ndarray) -> np.ndarray:
    if samples.ndim == 1:
        return samples
    return samples.mean(axis=1)
