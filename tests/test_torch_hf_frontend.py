"""``fvd_tpu_torch/ops/whisper_frontend.py`` against the JAX package's
``whisper_log_mel`` and transformers' ``WhisperFeatureExtractor``, on the
signals of ``tests/test_whisper_frontend.py`` and a few more.

Tolerances: the mel bank within 1e-7 of the extractor's (it is computed the
same way in float64: equal here); the log-mel within 5e-5 of both JAX and
the extractor.  All three compute the STFT in float32 with different FFTs,
and JAX and the extractor themselves differ by up to 3.1e-5 on these signals
(the low-power bins near the max-8 clamp), so no frontend is within 1e-5 of
both; ``tests/test_whisper_frontend.py`` holds JAX to the extractor at
2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from fvd_tpu.ops.whisper_frontend import whisper_log_mel as jax_log_mel  # noqa: E402
from fvd_tpu_torch.ops import whisper_frontend as wf  # noqa: E402

LOG_MEL_TOL = 5e-5


@pytest.fixture(scope="module")
def fe():
    from transformers import WhisperFeatureExtractor

    return WhisperFeatureExtractor()


def _speech(n, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    sig = 0.3 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 3 * t) > 0)
    return (sig + 0.01 * rng.randn(n)).astype(np.float32)


def _signals():
    window = np.zeros(480000, np.float32)
    window[30000:30000 + 64000] = _speech(64000)
    return {"speech_in_window": window, "short": _speech(48000, seed=3), "long": _speech(600000, seed=4),
            "noise": (np.random.RandomState(1).randn(48000) * 0.1).astype(np.float32),
            "silence": np.zeros(16000, np.float32)}


@pytest.mark.parametrize("geometry", [{}, {"feature_size": 128}, {"feature_size": 40, "n_fft": 512}])
def test_mel_bank_is_the_extractor_s(geometry):
    from transformers import WhisperFeatureExtractor

    ref = WhisperFeatureExtractor(**geometry)
    got = wf.mel_filter_bank(ref.n_fft // 2 + 1, ref.feature_size, 0.0, 8000.0, ref.sampling_rate)
    assert got.dtype == np.float64 and got.shape == ref.mel_filters.shape
    np.testing.assert_allclose(got, ref.mel_filters, rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", sorted(_signals()))
def test_log_mel_matches_jax_and_the_extractor(fe, name):
    audio = _signals()[name]
    bank = np.ascontiguousarray(fe.mel_filters, np.float32)
    out = wf.whisper_log_mel(torch.from_numpy(audio), torch.from_numpy(bank)).numpy()
    assert out.shape == (80, 3000) and out.dtype == np.float32
    ref_jax = np.asarray(jax_log_mel(jnp.asarray(audio), jnp.asarray(bank)))
    ref_fe = fe(audio, sampling_rate=16000, return_tensors="np").input_features[0]
    np.testing.assert_allclose(out, ref_jax, rtol=0, atol=LOG_MEL_TOL)
    np.testing.assert_allclose(out, ref_fe, rtol=0, atol=LOG_MEL_TOL)


def test_log_mel_at_another_geometry_matches_the_extractor():
    """A 128-mel, 20 s extractor (the providers pass the checkpoint's
    ``preprocessor_config.json`` through)."""
    from transformers import WhisperFeatureExtractor

    ref = WhisperFeatureExtractor(feature_size=128, chunk_length=20)
    audio = _speech(200000, seed=5)
    bank = torch.from_numpy(ref.mel_filters.astype(np.float32))
    out = wf.whisper_log_mel(torch.from_numpy(audio), bank, n_samples=ref.n_samples).numpy()
    assert out.shape == (128, 2000)
    np.testing.assert_allclose(out, ref(audio, sampling_rate=16000, return_tensors="np").input_features[0],
                               rtol=0, atol=LOG_MEL_TOL)


def test_stft_power_frames_matches_numpy():
    """The framing: reflect padding, hop, periodic hann, |rfft|^2 (float64
    numpy, 1e-4 relative)."""
    audio = _speech(4000, seed=6)
    got = wf.stft_power_frames(torch.from_numpy(audio), 26).numpy()
    x = np.pad(audio.astype(np.float64), (200, 200), mode="reflect")
    frames = np.stack([x[i * 160:i * 160 + 400] for i in range(26)]) * wf.hann_window().astype(np.float64)
    ref = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * ref.max())
