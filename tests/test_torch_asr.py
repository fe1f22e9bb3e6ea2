"""``fvd_tpu_torch/models/asr.py`` against ``fvd_tpu/models/asr.py`` on the
CPU: the flax "SAME" padding of the stride-2 1-D conv, the log-mel frontend,
the energy VAD, and ``JaxASR`` on both shipped checkpoints (``asr.npz``, the
tone domain, and ``asr_formant.npz``, the one the production bundle loads)
with tokens equal to the JAX package's."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvd_tpu.models import asr as jasr
from fvd_tpu_torch import weights
from fvd_tpu_torch.models import asr as tasr
from fvd_tpu_torch.models.layers import SameConv1d
from fvd_tpu_torch.synthetic import gated_speech

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
#: float32 on both sides; only the summation order differs (the log-mel's
#: log10 of powers up to ~1e4 included)
TOL = 1e-4
TEXT = "the mayor said the city will cut taxes next year"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("length,stride", [(128, 2), (127, 2), (16, 1)])
def test_same_conv1d_pads_as_flax(length, stride):
    """Flax "SAME" on a stride-2 conv pads (0, 1) on an even length."""
    x = np.random.RandomState(length).randn(2, length, 8).astype(np.float32)
    conv = fnn.Conv(5, (3,), strides=(stride,), padding="SAME")
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    tconv = SameConv1d(8, 5, 3, stride=stride)
    sd = weights.to_state_dict({"params": {"Conv_0": params["params"]}})
    tconv.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = tconv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_mel_masked_matches_jax():
    rng = np.random.RandomState(0)
    rows = (0.3 * rng.randn(3, 127 * tasr.HOP)).astype(np.float32)
    n_frames = np.array([128, 40, 0], np.int32)
    want = np.asarray(jasr._mel_masked(jnp.asarray(rows), jnp.asarray(n_frames)))
    got = tasr._mel_masked(torch.from_numpy(rows), torch.from_numpy(n_frames)).numpy()
    assert got.shape == (3, 128, tasr.N_MELS)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_active_spans_match_jax():
    audio = gated_speech(TEXT, duration=15.0, gate_hz=1.0)
    assert tasr.active_spans(audio) == jasr.active_spans(audio) != []
    assert tasr.active_spans(np.zeros(16000, np.float32)) == []


@pytest.fixture(scope="module")
def tone_pair():
    path = os.path.join(CKPT, "asr.npz")
    return jasr.JaxASR.from_checkpoint(path), tasr.JaxASR.from_checkpoint(path, device="cpu")


def test_shipped_tone_asr_reads_gated_speech_as_jax(tone_pair):
    """``tests/test_asr_model.py``'s long-form case: the same transcript and
    segments as the JAX package, char accuracy >= 0.8, and real pauses."""
    audio = gated_speech(TEXT, duration=15.0, gate_hz=1.0)
    j, t = tone_pair
    got = t.transcribe("", audio=audio)
    assert got == j.transcribe("", audio=audio)
    ok = sum(a == b for a, b in zip(got["text"], TEXT))
    assert ok / len(TEXT) >= 0.8, got["text"]
    assert sum(s["end"] - s["start"] for s in got["segments"]) < 10.0
    # the dither is drawn anew on every call, and a tensor input reads the same
    assert t.transcribe("", audio=torch.from_numpy(audio)) == got


def test_greedy_decode_tokens_match_jax(tone_pair):
    j, t = tone_pair
    rows = np.stack([gated_speech(w, duration=127 * tasr.HOP / 16000, gate_hz=0.5)
                     for w in ("hello", "deepfake", "fvd tpu", "")]).astype(np.float32)
    rows += 0.01 * np.random.RandomState(0).randn(*rows.shape).astype(np.float32)
    nf = np.array([128, 128, 128, 5], np.int32)
    mel = jasr._mel_masked(jnp.asarray(rows), jnp.asarray(nf))
    want = np.asarray(jasr.greedy_decode(j.params, mel, dim=j.dim, depth=j.depth, max_tokens=j.max_tokens))
    got = tasr.greedy_decode(t.model, torch.from_numpy(np.array(mel)), t.max_tokens).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:3, 1:] > 2).any()  # bytes were read


def test_shipped_formant_asr_matches_jax():
    """The production bundle's ASR (dim 192, depth 4, dither 0.002) on the
    same gated speech: the same tokens as the JAX package."""
    path = os.path.join(CKPT, "asr_formant.npz")
    j, t = jasr.JaxASR.from_checkpoint(path), tasr.JaxASR.from_checkpoint(path, device="cpu")
    assert (t.dim, t.depth, t.chunk_frames, t.max_tokens, t.dither) == (192, 4, 128, 16, 0.002)
    audio = gated_speech(TEXT, duration=15.0, gate_hz=1.0)
    got = t.transcribe("", audio=audio)
    assert got == j.transcribe("", audio=audio) and got["segments"]
    _, rows, nf = t.windows(audio)
    mel = jasr._mel_masked(jnp.asarray(rows), jnp.asarray(nf))
    want = np.asarray(jasr.greedy_decode(j.params, mel, dim=j.dim, depth=j.depth, max_tokens=j.max_tokens))
    np.testing.assert_array_equal(t.decode_windows(rows, nf), want)


def test_transcribe_reads_the_file_without_audio(tmp_path, tone_pair):
    from fvd_tpu_torch.utils.wav import write_wav

    _, t = tone_pair
    audio = gated_speech("hello", duration=3.0, gate_hz=1.0)
    path = str(tmp_path / "a.wav")
    write_wav(path, audio, 16000)
    assert t.transcribe(path)["text"] == t.transcribe("", audio=audio)["text"]
    assert t.transcribe(str(tmp_path / "missing.wav")) is None
