"""The port's Whisper (``fvd_tpu_torch/providers/hf_models.py`` on
``models/hf_whisper.py``) against the JAX package's
(``fvd_tpu/providers/hf_models.py`` on transformers' Flax classes), on the
CPU, float32 on both sides, on small random configs and on the shipped
checkpoints of ``checkpoints/hf``.

The JAX providers get their Flax models from ``from_pretrained(...,
_do_init=False)``: the same float16 parameters as ``from_local``'s
``from_pretrained`` without its random init, which takes 16-40 s per model
on this CPU.  Tolerances: teacher-forced logits 1e-4; log-mel 5e-5 (see
``tests/test_torch_hf_frontend.py``); tokens and transcripts equal on
formant speech (the checkpoint's own domain, word accuracy 1.0 there)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from fvd_tpu.models.synthetic_speech import formant_speech  # noqa: E402
from fvd_tpu.providers import hf_models as jhf  # noqa: E402
from fvd_tpu_torch.models.hf_whisper import WhisperForConditionalGeneration, greedy_generate  # noqa: E402
from fvd_tpu_torch.providers import hf_models as thf  # noqa: E402
from test_torch_hf_models import _flax, _port  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HF = os.path.join(ROOT, "checkpoints", "hf")
LOGIT_TOL = 1e-4


def test_whisper_on_a_small_random_config():
    """Teacher-forced logits, and the cached greedy decode's own logits
    against them; tokens equal up to the first step whose top-2 margin is
    under 1e-3 (random weights have near-ties)."""
    from transformers import FlaxWhisperForConditionalGeneration, WhisperConfig

    config = WhisperConfig(vocab_size=120, num_mel_bins=80, d_model=32, encoder_layers=2, decoder_layers=2,
                           encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
                           decoder_ffn_dim=64, max_source_positions=150, max_target_positions=64,
                           decoder_start_token_id=1, eos_token_id=2, pad_token_id=0, bos_token_id=3,
                           suppress_tokens=[], begin_suppress_tokens=[], forced_decoder_ids=None)
    flax = FlaxWhisperForConditionalGeneration(config, seed=0)
    port = _port(WhisperForConditionalGeneration, "whisper", flax, config)
    feats = np.random.RandomState(0).randn(2, 80, 300).astype(np.float32)
    ref_ids = np.asarray(flax.generate(jnp.asarray(feats), max_length=40).sequences)
    steps = []
    got_ids = greedy_generate(port, torch.from_numpy(feats), 40, 1, 2, 0, steps).numpy()
    with torch.no_grad():
        logits = port(torch.from_numpy(feats), torch.from_numpy(ref_ids)).numpy()
    ref_logits = np.asarray(flax(input_features=jnp.asarray(feats), decoder_input_ids=jnp.asarray(ref_ids)).logits)
    np.testing.assert_allclose(logits, ref_logits, rtol=0, atol=LOGIT_TOL)
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    for row in range(2):
        clear = np.flatnonzero(top2[row, :, 1] - top2[row, :, 0] < 1e-3)
        n = clear[0] + 1 if len(clear) else ref_ids.shape[1]
        np.testing.assert_array_equal(got_ids[row, :n], ref_ids[row, :n])
        if n == ref_ids.shape[1]:
            step = np.stack([s[row].numpy() for s in steps])
            np.testing.assert_allclose(step, ref_logits[row, :len(step)], rtol=0, atol=LOGIT_TOL)


@pytest.fixture(scope="module")
def whisper():
    from transformers import FlaxWhisperForConditionalGeneration, WhisperProcessor

    path = os.path.join(HF, "whisper")
    ref = jhf.HFWhisperASR(_flax(FlaxWhisperForConditionalGeneration, path),
                           processor=WhisperProcessor.from_pretrained(path))
    return ref, thf.HFWhisperASR.from_local(path, device="cpu")


def _formant(text, seed, lead=0.5, tail=0.5):
    a = formant_speech(text, np.random.RandomState(seed)).astype(np.float32)
    return np.concatenate([np.zeros(int(lead * 16000), np.float32), a, np.zeros(int(tail * 16000), np.float32)])


def test_whisper_tokens_logits_and_text_on_formant_speech(whisper):
    ref, port = whisper
    audio = _formant("the river rose two feet", 0)
    feats = np.asarray(ref._features(audio, 16000))
    np.testing.assert_allclose(port._features(torch.from_numpy(audio), 16000).numpy(), feats, rtol=0, atol=5e-5)
    ref_ids = ref._generate(feats)
    got_ids = port._generate(torch.from_numpy(feats.copy()))
    np.testing.assert_array_equal(got_ids, ref_ids)
    n = int((ref_ids[0] != 0).sum()) + 1
    with torch.no_grad():
        logits = port.model(torch.from_numpy(feats.copy()), torch.from_numpy(ref_ids[:, :n])).numpy()
    forced = jax.jit(lambda p, f, ids: ref.model.module.apply(
        {"params": p}, f, decoder_input_ids=ids, decoder_attention_mask=jnp.ones_like(ids),
        decoder_position_ids=jnp.arange(ids.shape[1])[None]).logits)
    ref_logits = np.asarray(forced(ref.model.params, jnp.asarray(feats), jnp.asarray(ref_ids[:, :n])))
    np.testing.assert_allclose(logits, ref_logits, rtol=0, atol=LOGIT_TOL)
    out = port.transcribe("", audio=audio)
    assert out == ref.transcribe("", audio=audio)
    assert out["text"] == "the river rose two feet"


def test_whisper_transcribes_two_windows_like_jax(whisper, tmp_path):
    """A 32 s file: two 30 s windows, the second 2 s long; read from the
    wav as the JAX provider reads it."""
    from fvd_tpu_torch.utils.wav import write_wav

    ref, port = whisper
    first = _formant("the moon landing happened", 2, lead=1.0, tail=0.0)
    second = _formant("water boils", 3, lead=0.2, tail=0.0)
    audio = np.zeros(32 * 16000, np.float32)
    audio[:len(first)] = first
    audio[30 * 16000:30 * 16000 + len(second)] = second
    path = str(tmp_path / "a.wav")
    write_wav(path, audio, 16000)
    out = port.transcribe(path)
    assert out == ref.transcribe(path)
    assert [(s["start"], s["end"]) for s in out["segments"]] == [(0.0, 30.0), (30.0, 32.0)]
    assert out["text"] == " ".join(s["text"] for s in out["segments"])
    assert port.transcribe(str(tmp_path / "missing.wav")) is None


def test_whisper_refuses_another_rate_as_the_extractor_does(whisper):
    ref, port = whisper
    audio = np.zeros(8000, np.float32)
    with pytest.raises(ValueError) as want:
        ref._features(audio, 8000)
    with pytest.raises(ValueError) as got:
        port._features(torch.from_numpy(audio), 8000)
    assert str(got.value) == str(want.value)


def test_whisper_refuses_a_logits_processor_it_does_not_port(whisper):
    _, port = whisper
    with pytest.raises(NotImplementedError, match="suppress_tokens"):
        thf.HFWhisperASR(port.model, port.tokenizer, port.fe,
                         {"decoder_start_token_id": 1, "eos_token_id": 0, "suppress_tokens": [5]}, device="cpu")


@pytest.mark.parametrize("text,seed", [("the river rose two feet", 0), ("big dogs vex quick zebras jump", 3), ("", 1)])
def test_the_port_s_formant_speech_is_the_jax_package_s(text, seed):
    from fvd_tpu_torch.synthetic import formant_speech as port_formant_speech

    ref = formant_speech(text, np.random.RandomState(seed))
    got = port_formant_speech(text, np.random.RandomState(seed))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_a_formant_clip_carries_the_utterance(tmp_path):
    from fvd_tpu_torch.synthetic import make_face_video
    from fvd_tpu_torch.utils.wav import read_wav

    clip = make_face_video(str(tmp_path), "c", duration=3.0, fps=5.0, sr=16000, speech_text="water boils",
                           speech="formant")
    audio, sr = read_wav(clip[:-4] + ".wav")
    ref = formant_speech("water boils", np.random.RandomState(0))
    assert sr == 16000 and len(audio) == 48000 and not audio[:8000].any()
    np.testing.assert_allclose(audio[8000:8000 + len(ref)], ref, atol=1 / 32767)
    with pytest.raises(ValueError, match="formant"):
        make_face_video(str(tmp_path), "d", duration=1.0, sr=44100, speech_text="x", speech="formant")
