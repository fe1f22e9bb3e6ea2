"""``fvd_tpu_torch/tools/pretrain_hf_whisper.py`` against the JAX package's
``tools/pretrain_hf_whisper.py`` on the CPU, Whisper at d64, 2 + 2 layers
and vocab 600 for the arithmetic (``tests/hf_train_parity.py``):

* the data: the phrases, the rendered audio pool bit for bit, the pool's
  power-mel tiles, and the sampler's slots, offsets, token ids and masks
  (the JAX tool's tokens from ``WhisperProcessor``);
* the loss (canvases composed from the pool, teacher-forced masked NLL over
  256 positions) and its gradient against the JAX tool's on
  ``FlaxWhisperForConditionalGenerationModule`` in float64, three clipped
  AdamW steps end to end, and the frozen encoder positions, which get no
  gradient, decayed as optax decays them;
* the bfloat16 logits within 1.5 x JAX's own bfloat16-against-float32
  distance;
* the tool at 2 steps with ``--tiny``: its files load in
  ``FlaxWhisperForConditionalGeneration`` (equal logits) and in
  ``HFWhisperASR``, ``--resume`` continues, ``--promote`` copies the
  directory, and the meta sidecar has the JAX tool's keys.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import hf_train_parity as hp  # noqa: E402
from fvd_tpu.ops import whisper_frontend as J  # noqa: E402
from fvd_tpu_torch.ops.whisper_frontend import mel_filter_bank  # noqa: E402
from fvd_tpu_torch.tools import pretrain_hf_whisper as pw  # noqa: E402
from fvd_tpu_torch.utils.hf_tokenizers import Tokenizer  # noqa: E402
from test_torch_train_losses import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HF = os.path.join(REPO, "checkpoints", "hf", "whisper")
sys.path.insert(0, os.path.join(REPO, "tools"))
os.environ.setdefault("USE_TF", "0")
import pretrain_hf_whisper as jw  # noqa: E402


@pytest.fixture(scope="module")
def mel():
    return mel_filter_bank().astype(np.float32)


@pytest.fixture(scope="module")
def data():
    """The JAX tool's phrases, held-out phrases and pools at pool 12."""
    rng = np.random.RandomState(0)
    texts = jw.gen_phrases(rng, 12)
    evals = jw.gen_phrases(rng, 6, taken=texts)
    audio = jw.render_pool(texts, rng, noise_max=0.004)
    return texts, evals, audio


def test_phrases_and_pool_match_the_jax_tool(data):
    texts, evals, audio = data
    rng = np.random.RandomState(0)
    assert pw.gen_phrases(rng, 12) == texts
    assert pw.gen_phrases(rng, 6, taken=texts) == evals
    got = pw.render_pool(texts, rng, noise_max=0.004)
    assert got.dtype == audio.dtype and got.shape == audio.shape == (12, pw.TILE_FRAMES * 160)
    np.testing.assert_array_equal(got, audio)
    base = pw.render_pool(evals, np.random.RandomState(1), hard_frac=0.0)
    np.testing.assert_array_equal(base, jw.render_pool(evals, np.random.RandomState(1), hard_frac=0.0))


def test_pool_power_mels_match_the_jax_tool(data, mel):
    _, _, audio = data
    ref = np.asarray(jw.pool_power_mels(audio, mel))
    got = pw.pool_power_mels(audio, torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


def test_sampler_matches_the_jax_tool(data):
    from transformers import WhisperProcessor

    texts, _, _ = data
    tok = WhisperProcessor.from_pretrained(HF).tokenizer
    port_tok = Tokenizer.from_dir(HF)
    for seed in (7, 8):
        ref = jw.sample_batch(np.random.RandomState(seed), 16, len(texts), texts,
                              lambda t: [i for i in tok(t, add_special_tokens=False)["input_ids"] if i > 1])
        got = pw.sample_batch(np.random.RandomState(seed), 16, len(texts), texts,
                              lambda t: [i for i in port_tok.encode_ids(t) if i > 1])
        for r, g in zip(ref[:5], got[:5]):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
        assert got[5] == ref[5]


def _jax_loss(module, p, pool, idx, off, dec_in, labels, mask):
    """``tools/pretrain_hf_whisper.py:236-253`` (compose, cast, the
    teacher-forced NLL); the casts are float64 here, and the canvas is
    composed in float64 (``jnp.float32`` read as float64 while it is
    traced)."""
    feats = jax.vmap(J.compose_canvas, in_axes=(None, 0, 0))(pool, idx, off).astype(jnp.float64)
    pos_ids = jnp.broadcast_to(jnp.arange(pw.SEQ)[None], dec_in.shape)
    logits = module.apply({"params": p}, feats, dec_in, jnp.ones_like(dec_in), pos_ids).logits.astype(jnp.float64)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
    return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1.0)


@pytest.fixture(scope="module")
def setup(data, mel):
    texts, _, audio = data
    cfg = hp.small_config("whisper")
    tok = Tokenizer.from_dir(HF)
    pool = pw.pool_power_mels(audio[:6], torch.from_numpy(mel)).numpy().astype(np.float64)
    rng = np.random.RandomState(7)
    batches = []
    for _ in range(hp.STEPS):
        idx, off, dec_in, labels, mask, _ = pw.sample_batch(rng, 2, 6, texts[:6],
                                                            lambda t: [i for i in tok.encode_ids(t) if 1 < i < 600])
        batches.append((pool, idx.astype(np.int64), off.astype(np.int64), dec_in.astype(np.int64),
                        labels.astype(np.int64), mask.astype(np.float64)))
    return cfg, hp.weights("whisper", cfg), batches


def test_f64_loss_gradient_and_three_steps_match_jax(setup, monkeypatch, one_torch_thread):
    cfg, sd, batches = setup
    monkeypatch.setattr(jnp, "float32", jnp.float64)
    jout, pout = hp.f64_runs("whisper", cfg, sd, _jax_loss, pw.whisper_step_loss, batches)
    monkeypatch.undo()
    hp.check_f64(jout, pout, frozen=("model.encoder.embed_positions.weight",))
    assert jout["losses"][0] > 5


def test_bf16_logits_within_jax_own_distance(setup):
    cfg, sd, batches = setup
    pool, idx, off, dec_in, _, _ = batches[0]
    feats = np.asarray(J.compose_canvas_batch(jnp.asarray(pool, jnp.float32), jnp.asarray(idx, jnp.int32),
                                              jnp.asarray(off, jnp.int32)))
    params = hp.flax_params("whisper", sd, np.float32)
    pos = np.broadcast_to(np.arange(pw.SEQ)[None], dec_in.shape)

    def jax_logits(dtype):
        return np.asarray(hp.flax_module("whisper", cfg, dtype).apply(
            {"params": params}, feats.astype(dtype), dec_in, np.ones_like(dec_in), pos).logits.astype(jnp.float32))

    ref32, ref16 = jax_logits(jnp.float32), jax_logits(jnp.bfloat16)
    model = hp.port_model("whisper", cfg, sd, torch.float32, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        port16 = model(torch.from_numpy(feats).to(torch.bfloat16), torch.from_numpy(dec_in)).float().numpy()
    jax_gap = hp.rel_l2(ref16, ref32)
    assert 0 < hp.rel_l2(port16, ref32) <= 1.5 * jax_gap, (hp.rel_l2(port16, ref32), jax_gap)


def test_tool_writes_files_both_packages_load(tmp_path, one_torch_thread):
    from transformers import FlaxWhisperForConditionalGeneration

    from fvd_tpu_torch.models.hf_whisper import WhisperForConditionalGeneration
    from fvd_tpu_torch.providers.hf_models import HFWhisperASR
    from fvd_tpu_torch.tools import hf_train
    from fvd_tpu_torch.utils.msgpack import read_msgpack

    out, promoted = str(tmp_path / "whisper"), str(tmp_path / "promoted")
    first = pw.main(["--cpu", "--tiny", "--steps", "2", "--batch", "2", "--pool", "8", "--eval-every", "0",
                     "--out", out, "--promote", promoted])
    assert first["steps"] == 2 and np.isfinite([first["loss_first"], first["loss_last"]]).all()
    assert 0.0 <= first["exact"] <= 1.0 and 0.0 <= first["char"] <= 1.0
    with open(os.path.join(out, "fvd_train_meta.json")) as f:
        assert sorted(json.load(f)) == sorted(["domain", "train", "steps", "pool", "geometry"])
    for name in os.listdir(out):
        with open(os.path.join(out, name), "rb") as a, open(os.path.join(promoted, name), "rb") as b:
            assert a.read() == b.read(), name
    asr = HFWhisperASR.from_local(out, device="cpu")
    assert asr.start_id == 1 and asr.eos_id == 0
    assert isinstance(asr.transcribe("", audio=np.zeros(16000, np.float32))["text"], str)

    loaded = FlaxWhisperForConditionalGeneration.from_pretrained(out, _do_init=False)
    flax_model, params = loaded if isinstance(loaded, tuple) else (loaded, loaded.params)
    port = hf_train.load_for_training(WhisperForConditionalGeneration, "whisper", out, "cpu", None)
    feats = np.random.RandomState(0).randn(1, 80, 3000).astype(np.float32)
    ids = np.array([[1, 70, 77, 80]])
    ref = np.asarray(flax_model.module.apply({"params": params}, feats, ids, np.ones_like(ids),
                                             np.arange(4)[None]).logits)
    with torch.no_grad():
        got = port(torch.from_numpy(feats), torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)

    before = read_msgpack(os.path.join(out, "flax_model.msgpack"))
    w0 = np.array(before["model"]["decoder"]["layers"]["0"]["fc1"]["kernel"])
    pos0 = np.array(before["model"]["encoder"]["embed_positions"]["embedding"])
    second = pw.main(["--cpu", "--resume", "--steps", "1", "--batch", "2", "--pool", "8", "--lr", "1e-3",
                      "--warmup", "0", "--eval-every", "0", "--out", out])
    assert second["steps"] == 1
    after = read_msgpack(os.path.join(out, "flax_model.msgpack"))
    w1 = np.array(after["model"]["decoder"]["layers"]["0"]["fc1"]["kernel"])
    assert 0 < np.abs(w1 - w0).max() < 1e-2
    # the frozen positions only decay: by 1 - lr * 0.01 at the one step
    np.testing.assert_allclose(after["model"]["encoder"]["embed_positions"]["embedding"], pos0 * (1 - 1e-5),
                               rtol=1e-6)
