"""The ASR and text-encoder trainers' data and tools against the JAX
package's on the CPU: ``formant_speech_hard``; ``asr_batch`` for each domain
(texts and tokens equal, the log-mel within ``MEL_TOL``, the RNG state after
the batch equal); the text tool's ``make_batch`` (ids and RNG state equal);
and a 2-step ``--cpu`` run of each port tool, whose npz and sidecar the JAX
package's providers load (``load_params`` on its own template) and whose
outputs from the JAX package's model match the port's provider's within
``OUT_TOL``.  The JAX tools are loaded from ``tools/`` by path."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fvd_tpu.models import asr as jasr  # noqa: E402
from fvd_tpu.models import encoders as jenc  # noqa: E402
from fvd_tpu.models import synthetic_speech as jspeech  # noqa: E402
from fvd_tpu.models.transformer import ByteTokenizer as JaxTokenizer  # noqa: E402
from fvd_tpu_torch.models import asr, encoders  # noqa: E402
from fvd_tpu_torch.models import synthetic_speech as tspeech  # noqa: E402
from fvd_tpu_torch.models.transformer import ByteTokenizer  # noqa: E402
from fvd_tpu_torch.tools import pretrain_asr, pretrain_text_encoder  # noqa: E402
from test_torch_train_losses import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the log-mel, float32 on both sides, FFTs summed in another order: the
#: tone domain's pure sines leave bins 7-8 decades under the frame's peak,
#: where that rounding is largest relative to the power (measured up to
#: 3.2e-5 over seeds 0-3; ``tests/test_torch_asr.py`` holds the same
#: frontend to 1e-4); the formant domains stay within 2e-6
MEL_TOL = {"tone": 1e-4, "formant": 1e-5, "formant_hard": 1e-5}
OUT_TOL = 1e-5


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tools():
    return {"asr": _jax_tool("pretrain_asr"), "text": _jax_tool("pretrain_text_encoder")}


def _same_state(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a.get_state(), b.get_state()))


@pytest.mark.parametrize("text", ["the moon landing", "bapsz kit vu", "ao", ""])
@pytest.mark.parametrize("variability", [1.0, 0.4, 0.0])
def test_formant_speech_hard_matches_jax(text, variability):
    for seed in range(3):
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        got = tspeech.formant_speech_hard(text, r1, variability=variability)
        want = jspeech.formant_speech_hard(text, r2, variability=variability)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert _same_state(r1, r2)
    assert (tspeech.SR, tspeech.PHONE_S, tspeech.ALPHABET) == (jspeech.SR, jspeech.PHONE_S, jspeech.ALPHABET)
    np.testing.assert_array_equal(tspeech.formant_speech(text, np.random.RandomState(0)),
                                  jspeech.formant_speech(text, np.random.RandomState(0)))


@pytest.mark.parametrize("domain", ["tone", "formant", "formant_hard"])
def test_asr_batch_matches_jax(jax_tools, domain):
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    got = pretrain_asr.asr_batch(r1, 6, ByteTokenizer(), 128, 16, pretrain_asr.Domain(domain, 0.002))
    want = jax_tools["asr"].asr_batch(r2, 6, JaxTokenizer(), 128, 16, jax_tools["asr"].Domain(domain, 0.002))
    assert got[3] == want[3]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert tuple(got[0].shape) == want[0].shape == (6, 128, asr.N_MELS)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=MEL_TOL[domain], rtol=0)
    np.testing.assert_array_equal(got[0].numpy() == 0, want[0] == 0)  # the same rows zeroed
    assert _same_state(r1, r2)
    assert pretrain_asr.Domain(domain, 0.002).dither == jax_tools["asr"].Domain(domain, 0.002).dither


def test_utterance_generators_match_jax(jax_tools):
    j = jax_tools["asr"]
    for name in ("random_letters", "random_pronounceable", "random_common_words"):
        r1, r2 = np.random.RandomState(1), np.random.RandomState(1)
        assert [getattr(pretrain_asr, name)(r1) for _ in range(20)] == [getattr(j, name)(r2) for _ in range(20)]
        assert _same_state(r1, r2)


def test_text_make_batch_matches_jax(jax_tools):
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(2):
        got = pretrain_text_encoder.make_batch(r1, 24, ByteTokenizer(), encoders.MAX_TEXT_LEN)
        want = jax_tools["text"].make_batch(r2, 24, JaxTokenizer(), jenc.MAX_TEXT_LEN)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert _same_state(r1, r2)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("zoo_ckpt")
    asr_npz, text_npz = str(out / "asr_formant.npz"), str(out / "text_encoder.npz")
    summaries = {
        "asr": pretrain_asr.main(["--steps", "2", "--batch", "2", "--dim", "32", "--depth", "1", "--domain",
                                  "formant_hard", "--cpu", "--out", asr_npz]),
        "resumed": pretrain_asr.main(["--steps", "1", "--batch", "2", "--dim", "32", "--depth", "1", "--domain",
                                      "formant_hard", "--cpu", "--out", asr_npz, "--resume"]),
        "text": pretrain_text_encoder.main(["--steps", "2", "--batch", "4", "--dim", "32", "--depth", "1",
                                            "--out-dim", "16", "--cpu", "--out", text_npz]),
    }
    return asr_npz, text_npz, summaries


def test_tool_summaries_and_sidecars(trained, capsys):
    asr_npz, text_npz, s = trained
    for name in ("asr", "text"):
        assert s[name]["steps"] == 2 and np.isfinite([s[name]["loss_first"], s[name]["loss_last"],
                                                       s[name]["data_ms"], s[name]["step_ms"]]).all()
    assert 0.0 <= s["asr"]["eval_exact"] <= 1.0 and 0.0 <= s["asr"]["eval_char_acc"] <= 1.0
    assert "utterances_per_s" in s["asr"] and "pairs_per_s" in s["text"]
    assert s["resumed"]["steps"] == 1
    with open(asr_npz.replace(".npz", ".json")) as f:
        assert json.load(f) == {"dim": 32, "depth": 1, "chunk_frames": 128, "max_tokens": 16, "domain": "formant",
                                "train_domain": "formant_hard", "dither": 0.002}
    with open(text_npz.replace(".npz", ".json")) as f:
        meta = json.load(f)
    assert {k: meta[k] for k in ("dim", "depth", "out_dim")} == {"dim": 32, "depth": 1, "out_dim": 16}
    assert meta["eval_retrieval_at_1"] == s["text"]["eval_retrieval_at_1"]


def test_asr_npz_loads_in_both_packages_and_gives_the_same_logits(trained, monkeypatch):
    """The JAX package's ``from_checkpoint`` fills its own template (its
    ``init_params`` traced by ``jax.eval_shape``: an eager init at 1 024
    frames takes 20 s here) with ``load_params``."""
    init = jasr.init_params
    monkeypatch.setattr(jasr, "init_params", lambda rng, dim, depth: jax.eval_shape(lambda r: init(r, dim, depth), rng))
    asr_npz = trained[0]
    j = jasr.JaxASR.from_checkpoint(asr_npz)
    t = asr.JaxASR.from_checkpoint(asr_npz, device="cpu")
    assert (t.dim, t.depth, t.chunk_frames, t.max_tokens, t.dither) == \
        (j.dim, j.depth, j.chunk_frames, j.max_tokens, j.dither) == (32, 1, 128, 16, 0.002)
    rng = np.random.RandomState(0)
    mel = rng.randn(2, 40, asr.N_MELS).astype(np.float32)
    tokens = rng.randint(3, 259, (2, 16)).astype(np.int32)
    want = np.asarray(jasr.AsrModel(dim=32, depth=1).apply(j.params, jnp.asarray(mel), jnp.asarray(tokens)))
    with torch.no_grad():
        got = t.model(torch.from_numpy(mel), torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=0)


def test_text_npz_loads_in_both_packages_and_ranks_the_same(trained):
    text_npz = trained[1]
    j = jenc.JaxTextEncoder(checkpoint=text_npz, dim=32, depth=1, out_dim=16)
    t = encoders.JaxTextEncoder(checkpoint=text_npz, dim=32, depth=1, out_dim=16, device="cpu")
    texts = ["the moon landing happened in 1969", "Fact check: the moon landing was real",
             "water boils at 100 degrees", ""]
    np.testing.assert_allclose(t.encode_batch(texts), np.asarray(j.encode_batch(texts)), atol=OUT_TOL, rtol=0)
