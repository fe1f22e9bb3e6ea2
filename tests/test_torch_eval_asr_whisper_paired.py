"""``fvd_tpu_torch/tools/eval_asr_whisper_paired.py`` against the JAX
package's ``tools/eval_asr_whisper_paired.py`` on the CPU, on a small
Whisper from the port's maker (d_model 64, 2 + 2 layers, vocabulary 600)
read by both tools against the shipped ``asr_formant.npz``, at ``--n 4
--n-sentences 1``.

The maker's own init (``init_std`` 0.02) makes a random decoder repeat its
start token; this checkpoint's init_std of 0.3 gives tokens that move from
step to step, so the comparison pins each step's argmax.  Both tools
generate ``MAX_LENGTH`` = 24 tokens, the start token included (Flax's
``generate(max_length=24)``, the port's ``greedy_generate``); the token
arrays are equal, and so are the JSON files (the dim-192 decodes, the
Whisper decodes and both providers' word accuracies on a 30 s sentence)."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("transformers")

import tools.eval_asr_whisper_paired as J  # noqa: E402
from fvd_tpu_torch.tools import eval_asr_whisper_paired as P  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASR = os.path.join(ROOT, "checkpoints", "asr_formant.npz")
#: the JAX tool's utterance-level ``max_length``
J_MAX_LENGTH = 24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small_whisper(tmp_path_factory):
    from fvd_tpu_torch.models.hf_whisper import WhisperForConditionalGeneration
    from fvd_tpu_torch.tools import make_hf_geometry_checkpoints as makers

    path = str(tmp_path_factory.mktemp("hf") / "whisper")
    cfg = makers.whisper_config(d_model=64, layers=2, heads=2, ffn=128, vocab_size=600)
    cfg["init_std"] = 0.3
    makers._write(path, "whisper", "whisper", cfg, WhisperForConditionalGeneration(cfg), 0, vocab_size=600)
    return path


def _jax_whisper_from_local(mp, tokens):
    """The JAX provider's ``from_local`` without the random init, its
    ``model.generate`` bound to the checkpoint's parameters (the JAX tool
    calls it without them) and recording the utterance level's sequences
    (``max_length`` 24) in ``tokens``."""
    from transformers import FlaxWhisperForConditionalGeneration, WhisperProcessor

    from fvd_tpu.providers import hf_models as jhf

    def from_local(cls, path):
        model, params = FlaxWhisperForConditionalGeneration.from_pretrained(path, _do_init=False)

        def generate(*a, params=params, **k):
            out = model.generate(*a, params=params, **k)
            if k.get("max_length") == J_MAX_LENGTH:
                tokens.append(np.asarray(out.sequences))
            return out

        ns = types.SimpleNamespace(module=model.module, params=params, config=model.config, generate=generate)
        return cls(ns, processor=WhisperProcessor.from_pretrained(path))

    mp.setattr(jhf.HFWhisperASR, "from_local", classmethod(from_local))


def test_eval_asr_whisper_paired_matches_jax(small_whisper, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "path", [os.path.join(ROOT, "tools")] + sys.path)
    tokens = {"port": [], "jax": []}
    _jax_whisper_from_local(monkeypatch, tokens["jax"])
    generate = P.whisper_generate
    monkeypatch.setattr(P, "whisper_generate", lambda hf, audios: tokens["port"].append(generate(hf, audios)) or
                        tokens["port"][-1])
    out = {}
    for side, mod in (("port", P), ("jax", J)):
        out[side] = str(tmp_path / f"{side}.json")
        argv = ["--whisper", small_whisper, "--old", ASR, "--n", "4", "--n-sentences", "1", "--json", out[side]]
        assert mod.main(argv + (["--cpu"] if side == "port" else [])) == 0
    assert P.MAX_LENGTH == J_MAX_LENGTH
    (got,), (want,) = tokens["port"], tokens["jax"]
    assert got.shape == want.shape == (4, J_MAX_LENGTH)
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 1:].ravel().tolist())) > 4   # the argmax moves from step to step
    with open(out["port"]) as f, open(out["jax"]) as g:
        assert json.load(f) == json.load(g)
