"""``fvd_tpu_torch/providers/factory.py`` against ``fvd_tpu/providers/factory.py``
on the CPU: on a checkpoint directory of links to the shipped npz files and
their sidecars with no ``hf/`` (what the card's machine holds), both
packages' production bundles load the same kinds of model at the same dims;
without the zoo's files both fall back the same way; a file that is there
but does not load raises in the port."""

import os

import numpy as np
import pytest
import torch

from fvd_tpu.providers import factory as jfactory
from fvd_tpu_torch.models.asr import JaxASR
from fvd_tpu_torch.models.encoders import JaxClip, JaxTextEncoder
from fvd_tpu_torch.models.ocr import JaxOCR
from fvd_tpu_torch.nodes import c2_gesture
from fvd_tpu_torch.providers import factory
from fvd_tpu_torch.providers.asr import EnergyVAD
from fvd_tpu_torch.providers.encoders import HashingTextEncoder
from fvd_tpu_torch.state import State

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
VISION = ("face_ssd.npz", "landmarks.npz", "pose.npz", "pose.json", "ocr_det.npz", "ocr_det.json", "ocr_rec.npz",
          "ocr_rec.json")
ZOO = ("clip.npz", "clip.json", "text_encoder.npz", "text_encoder.json", "asr.npz", "asr.json",
       "asr_formant.npz", "asr_formant.json")


def _linked(tmp_path, names):
    d = tmp_path / "ckpt"
    d.mkdir()
    for n in names:
        if os.path.exists(os.path.join(CKPT, n)):
            os.symlink(os.path.join(CKPT, n), d / n)
    return str(d)


def test_bundle_loads_the_same_models_as_jax(tmp_path, capsys):
    d = _linked(tmp_path, VISION + ZOO)
    t = factory.production_providers(d, device="cpu")
    out = capsys.readouterr().out  # no hf/ here
    assert "providers: text encoder JaxTextEncoder, CLIP JaxClip, ASR JaxASR" in out
    assert "failed to load HF" not in out
    j = jfactory.production_providers(d, use_llm=False, use_search=False)
    assert isinstance(t.text_encoder, JaxTextEncoder) and type(j.text_encoder).__name__ == "JaxTextEncoder"
    assert (t.text_encoder.dim, t.text_encoder.depth, t.text_encoder.out_dim) == \
        (j.text_encoder.dim, j.text_encoder.depth, j.text_encoder.out_dim) == (192, 4, 256)
    assert isinstance(t.clip, JaxClip) and type(j.clip).__name__ == "JaxClip"
    assert (t.clip.dim, t.clip.depth, t.clip.out_dim, t.clip.cal_offset, t.clip.cal_scale) == \
        (j.clip.dim, j.clip.depth, j.clip.out_dim, j.clip.cal_offset, j.clip.cal_scale)
    assert isinstance(t.asr, JaxASR) and type(j.asr).__name__ == "JaxASR"
    assert (t.asr.dim, t.asr.depth, t.asr.chunk_frames, t.asr.max_tokens, t.asr.dither) == \
        (j.asr.dim, j.asr.depth, j.asr.chunk_frames, j.asr.max_tokens, j.asr.dither) == (192, 4, 128, 16, 0.002)
    assert isinstance(t.ocr, JaxOCR) and t.ocr.model_name == j.ocr.model_name
    assert (t.ocr.det_arch, t.ocr.det_width, t.ocr.rec_width) == (j.ocr.det_arch, j.ocr.det_width,
                                                                  j.ocr.rec_width) == ("v2", 128, 32)
    assert t.llm.available is j.llm.available is False
    for p in (t.text_encoder, t.clip, t.asr, t.ocr):
        assert p.device == torch.device("cpu")
    assert factory.asr_speech_domain(d) == jfactory.asr_speech_domain(d) == "formant"


def test_tone_asr_when_the_formant_checkpoint_is_missing(tmp_path):
    d = _linked(tmp_path, VISION + tuple(n for n in ZOO if not n.startswith("asr_formant")))
    t = factory.production_providers(d, device="cpu")
    assert (t.asr.dim, t.asr.depth, t.asr.dither) == (128, 2, 0.01)
    assert factory.asr_speech_domain(d) == jfactory.asr_speech_domain(d) == "tone"


def test_without_the_zoo_files_c2_skips_and_the_fallbacks_run(tmp_path):
    """EnergyVAD segments, the hashing encoder and no CLIP, as the JAX
    package's ``tests/test_factory.py`` requires of it."""
    t = factory.production_providers(_linked(tmp_path, VISION), device="cpu")
    assert t.clip is None
    assert isinstance(t.text_encoder, HashingTextEncoder) and isinstance(t.asr, EnergyVAD)
    assert isinstance(t.ocr, JaxOCR)
    delta = c2_gesture.run(State(keyframes=["x.png"], segments=[{"start": 0, "end": 1, "text": "t"}],
                                 metadata={"video_fps": 30.0}), providers=t)
    assert delta == {}


def test_a_checkpoint_that_does_not_load_raises(tmp_path):
    d = _linked(tmp_path, VISION)
    np.savez(os.path.join(d, "text_encoder.npz"), **{"['params']['Dense_0']['kernel']": np.zeros((3, 3))})
    with pytest.raises(RuntimeError):
        factory.production_providers(d, device="cpu")


def test_hf_dir_is_named_and_the_npz_models_run(tmp_path, capsys, monkeypatch):
    """An ``hf/`` with none of the three model directories: the npz models,
    as the JAX package's ``_try`` gives them, named on the ``providers:``
    line (and, with no key in the environment, no LLM and the default search
    chain on the next)."""
    for k in ("OPENAI_API_KEY", "FVD_SEARCH_CACHE_DIR"):
        monkeypatch.delenv(k, raising=False)
    d = _linked(tmp_path, VISION + ZOO)
    os.mkdir(os.path.join(d, "hf"))
    t = factory.production_providers(d, device="cpu")
    out = capsys.readouterr().out
    assert "providers: text encoder JaxTextEncoder, CLIP JaxClip, ASR JaxASR" in out
    assert "providers: LLM NullLLM, search ChainSearch(SerperSearch, GoogleCSESearch, DuckDuckGoSearch)" in out
    assert "failed to load HF" not in out
    assert isinstance(t.asr, JaxASR) and isinstance(t.clip, JaxClip)
