"""The port's HF text encoder and CLIP (``fvd_tpu_torch/providers/hf_models.py``
on ``models/hf_{bert,clip}.py``) against the JAX package's
(``fvd_tpu/providers/hf_models.py`` on transformers' Flax classes), on the
CPU, float32 on both sides, on small random configs and on the shipped
checkpoints of ``checkpoints/hf``.

The JAX providers get their Flax models from ``from_pretrained(...,
_do_init=False)``: the same float16 parameters as ``from_local``'s
``from_pretrained`` without its random init, which takes 16-40 s per model
on this CPU.  Tolerance: MiniLM embeddings and CLIP similarities 1e-5.
Also: the port's factory picks the HF models where their directories exist,
the npz models where they do not, and names an HF directory that does not
load, as the JAX package's does (``tests/test_hf_real_geometry.py``).
Whisper is ``tests/test_torch_hf_whisper.py``'s."""

import json
import os
import types

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from fvd_tpu.providers import hf_models as jhf  # noqa: E402
from fvd_tpu_torch.models.hf_bert import BertModel  # noqa: E402
from fvd_tpu_torch.models.hf_clip import CLIPModel  # noqa: E402
from fvd_tpu_torch.providers import hf_models as thf  # noqa: E402
from fvd_tpu_torch.weights import hf_state_dict  # noqa: E402
from test_torch_factory import VISION, ZOO, _linked  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HF = os.path.join(ROOT, "checkpoints", "hf")
EMBED_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flax(cls, path):
    """A Flax model of ``path`` as ``from_local`` has it, without the init."""
    model, params = cls.from_pretrained(path, _do_init=False)
    return types.SimpleNamespace(module=model.module, params=params, config=model.config, generate=model.generate)


def _port(model_cls, family, flax_model, config):
    model = model_cls(config.to_dict())
    model.load_state_dict(hf_state_dict(_np(flax_model.params), family), strict=True)
    return model


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _stub_tokenize(length, eos=None):
    def tokenize(texts):
        ids = np.zeros((len(texts), length), np.int64)
        mask = np.zeros((len(texts), length), np.int64)
        for i, t in enumerate(texts):
            toks = [sum(map(ord, w)) % 90 + 3 for w in t.split()][:length - 1]
            if eos is not None:
                toks.append(eos)
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}
    return tokenize


TEXTS = ["the river rose two feet", "taxes were cut", "", "a much longer sentence with many words " * 3,
         "the river rose two feet"]


# --- MiniLM ---------------------------------------------------------------
def test_text_encoder_on_a_small_random_config():
    from transformers import BertConfig, FlaxBertModel

    config = BertConfig(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=64, max_position_embeddings=64)
    flax = FlaxBertModel(config, seed=0)
    tok = _stub_tokenize(16)
    ref = jhf.HFTextEncoder(flax, tok).encode_batch(TEXTS)
    got = thf.HFTextEncoder(_port(BertModel, "bert", flax, config), tok, device="cpu").encode_batch(TEXTS)
    assert got.shape == ref.shape == (5, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=EMBED_TOL)


@pytest.fixture(scope="module")
def minilm():
    from transformers import AutoTokenizer, FlaxAutoModel

    path = os.path.join(HF, "minilm")
    hf_tok = AutoTokenizer.from_pretrained(path)

    def tokenize(texts):
        enc = hf_tok(texts, padding="max_length", truncation=True, max_length=128, return_tensors="np")
        return {"input_ids": enc["input_ids"], "attention_mask": enc["attention_mask"]}

    return jhf.HFTextEncoder(_flax(FlaxAutoModel, path), tokenize), thf.HFTextEncoder.from_local(path, device="cpu")


def test_text_encoder_on_minilm(minilm):
    texts = TEXTS + ["The Ministry said taxes FELL 3.5% in 2023.", "Crème brûlée 日本語", "word " * 200]
    ref, got = minilm[0].encode_batch(texts), minilm[1].encode_batch(texts)
    assert got.shape == (len(texts), 384)
    np.testing.assert_allclose(got, ref, rtol=0, atol=EMBED_TOL)
    np.testing.assert_allclose(minilm[1].encode(texts[1]), got[1], rtol=0, atol=1e-6)


# --- CLIP -----------------------------------------------------------------
@pytest.mark.parametrize("eos", [0, 2])
def test_clip_on_a_small_random_config(eos):
    """``eos_token_id`` 0 pools at the first 0 (this checkpoint's rule), 2
    at ``argmax(ids)``."""
    from transformers import CLIPConfig, CLIPTextConfig, CLIPVisionConfig, FlaxCLIPModel

    config = CLIPConfig.from_text_vision_configs(
        CLIPTextConfig(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                       intermediate_size=64, max_position_embeddings=16, projection_dim=32, eos_token_id=eos),
        CLIPVisionConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                         image_size=64, patch_size=16, projection_dim=32),
        projection_dim=32)
    flax = FlaxCLIPModel(config, seed=0)
    tok = _stub_tokenize(16, eos=0 if eos == 0 else 99)
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 255, (48, 80, 3)).astype(np.uint8) for _ in range(3)]
    texts = ["a face on screen", "different words entirely", "x"]
    ref = jhf.HFClip(flax, tok, cal_offset=-0.2, cal_scale=0.5).image_text_similarity_batch(imgs, texts)
    port = thf.HFClip(_port(CLIPModel, "clip", flax, config), tok, 64, cal_offset=-0.2, cal_scale=0.5,
                      device="cpu")
    np.testing.assert_allclose(port.image_text_similarity_batch(imgs, texts), ref, rtol=0, atol=EMBED_TOL)


def test_clip_on_the_shipped_checkpoint():
    from transformers import AutoTokenizer, FlaxCLIPModel

    path = os.path.join(HF, "clip")
    hf_tok = AutoTokenizer.from_pretrained(path)

    def tokenize(texts):
        enc = hf_tok(texts, padding="max_length", truncation=True, max_length=77, return_tensors="np")
        return {"input_ids": enc["input_ids"], "attention_mask": enc["attention_mask"]}

    with open(os.path.join(path, "fvd_train_meta.json")) as f:
        meta = json.load(f)
    ref = jhf.HFClip(_flax(FlaxCLIPModel, path), tokenize, cal_offset=meta["cal_offset"],
                     cal_scale=meta["cal_scale"])
    port = thf.HFClip.from_local(path, device="cpu")
    assert (port.image_size, port.cal_offset, port.cal_scale) == (224, -0.205, 0.588235) and port.coalescable
    rng = np.random.RandomState(1)
    imgs = [rng.randint(0, 255, (180, 240, 3), np.uint8), np.full((90, 160, 3), 200, np.uint8),
            rng.randint(0, 255, (224, 224, 3), np.uint8)]
    texts = ["a person speaking on camera", "", "the moon landing happened " * 8]
    got = port.image_text_similarity_batch(imgs, texts)
    np.testing.assert_allclose(got, ref.image_text_similarity_batch(imgs, texts), rtol=0, atol=EMBED_TOL)
    assert port.image_text_similarity(imgs[0], texts[0]) == pytest.approx(float(got[0]), abs=1e-6)




# --- the factory ----------------------------------------------------------
def _hf_view(d, kinds, without=()):
    """``d/hf`` with a directory of links for each of ``kinds``, less the
    files named in ``without``."""
    for kind in kinds:
        os.makedirs(os.path.join(d, "hf", kind))
        for name in os.listdir(os.path.join(HF, kind)):
            if name not in without:
                os.symlink(os.path.join(HF, kind, name), os.path.join(d, "hf", kind, name))
    return d


def test_factory_picks_the_hf_models_where_their_directories_exist(tmp_path, capsys):
    from fvd_tpu_torch.providers import factory

    d = _hf_view(_linked(tmp_path, VISION + ZOO), ("minilm", "clip", "whisper"))
    prov = factory.production_providers(d, device="cpu", compute_dtype=torch.float32)
    out = capsys.readouterr().out
    assert isinstance(prov.text_encoder, thf.HFTextEncoder) and isinstance(prov.clip, thf.HFClip)
    assert isinstance(prov.asr, thf.HFWhisperASR) and prov.asr.model_name == "hf_whisper_flax"
    assert "providers: text encoder HFTextEncoder, CLIP HFClip, ASR HFWhisperASR" in out
    assert "failed to load HF" not in out
    for p in (prov.text_encoder, prov.clip, prov.asr):
        assert p.device == torch.device("cpu")


def test_factory_takes_the_npz_model_where_an_hf_directory_is_missing(tmp_path, capsys):
    from fvd_tpu_torch.models.asr import JaxASR
    from fvd_tpu_torch.models.encoders import JaxClip
    from fvd_tpu_torch.providers import factory

    prov = factory.production_providers(_hf_view(_linked(tmp_path, VISION + ZOO), ("minilm",)), device="cpu")
    out = capsys.readouterr().out
    assert isinstance(prov.text_encoder, thf.HFTextEncoder)
    assert isinstance(prov.clip, JaxClip) and isinstance(prov.asr, JaxASR)
    assert "providers: text encoder HFTextEncoder, CLIP JaxClip, ASR JaxASR" in out
    assert "failed to load HF" not in out


def test_factory_names_an_hf_directory_that_does_not_load(tmp_path, capsys):
    """The card's view: ``hf/clip`` without its msgpack."""
    from fvd_tpu_torch.models.encoders import JaxClip
    from fvd_tpu_torch.providers import factory

    d = _hf_view(_linked(tmp_path, VISION + ZOO), ("minilm", "whisper"))
    _hf_view(d, ("clip",), without=("flax_model.msgpack",))
    prov = factory.production_providers(d, device="cpu")
    out = capsys.readouterr().out
    assert "providers: failed to load HF clip: " in out and "flax_model.msgpack" in out
    assert isinstance(prov.clip, JaxClip)
    assert isinstance(prov.text_encoder, thf.HFTextEncoder) and isinstance(prov.asr, thf.HFWhisperASR)


# --- the JAX providers' ``from_local`` without the random init ------------
def jax_from_local_without_init(mp):
    """Patch (through the ``pytest.MonkeyPatch`` ``mp``) the JAX package's
    three ``from_local`` to the same bodies on :func:`_flax` models, so its
    factory's ``_try`` loads the HF directories in seconds."""
    from transformers import (AutoTokenizer, FlaxAutoModel, FlaxCLIPModel, FlaxWhisperForConditionalGeneration,
                              WhisperProcessor)

    def tokenizer_of(path, n):
        tok = AutoTokenizer.from_pretrained(path)

        def tokenize(texts):
            enc = tok(texts, padding="max_length", truncation=True, max_length=n, return_tensors="np")
            return {"input_ids": enc["input_ids"], "attention_mask": enc["attention_mask"]}
        return tokenize

    def text_encoder(cls, path, max_len=128):
        return cls(_flax(FlaxAutoModel, path), tokenizer_of(path, max_len), max_len)

    def clip(cls, path):
        model = _flax(FlaxCLIPModel, path)
        cal = {}
        if os.path.exists(os.path.join(path, "fvd_train_meta.json")):
            with open(os.path.join(path, "fvd_train_meta.json")) as f:
                meta = json.load(f)
            cal = {"cal_offset": float(meta.get("cal_offset", 0.0)), "cal_scale": float(meta.get("cal_scale", 1.0))}
        return cls(model, tokenizer_of(path, model.config.text_config.max_position_embeddings), **cal)

    def whisper(cls, path):
        return cls(_flax(FlaxWhisperForConditionalGeneration, path), processor=WhisperProcessor.from_pretrained(path))

    mp.setattr(jhf.HFTextEncoder, "from_local", classmethod(text_encoder))
    mp.setattr(jhf.HFClip, "from_local", classmethod(clip))
    mp.setattr(jhf.HFWhisperASR, "from_local", classmethod(whisper))
