"""The Hugging Face model lineup of ``checkpoints/hf`` as providers: the port
of ``fvd_tpu/providers/hf_models.py``.

The reference's models — MiniLM-L6 (E1 ranking), CLIP ViT-B/32 (C2) and
Whisper base (A2) — load from a local HF Flax checkpoint directory
(``config.json``, ``flax_model.msgpack``, ``tokenizer.json`` and the
sidecars) with no ``transformers``, ``tokenizers`` or ``msgpack``: the port
reads the msgpack (:mod:`fvd_tpu_torch.utils.msgpack`), converts the tree
(:func:`fvd_tpu_torch.weights.hf_state_dict`), tokenizes
(:mod:`fvd_tpu_torch.utils.hf_tokenizers`) and computes the log-mel
(:mod:`fvd_tpu_torch.ops.whisper_frontend`) itself.  The models
(``models/hf_{bert,clip,whisper}.py``) compute in float32 on ``device``
(default the card), as the Flax modules compute on their float16 weights.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch.models.hf_bert import BertModel, mean_pool
from fvd_tpu_torch.models.hf_clip import CLIPModel
from fvd_tpu_torch.models.hf_whisper import WhisperForConditionalGeneration, greedy_generate
from fvd_tpu_torch.utils.hf_tokenizers import Tokenizer, whisper_decode
from fvd_tpu_torch.weights import hf_state_dict


def available() -> bool:
    """The port needs no extra package to load an HF checkpoint directory."""
    return True


def _json(path: str, name: str) -> dict:
    with open(os.path.join(path, name), encoding="utf-8") as f:
        return json.load(f)


def _load(model: torch.nn.Module, path: str, family: str, device) -> torch.nn.Module:
    """``model`` (built without the ``unused`` leaves) with the checkpoint's
    weights: every leaf but BERT's pooler and CLIP's ``logit_scale``, which
    inference never reads (``weights.HF_UNUSED``)."""
    from fvd_tpu_torch.utils.msgpack import read_msgpack

    model.load_state_dict(hf_state_dict(read_msgpack(os.path.join(path, "flax_model.msgpack")), family),
                          strict=True)
    return model.eval().to(device)


# ---------------------------------------------------------------------------
# MiniLM-class sentence encoder (BERT + mean pooling)
# ---------------------------------------------------------------------------
class HFTextEncoder:
    """TextEncoder protocol over a BERT encoder, on ``device``.

    ``tokenize(texts) -> {input_ids, attention_mask}`` is injectable, as in
    the JAX package."""

    def __init__(self, model: BertModel, tokenize: Callable[[List[str]], Dict[str, np.ndarray]],
                 max_len: int = 128, device=None):
        self.device = resolve_device(device)
        self.model = model.eval().to(self.device)
        self.tokenize = tokenize
        self.max_len = max_len

    @classmethod
    def from_local(cls, path: str, max_len: int = 128, device=None) -> "HFTextEncoder":
        dev = resolve_device(device)
        model = _load(BertModel(_json(path, "config.json")), path, "bert", dev)
        tok = Tokenizer.from_dir(path)
        return cls(model, lambda texts: tok(texts, max_len), max_len, device=dev)

    def encode(self, text: str) -> np.ndarray:
        return self.encode_batch([text])[0]

    @torch.no_grad()
    def encode_batch(self, texts: List[str]) -> np.ndarray:
        """Masked mean of the last hidden state, one forward for all texts."""
        enc = self.tokenize(list(texts))
        ids = torch.as_tensor(enc["input_ids"], dtype=torch.int64).to(self.device)
        mask = torch.as_tensor(enc["attention_mask"], dtype=torch.int64).to(self.device)
        return mean_pool(self.model(ids, mask), mask).cpu().numpy()


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class HFClip:
    """ClipProvider protocol over CLIP (the ViT-B/32 role), on ``device``.

    ``cal_offset``/``cal_scale`` map a first-party-trained checkpoint's
    cosine range onto the reference CLIP's (whose 0.25/0.15 C2 thresholds
    the node inherits), from ``fvd_train_meta.json``; genuine OpenAI weights
    carry no meta and stay at the identity map."""

    #: device-forward provider: eligible for cross-video coalescing
    coalescable = True

    def __init__(self, model: CLIPModel, tokenize: Callable[[List[str]], Dict[str, np.ndarray]],
                 image_size: int, cal_offset: float = 0.0, cal_scale: float = 1.0, device=None):
        self.device = resolve_device(device)
        self.model = model.eval().to(self.device)
        self.tokenize = tokenize
        self.image_size = image_size
        self.cal_offset, self.cal_scale = float(cal_offset), float(cal_scale)

    @classmethod
    def from_local(cls, path: str, device=None) -> "HFClip":
        dev = resolve_device(device)
        cfg = _json(path, "config.json")
        model = _load(CLIPModel(cfg), path, "clip", dev)
        tok = Tokenizer.from_dir(path)
        n = cfg["text_config"]["max_position_embeddings"]
        cal = {}
        if os.path.exists(os.path.join(path, "fvd_train_meta.json")):
            meta = _json(path, "fvd_train_meta.json")
            cal = {"cal_offset": float(meta.get("cal_offset", 0.0)), "cal_scale": float(meta.get("cal_scale", 1.0))}
        return cls(model, lambda texts: tok(texts, n), cfg["vision_config"]["image_size"], device=dev, **cal)

    def _preprocess(self, image: np.ndarray) -> np.ndarray:
        """OpenCV's linear resize of the array as given to the model's
        square, /255, CLIP mean and std: [1, s, s, C] float32."""
        from fvd_tpu_torch.utils.cv import resize_linear_u8

        s = self.image_size
        img = resize_linear_u8(image, s, s).astype(np.float32) / 255.0
        return ((img - CLIP_MEAN) / CLIP_STD)[None]

    def _calibrate(self, sim: np.ndarray) -> np.ndarray:
        if self.cal_scale == 1.0 and self.cal_offset == 0.0:
            return sim
        return (sim - self.cal_offset) * self.cal_scale

    def image_text_similarity(self, image: np.ndarray, text: str) -> float:
        return float(self.image_text_similarity_batch([image], [text])[0])

    @torch.no_grad()
    def image_text_similarity_batch(self, images, texts) -> np.ndarray:
        """Paired cosines for the whole keyframe set in one forward; the
        model's normalised embeddings are normalised again with +1e-8, as the
        JAX provider does."""
        enc = self.tokenize(list(texts))
        pixels = torch.from_numpy(np.concatenate([self._preprocess(im) for im in images])).to(self.device)
        ie, te = self.model(pixels, torch.as_tensor(enc["input_ids"]).to(self.device),
                            torch.as_tensor(enc["attention_mask"]).to(self.device))
        ie = ie / (torch.linalg.vector_norm(ie, dim=-1, keepdim=True) + 1e-8)
        te = te / (torch.linalg.vector_norm(te, dim=-1, keepdim=True) + 1e-8)
        return self._calibrate((ie * te).sum(dim=-1).cpu().numpy())


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------
#: generation settings whose default makes the Flax logits processor or
#: search a no-op; a checkpoint that sets one otherwise is refused
_GENERATION_DEFAULTS = {"suppress_tokens": [], "begin_suppress_tokens": [], "forced_decoder_ids": None,
                        "forced_bos_token_id": None, "forced_eos_token_id": None, "no_repeat_ngram_size": 0,
                        "min_length": 0, "num_beams": 1, "do_sample": False, "return_timestamps": None,
                        "is_multilingual": None}


class HFWhisperASR:
    """ASRProvider protocol over Whisper (A2's openai-whisper role), on
    ``device``: 30 s windows, each one log-mel on the device and one greedy
    decode."""

    model_name = "hf_whisper_flax"

    def __init__(self, model: WhisperForConditionalGeneration, tokenizer: Tokenizer, feature_config: dict,
                 generation: dict, chunk_s: float = 30.0, max_new_tokens: int = 320, device=None):
        from fvd_tpu_torch.ops.whisper_frontend import mel_filter_bank

        self.device = resolve_device(device)
        self.model = model.eval().to(self.device)
        self.tokenizer = tokenizer
        self.chunk_s = chunk_s
        self.max_new_tokens = max_new_tokens
        self.fe = dict(feature_config)
        for key, default in _GENERATION_DEFAULTS.items():
            if generation.get(key, default) not in (default, None):
                raise NotImplementedError(f"generation setting {key}={generation[key]!r} is not ported")
        self.start_id = generation["decoder_start_token_id"]
        self.eos_id = generation["eos_token_id"]
        self.pad_id = generation.get("pad_token_id", self.eos_id)
        # the extractor's bank, fixed at 0-8 kHz whatever the rate
        self.mel_filters = torch.from_numpy(mel_filter_bank(
            self.fe["n_fft"] // 2 + 1, self.fe["feature_size"], 0.0, 8000.0,
            self.fe["sampling_rate"]).astype(np.float32)).to(self.device)

    @classmethod
    def from_local(cls, path: str, device=None) -> "HFWhisperASR":
        dev = resolve_device(device)
        cfg = _json(path, "config.json")
        model = _load(WhisperForConditionalGeneration(cfg), path, "whisper", dev)
        generation = _json(path, "generation_config.json") \
            if os.path.exists(os.path.join(path, "generation_config.json")) else cfg
        return cls(model, Tokenizer.from_dir(path), _json(path, "preprocessor_config.json"), generation,
                   device=dev)

    def _features(self, audio: torch.Tensor, sr: int) -> torch.Tensor:
        """[1, n_mels, frames] input features of one window: the extractor's
        own geometry; at another rate than its own it raises, as the
        extractor does."""
        from fvd_tpu_torch.ops.whisper_frontend import whisper_log_mel

        fe = self.fe
        if sr != fe["sampling_rate"]:
            raise ValueError(
                f"The model corresponding to this feature extractor: WhisperFeatureExtractor was trained using "
                f"a sampling rate of {fe['sampling_rate']}. Please make sure that the provided `raw_speech` "
                f"input was sampled with {fe['sampling_rate']} and not {sr}.")
        n_samples = fe.get("n_samples", fe.get("chunk_length", 30) * fe["sampling_rate"])
        return whisper_log_mel(audio, self.mel_filters, n_samples, fe["n_fft"], fe["hop_length"])[None]

    def _generate(self, feats: torch.Tensor) -> np.ndarray:
        """Greedy decode of one window: ids [1, max_length], the start token
        first, padded after the end token."""
        max_len = min(self.max_new_tokens, self.model.config["max_target_positions"])
        return greedy_generate(self.model, feats, max_len, self.start_id, self.eos_id, self.pad_id).cpu().numpy()

    def transcribe(self, audio_path: str, audio=None) -> Optional[Dict[str, Any]]:
        """``audio`` (a host array or a tensor, at 16 kHz) skips the file
        read; a tensor on the device stays there."""
        sr = 16000
        if audio is None:
            from fvd_tpu_torch.utils.wav import read_wav, to_mono

            try:
                samples, sr = read_wav(audio_path)
            except Exception:
                return None
            audio = to_mono(samples)
        audio = torch.as_tensor(np.asarray(audio) if not isinstance(audio, torch.Tensor) else audio)
        audio = audio.to(self.device, torch.float32)
        chunk = int(self.chunk_s * sr)
        segments: List[dict] = []
        texts: List[str] = []
        for start in range(0, max(len(audio), 1), chunk):
            piece = audio[start:start + chunk]
            if len(piece) == 0:
                break
            with torch.no_grad():
                ids = self._generate(self._features(piece, sr))
            text = whisper_decode(self.tokenizer, ids[0]).strip()
            t0, t1 = start / sr, min(start + chunk, len(audio)) / sr
            if text:
                segments.append({"start": t0, "end": t1, "text": text})
                texts.append(text)
        return {"text": " ".join(texts), "segments": segments}
