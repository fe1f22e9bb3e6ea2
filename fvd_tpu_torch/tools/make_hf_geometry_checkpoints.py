"""Fabricate Hugging Face checkpoints at the reference's geometries, random
init, without ``transformers``: the counterpart of the JAX package's
``tools/make_hf_geometry_checkpoints.py`` that the HF trainers call when
they do not ``--resume``.

    python -m fvd_tpu_torch.tools.make_hf_geometry_checkpoints --out /tmp/hf_geom/hf [--only whisper]

Each maker writes into ``dest``:

* ``config.json``: the shipped ``checkpoints/hf/<kind>/config.json`` at the
  maker's geometry (the control ids stay those of the fabricated
  tokenizers: CLIP's eos 0 and bos 1, Whisper's 0 and start 1);
* ``flax_model.msgpack``: Flax's tree of the port's model
  (:func:`fvd_tpu_torch.weights.hf_tree`,
  :func:`fvd_tpu_torch.utils.msgpack.write_msgpack`), float32;
* the tokenizer and feature-extractor files of ``checkpoints/hf/<kind>``,
  whose vocabularies are the ones the JAX tool fabricates (specials, the
  byte alphabet or the WordPiece lexicon, then filler); a smaller
  ``vocab_size`` keeps the first entries, as the JAX tool's fabrication at
  that size gives them.

The weights come from ``numpy.random.RandomState(seed)`` at the
distributions of transformers' Flax modules: BERT normal(0.02) throughout;
Whisper normal(``init_std`` 0.02) for its Dense and conv kernels, flax's
default ``Embed`` init normal(1 / sqrt(d_model)) for the decoder's token
and position tables, and the sinusoids of ``sinusoidal_embedding_init`` for
the encoder's positions; CLIP normal(0.01) for the towers' kernels and
tables, normal(0.02) for the class embedding and the projections, and
``logit_scale`` 2.6592; biases 0, LayerNorm scales 1.  The draws differ
from JAX's (``jax.random``), their distributions do not.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
from typing import Optional

import numpy as np
import torch

from fvd_tpu_torch.weights import hf_tree

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ASSETS = os.path.join(REPO, "checkpoints", "hf")
#: files of an HF checkpoint directory that the makers write themselves
_OWN = ("config.json", "flax_model.msgpack", "fvd_train_meta.json")


def sinusoids(length: int, channels: int) -> np.ndarray:
    """transformers' ``sinusoidal_embedding_init`` [length, channels]: the
    same float32 arguments, with ``exp``, ``sin`` and ``cos`` rounded
    correctly (XLA's float32 ones are not: its table is up to one float32
    ulp of ``exp`` off in a few frequencies, which 1 500 positions magnify
    to about 1e-4)."""
    if channels % 2:
        raise ValueError(f"sinusoids need an even channel count, not {channels}")
    inc = math.log(10000) / (channels // 2 - 1)
    arg = np.float32(-inc) * np.arange(channels // 2, dtype=np.float32)
    inv = np.exp(arg.astype(np.float64)).astype(np.float32)
    t = (np.arange(length, dtype=np.float32)[:, None] * inv[None]).astype(np.float64)
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _std(family: str, name: str, cfg: dict) -> float:
    """The normal init's standard deviation of a kernel or table."""
    if family == "bert":
        return cfg["initializer_range"]
    if family == "whisper":
        if name.startswith("model.decoder.embed_"):
            return 1.0 / math.sqrt(cfg["d_model"])
        return cfg["init_std"]
    if name.endswith("class_embedding") or name.split(".")[0] in ("visual_projection", "text_projection"):
        return 0.02
    return 0.01


def init_state_dict(model: torch.nn.Module, family: str, cfg: dict, seed: int = 0) -> dict:
    """Float32 weights for every parameter of ``model`` (one of the port's
    HF models) from ``RandomState(seed)``, in the module's parameter order,
    at the distributions of the module docstring."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
        if name == "logit_scale":
            arr = np.full(shape, cfg.get("logit_scale_init_value", 2.6592), np.float32)
        elif name.endswith("bias"):
            arr = np.zeros(shape, np.float32)
        elif isinstance(owner, torch.nn.LayerNorm):
            arr = np.ones(shape, np.float32)
        elif name == "model.encoder.embed_positions.weight":
            arr = sinusoids(*shape)
        else:
            arr = (rng.randn(*shape) * _std(family, name, cfg)).astype(np.float32)
        sd[name] = torch.from_numpy(arr)
    return sd


def _copy_assets(kind: str, dest: str, vocab_size: Optional[int] = None) -> None:
    """The tokenizer and extractor files of ``checkpoints/hf/<kind>`` into
    ``dest``; ``vocab_size`` below the shipped one keeps the vocabulary's
    first ids."""
    src = os.path.join(ASSETS, kind)
    for name in sorted(os.listdir(src)):
        if name in _OWN or not os.path.isfile(os.path.join(src, name)):
            continue
        shutil.copyfile(os.path.join(src, name), os.path.join(dest, name))
    if vocab_size is None:
        return
    with open(os.path.join(dest, "tokenizer.json"), encoding="utf-8") as f:
        spec = json.load(f)
    if len(spec["model"]["vocab"]) < vocab_size:
        raise ValueError(f"{src}: a vocabulary of {len(spec['model']['vocab'])} has no {vocab_size} entries")
    spec["model"]["vocab"] = {t: i for t, i in spec["model"]["vocab"].items() if i < vocab_size}
    spec["added_tokens"] = [t for t in spec.get("added_tokens") or [] if t["id"] < vocab_size]
    with open(os.path.join(dest, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False, indent=2)
    vocab_json = os.path.join(dest, "vocab.json")
    if os.path.exists(vocab_json):
        with open(vocab_json, encoding="utf-8") as f:
            vocab = {t: i for t, i in json.load(f).items() if i < vocab_size}
        with open(vocab_json, "w", encoding="utf-8") as f:
            json.dump(vocab, f, ensure_ascii=False, separators=(",", ":"))


def _write(dest: str, kind: str, family: str, cfg: dict, model: torch.nn.Module, seed: int,
           vocab_size: Optional[int] = None) -> None:
    from fvd_tpu_torch.utils.msgpack import write_msgpack

    os.makedirs(dest, exist_ok=True)
    with open(os.path.join(dest, "config.json"), "w", encoding="utf-8") as f:
        json.dump(cfg, f, indent=2, sort_keys=True)
        f.write("\n")
    write_msgpack(os.path.join(dest, "flax_model.msgpack"),
                  hf_tree(init_state_dict(model, family, cfg, seed), family))
    _copy_assets(kind, dest, vocab_size)


def _shipped_config(kind: str) -> dict:
    with open(os.path.join(ASSETS, kind, "config.json"), encoding="utf-8") as f:
        return json.load(f)


def minilm_config() -> dict:
    """all-MiniLM-L6-v2 geometry: 6-layer BERT, hidden 384, 12 heads,
    intermediate 1536, vocab 30522."""
    cfg = _shipped_config("minilm")
    cfg.update(vocab_size=30522, hidden_size=384, num_hidden_layers=6, num_attention_heads=12,
               intermediate_size=1536, max_position_embeddings=512)
    return cfg


def clip_config(tiny: bool = False) -> dict:
    """CLIP ViT-B/32 geometry (text 512 x 12, vocab 49408, 77 positions;
    vision 768 x 12, patch 32, image 224; projection 512); ``tiny``: 2-layer
    64-wide towers at the same 224 / 77 interface.  The text tower pools at
    the fabricated vocabulary's eos, id 0."""
    cfg = _shipped_config("clip")
    text, vision = cfg["text_config"], cfg["vision_config"]
    if tiny:
        text.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2)
        vision.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2)
        cfg["projection_dim"] = 64
    else:
        text.update(hidden_size=512, intermediate_size=2048, num_hidden_layers=12, num_attention_heads=8)
        vision.update(hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12)
        cfg["projection_dim"] = 512
    text.update(vocab_size=49408, max_position_embeddings=77, eos_token_id=0, bos_token_id=1, pad_token_id=0)
    vision.update(patch_size=32, image_size=224)
    return cfg


def whisper_config(d_model: int = 512, layers: int = 6, heads: int = 8, ffn: int = 2048,
                   vocab_size: int = 51865) -> dict:
    """openai/whisper-base geometry by default: d_model 512, 6 + 6 layers, 8
    heads, ffn 2048, 80 mel bins, vocab 51865, 1500 source and 448 target
    positions; eos, pad and bos 0, decoder start 1."""
    cfg = _shipped_config("whisper")
    cfg.update(vocab_size=vocab_size, num_mel_bins=80, d_model=d_model, encoder_layers=layers,
               decoder_layers=layers, num_hidden_layers=layers, encoder_attention_heads=heads,
               decoder_attention_heads=heads, encoder_ffn_dim=ffn, decoder_ffn_dim=ffn,
               max_source_positions=1500, max_target_positions=448, pad_token_id=0, bos_token_id=0,
               eos_token_id=0, decoder_start_token_id=1, suppress_tokens=[], begin_suppress_tokens=[])
    return cfg


def make_minilm(dest: str, seed: int = 0) -> None:
    """The MiniLM checkpoint of :func:`minilm_config` into ``dest``."""
    from fvd_tpu_torch.models.hf_bert import BertModel

    cfg = minilm_config()
    _write(dest, "minilm", "bert", cfg, BertModel(cfg, unused=True), seed)


def make_clip(dest: str, seed: int = 0, tiny: bool = False) -> None:
    """The CLIP checkpoint of :func:`clip_config` into ``dest``."""
    from fvd_tpu_torch.models.hf_clip import CLIPModel

    cfg = clip_config(tiny)
    _write(dest, "clip", "clip", cfg, CLIPModel(cfg, unused=True), seed)


def make_whisper(dest: str, seed: int = 0, *, d_model: int = 512, layers: int = 6, heads: int = 8,
                 ffn: int = 2048, vocab_size: int = 51865) -> None:
    """The Whisper checkpoint of :func:`whisper_config` into ``dest``, its
    tokenizer cut to ``vocab_size``."""
    from fvd_tpu_torch.models.hf_whisper import WhisperForConditionalGeneration

    cfg = whisper_config(d_model, layers, heads, ffn, vocab_size)
    _write(dest, "whisper", "whisper", cfg, WhisperForConditionalGeneration(cfg), seed,
           vocab_size=vocab_size)


MAKERS = {"minilm": make_minilm, "clip": make_clip, "whisper": make_whisper}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="/tmp/hf_geom/hf",
                    help="hf/ directory to create (the factory reads <checkpoint_dir>/hf/{minilm,clip,whisper})")
    ap.add_argument("--only", nargs="*", default=[], choices=list(MAKERS))
    args = ap.parse_args(argv)
    for kind in args.only or list(MAKERS):
        print(f"[{kind}] fabricating full-geometry random-init checkpoint...", flush=True)
        MAKERS[kind](os.path.join(args.out, kind))
        print(f"[{kind}] -> {os.path.join(args.out, kind)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
