"""Whisper base of ``checkpoints/hf/whisper``: the counterpart of transformers'
``FlaxWhisperForConditionalGeneration`` as ``HFWhisperASR`` runs it (its
``generate`` with the checkpoint's generation config: greedy, no logits
processor that changes a score).

Modules are named as the Flax ones are, so the checkpoint loads through
:func:`fvd_tpu_torch.weights.hf_state_dict`.  The Flax semantics kept:

* encoder: ``conv1`` (k 3, pad 1) -> exact GELU -> ``conv2`` (k 3, stride 2,
  pad 1) -> exact GELU -> plus the stored ``embed_positions``, pre-LN
  layers, a final LayerNorm (eps 1e-5 throughout);
* decoder: token plus learned position embeddings, pre-LN layers of causal
  self-attention, cross-attention over the encoder output and the MLP, a
  final LayerNorm, logits against ``embed_tokens`` (the tied head);
* attention: ``k_proj`` has no bias; q divided by ``sqrt(head_dim)``; masks
  are additive biases of 0 or the float32 minimum.

:func:`greedy_generate` is Flax's ``_greedy_search`` as a host loop with a
key/value cache: the cross-attention keys and values are computed once per
window, each step appends one position to the self-attention cache and
fetches whether every row has ended (one fetch per step).  Float32
throughout unless ``compute_dtype`` is given: bfloat16 on float32
parameters is how ``tools/pretrain_hf_whisper.py`` trains the model
(:mod:`fvd_tpu_torch.models.hf_layers`).  The encoder's ``embed_positions``
is frozen, as the Flax encoder's ``stop_gradient`` freezes it: it gets no
gradient from the loss, but AdamW's weight decay still shrinks it, as optax
shrinks every leaf.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from fvd_tpu_torch.models.hf_layers import Conv1d, Embedding, LayerNorm, Linear, set_compute_dtype
from fvd_tpu_torch.models.transformer import HF_ACTIVATIONS, attention_bias, dot_product_attention


class WhisperAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(d, d, bias=False)
        self.v_proj = Linear(d, d)
        self.out_proj = Linear(d, d)

    def split(self, y: torch.Tensor) -> torch.Tensor:
        return y.view(y.shape[0], y.shape[1], self.heads, -1)

    def key_values(self, x: torch.Tensor):
        return self.split(self.k_proj(x)), self.split(self.v_proj(x))

    def forward(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias=None) -> torch.Tensor:
        o = dot_product_attention(self.split(self.q_proj(x)), k, v, bias, follow_dtype=True)
        return self.out_proj(o.reshape(x.shape[0], x.shape[1], -1))


class WhisperEncoderLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["d_model"]
        self.self_attn = WhisperAttention(d, cfg["encoder_attention_heads"])
        self.self_attn_layer_norm = LayerNorm(d, eps=1e-5)
        self.fc1 = Linear(d, cfg["encoder_ffn_dim"])
        self.fc2 = Linear(cfg["encoder_ffn_dim"], d)
        self.final_layer_norm = LayerNorm(d, eps=1e-5)
        self.act = HF_ACTIVATIONS[cfg["activation_function"]]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.self_attn_layer_norm(x)
        x = x + self.self_attn(h, *self.self_attn.key_values(h))
        return x + self.fc2(self.act(self.fc1(self.final_layer_norm(x))))


class WhisperDecoderLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["d_model"]
        self.self_attn = WhisperAttention(d, cfg["decoder_attention_heads"])
        self.self_attn_layer_norm = LayerNorm(d, eps=1e-5)
        self.encoder_attn = WhisperAttention(d, cfg["decoder_attention_heads"])
        self.encoder_attn_layer_norm = LayerNorm(d, eps=1e-5)
        self.fc1 = Linear(d, cfg["decoder_ffn_dim"])
        self.fc2 = Linear(cfg["decoder_ffn_dim"], d)
        self.final_layer_norm = LayerNorm(d, eps=1e-5)
        self.act = HF_ACTIVATIONS[cfg["activation_function"]]

    def forward(self, x: torch.Tensor, cross_k: torch.Tensor, cross_v: torch.Tensor, bias=None,
                cache=None, t: int = 0) -> torch.Tensor:
        """``x`` [B, S, D] at positions ``t``..``t + S``; with ``cache``, a
        (keys, values) pair of [B, max_length, H, Dh], their rows up to
        ``t`` are the earlier positions' and this call writes its own."""
        h = self.self_attn_layer_norm(x)
        k, v = self.self_attn.key_values(h)
        if cache is not None:
            end = t + x.shape[1]
            cache[0][:, t:end] = k
            cache[1][:, t:end] = v
            k, v = cache[0][:, :end], cache[1][:, :end]
        x = x + self.self_attn(h, k, v, bias)
        x = x + self.encoder_attn(self.encoder_attn_layer_norm(x), cross_k, cross_v)
        return x + self.fc2(self.act(self.fc1(self.final_layer_norm(x))))


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["d_model"]
        self.conv1 = Conv1d(cfg["num_mel_bins"], d, 3, padding=1)
        self.conv2 = Conv1d(d, d, 3, stride=2, padding=1)
        self.embed_positions = Embedding(cfg["max_source_positions"], d)
        self.layers = nn.ModuleList(WhisperEncoderLayer(cfg) for _ in range(cfg["encoder_layers"]))
        self.layer_norm = LayerNorm(d, eps=1e-5)
        self.act = HF_ACTIVATIONS[cfg["activation_function"]]
        self.frames = 2 * cfg["max_source_positions"]

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """[B, n_mels, 2 * max_source_positions] log-mel -> [B, positions, D]."""
        if features.shape[-1] != self.frames:
            raise ValueError(f"input_features must have {self.frames} frames, not {features.shape[-1]}")
        x = self.act(self.conv2(self.act(self.conv1(features)))).transpose(1, 2)
        x = x + self.embed_positions.table().detach()[None]
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["d_model"]
        self.embed_tokens = Embedding(cfg["vocab_size"], d)
        self.embed_positions = Embedding(cfg["max_target_positions"], d)
        self.layers = nn.ModuleList(WhisperDecoderLayer(cfg) for _ in range(cfg["decoder_layers"]))
        self.layer_norm = LayerNorm(d, eps=1e-5)


class WhisperModel(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.encoder = WhisperEncoder(cfg)
        self.decoder = WhisperDecoder(cfg)


class WhisperForConditionalGeneration(nn.Module):
    """``cfg`` is the checkpoint's ``config.json``; ``compute_dtype`` (None:
    the parameters') is Flax's ``dtype=``."""

    def __init__(self, cfg: dict, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = cfg
        self.model = WhisperModel(cfg)
        set_compute_dtype(self, compute_dtype)

    def encode(self, features: torch.Tensor) -> torch.Tensor:
        return self.model.encoder(features)

    def cross_key_values(self, memory: torch.Tensor) -> List[tuple]:
        """Each decoder layer's cross-attention keys and values of ``memory``."""
        return [layer.encoder_attn.key_values(memory) for layer in self.model.decoder.layers]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        dec = self.model.decoder
        return dec.layer_norm(x) @ dec.embed_tokens.table().T

    def forward(self, features: torch.Tensor, decoder_input_ids: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits [B, S, vocab] of ``decoder_input_ids`` [B, S]
        at positions ``0..S``, in the compute dtype."""
        dec = self.model.decoder
        cross = self.cross_key_values(self.encode(features))
        s = decoder_input_ids.shape[-1]
        x = dec.embed_tokens(decoder_input_ids) + dec.embed_positions.table()[:s][None]
        bias = attention_bias(torch.ones((s, s), dtype=torch.bool, device=x.device).tril(), x.dtype)
        for layer, (ck, cv) in zip(dec.layers, cross):
            x = layer(x, ck, cv, bias)
        return self._logits(x)


@torch.no_grad()
def greedy_generate(model: WhisperForConditionalGeneration, features: torch.Tensor, max_length: int,
                    start_id: int, eos_id: int, pad_id: int,
                    step_logits: Optional[list] = None) -> torch.Tensor:
    """Flax ``generate`` with ``num_beams`` 1 and no sampling: sequences
    [B, max_length] starting with ``start_id``, the argmax token (the first
    of a tie) appended until every row has emitted ``eos_id`` or the length
    is reached, ``pad_id`` after a row's end.  ``step_logits``, a list,
    collects each step's logits."""
    b = features.shape[0]
    dev = features.device
    dec = model.model.decoder
    cross = model.cross_key_values(model.encode(features))
    seq = torch.full((b, max_length), pad_id, dtype=torch.int64, device=dev)
    seq[:, 0] = start_id
    heads = dec.layers[0].self_attn.heads
    d = dec.embed_tokens.weight.shape[1]
    dt = cross[0][0].dtype
    cache = [(torch.zeros(b, max_length, heads, d // heads, device=dev, dtype=dt),
              torch.zeros(b, max_length, heads, d // heads, device=dev, dtype=dt)) for _ in dec.layers]
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for t in range(max_length - 1):
        x = dec.embed_tokens(seq[:, t:t + 1]) + dec.embed_positions.table()[t][None, None]
        for layer, (ck, cv), kv in zip(dec.layers, cross, cache):
            x = layer(x, ck, cv, cache=kv, t=t)
        logits = model._logits(x)[:, 0]
        if step_logits is not None:
            step_logits.append(logits)
        nxt = torch.where(done, torch.full_like(done, pad_id, dtype=torch.int64), logits.argmax(dim=-1))
        seq[:, t + 1] = nxt
        done = done | (nxt == eos_id)
        if bool(done.all()):
            break
    return seq
