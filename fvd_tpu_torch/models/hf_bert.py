"""BERT encoder of the MiniLM-L6 checkpoint: the counterpart of transformers'
``FlaxBertModel`` as ``HFTextEncoder`` runs it (last hidden state; the
pooler is never read).

Modules are named as the Flax ones are, so ``checkpoints/hf/minilm`` loads
through :func:`fvd_tpu_torch.weights.hf_state_dict`.  The Flax semantics
kept: embeddings are word + token type 0 + position, then LayerNorm at the
config's eps (1e-12); post-LN layers; attention adds 0 or the float32
minimum by the attention mask (a query still sees every real token);
``hidden_act`` "gelu" is the exact erf GELU of Flax's ``ACT2FN``.  Float32
throughout unless ``compute_dtype`` is given: bfloat16 on float32
parameters is how ``tools/pretrain_hf_minilm.py`` trains the model
(:mod:`fvd_tpu_torch.models.hf_layers`).  With ``unused``, ``pooler.dense``
is a parameter that the forward never reads: training keeps it and writes
it back, and AdamW's weight decay still shrinks it, as optax shrinks every
leaf.  Without it (inference) the model has no pooler.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from fvd_tpu_torch.models.hf_layers import Embedding, LayerNorm, Linear, set_compute_dtype
from fvd_tpu_torch.models.transformer import HF_ACTIVATIONS, attention_bias, dot_product_attention


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["hidden_size"]
        self.word_embeddings = Embedding(cfg["vocab_size"], d)
        self.position_embeddings = Embedding(cfg["max_position_embeddings"], d)
        self.token_type_embeddings = Embedding(cfg["type_vocab_size"], d)
        self.LayerNorm = LayerNorm(d, eps=cfg["layer_norm_eps"])

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[-1], device=ids.device)
        x = self.word_embeddings(ids) + self.token_type_embeddings.table()[0] + self.position_embeddings(pos)[None]
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.query, self.key, self.value = Linear(d, d), Linear(d, d), Linear(d, d)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        split = lambda y: y.view(b, t, self.heads, d // self.heads)  # noqa: E731
        return dot_product_attention(split(self.query(x)), split(self.key(x)), split(self.value(x)),
                                     bias, follow_dtype=True).reshape(b, t, d)


class BertDenseNorm(nn.Module):
    """``dense`` then LayerNorm of the sum with the residual (Flax's
    ``FlaxBertSelfOutput`` and ``FlaxBertOutput``)."""

    def __init__(self, d_in: int, d: int, eps: float):
        super().__init__()
        self.dense = Linear(d_in, d)
        self.LayerNorm = LayerNorm(d, eps=eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertDenseNorm(cfg["hidden_size"], cfg["hidden_size"], cfg["layer_norm_eps"])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x, bias), x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.dense = Linear(cfg["hidden_size"], cfg["intermediate_size"])
        self.act = HF_ACTIVATIONS[cfg["hidden_act"]]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.dense(x))


class BertLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertDenseNorm(cfg["intermediate_size"], cfg["hidden_size"], cfg["layer_norm_eps"])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        h = self.attention(x, bias)
        return self.output(self.intermediate(h), h)


class BertEncoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg["num_hidden_layers"]))


class BertPooler(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.dense = Linear(cfg["hidden_size"], cfg["hidden_size"])


class BertModel(nn.Module):
    """``cfg`` is the checkpoint's ``config.json``; ``compute_dtype`` (None:
    the parameters') is Flax's ``dtype=``; ``unused`` adds the pooler, which
    only training keeps."""

    def __init__(self, cfg: dict, compute_dtype: Optional[torch.dtype] = None, unused: bool = False):
        super().__init__()
        if cfg.get("position_embedding_type", "absolute") != "absolute":
            raise NotImplementedError(f"position_embedding_type {cfg['position_embedding_type']}")
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)
        if unused:
            self.pooler = BertPooler(cfg)
        set_compute_dtype(self, compute_dtype)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """[B, T] ids and mask -> the last hidden state [B, T, D]."""
        x = self.embeddings(input_ids)
        bias = attention_bias(attention_mask[:, None, None, :] > 0, x.dtype)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """sentence-transformers' masked mean pooling, the count clipped at 1e-9."""
    mask = attention_mask[..., None].to(hidden.dtype)
    return (hidden * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1e-9)
