"""Shared transformer blocks for the text, CLIP and ASR models: the
counterpart of ``fvd_tpu/models/transformer.py``.

:class:`MHABlock` is the flax pre-LN block with its submodules named after the
flax auto-names (``LayerNorm_0``, ``MultiHeadDotProductAttention_0``,
``Dense_0``), so a flax params tree loads through
:mod:`fvd_tpu_torch.weights`.  It keeps flax's semantics where torch's
defaults differ:

* ``nn.gelu`` is the tanh approximation;
* ``nn.LayerNorm`` has eps 1e-6;
* attention scales q by ``1/sqrt(Dh)``, softmaxes in float32, and sets a
  masked score to the dtype's smallest finite value (``jnp.where(mask, s,
  finfo.min)``), not -inf: a query row whose keys are all masked (a PAD row of
  the text tower) gets a uniform softmax, where a -inf mask gives NaN.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


#: the ``hidden_act`` names of the HF checkpoints, as transformers' Flax
#: ``ACT2FN`` defines them: "gelu" is the exact erf GELU, not flax's default
HF_ACTIVATIONS = {"gelu": F.gelu, "quick_gelu": quick_gelu}


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, follow_dtype: bool = False) -> torch.Tensor:
    """flax's ``dot_product_attention`` as the Hugging Face Flax models call
    it: ``q`` [B, Tq, H, Dh] divided by ``sqrt(Dh)``, scores plus the additive
    ``bias`` (broadcastable to [B, H, Tq, Tk]), a softmax in float32 (float64
    for float64 scores, as flax computes it in the inputs' dtype; in the
    scores' own dtype with ``follow_dtype``, as ``dtype=bfloat16`` does), the
    weighted sum of ``v`` [B, Tk, H, Dh] -> [B, Tq, H, Dh]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(q.shape[-1]), k)
    if bias is not None:
        s = s + bias
    sdt = s.dtype if follow_dtype else torch.promote_types(s.dtype, torch.float32)
    w = torch.softmax(s, dim=-1, dtype=sdt).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def attention_bias(allowed: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The Flax models' bias of a boolean mask: 0 where attention is allowed,
    the dtype's smallest finite value where it is not."""
    return torch.where(allowed, torch.zeros((), dtype=dtype, device=allowed.device),
                       torch.full((), torch.finfo(dtype).min, dtype=dtype, device=allowed.device))


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads)`` with the query,
    key, value and output projections as ``nn.Linear`` over all heads."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x`` [B, Tq, D] attends to ``context`` [B, Tk, D]; ``mask`` is
        boolean, broadcastable to [B, H, Tq, Tk], True where attention is
        allowed."""
        b, tq, d = x.shape
        h = self.heads
        q = self.query(x).view(b, tq, h, d // h)
        k = self.key(context).view(b, context.shape[1], h, d // h)
        v = self.value(context).view(b, context.shape[1], h, d // h)
        bias = None if mask is None else attention_bias(mask, q.dtype)
        return self.out(dot_product_attention(q, k, v, bias).reshape(b, tq, d))


def causal_mask(t: int, device=None) -> torch.Tensor:
    return torch.ones((t, t), dtype=torch.bool, device=device).tril()


class MHABlock(nn.Module):
    """Pre-LN transformer block; optional causal masking and, with
    ``cross=True``, cross-attention over a context (flax creates those
    submodules only when called with one, which fixes their names)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4, causal: bool = False,
                 cross: bool = False):
        super().__init__()
        self.causal, self.cross = causal, cross
        self.LayerNorm_0 = layer_norm(dim)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(dim, heads)
        if cross:
            self.LayerNorm_1 = layer_norm(dim)
            self.MultiHeadDotProductAttention_1 = MultiHeadDotProductAttention(dim, heads)
        setattr(self, f"LayerNorm_{2 if cross else 1}", layer_norm(dim))
        self.Dense_0 = nn.Linear(dim, dim * mlp_ratio)
        self.Dense_1 = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (context is not None) != self.cross:
            raise ValueError("a cross-attention block takes a context, and only it does")
        attn_mask = mask
        if self.causal:
            causal = causal_mask(x.shape[-2], x.device)
            attn_mask = causal if attn_mask is None else attn_mask & causal
        h = self.LayerNorm_0(x)
        x = x + self.MultiHeadDotProductAttention_0(h, h, attn_mask)
        if self.cross:
            h = self.LayerNorm_1(x)
            x = x + self.MultiHeadDotProductAttention_1(h, context)
            h = self.LayerNorm_2(x)
        else:
            h = self.LayerNorm_1(x)
        h = self.Dense_1(gelu(self.Dense_0(h)))
        return x + h


def sincos_positions(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(angle), np.cos(angle)], axis=1)
    return emb.astype(np.float32)


class ByteTokenizer:
    """Self-contained byte-level tokenizer (no downloaded vocab files).

    ids: 0 pad, 1 bos, 2 eos, 3..258 bytes.
    """

    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 3
    vocab_size = 259

    def encode(self, text: str, max_len: int, add_special: bool = False) -> np.ndarray:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        if add_special:
            ids = [self.BOS] + ids[: max_len - 2] + [self.EOS]
        ids = ids[:max_len]
        out = np.full(max_len, self.PAD, np.int32)
        out[: len(ids)] = ids
        return out

    def decode(self, ids) -> str:
        bs = bytes(int(i) - self.OFFSET for i in ids
                   if int(i) >= self.OFFSET)
        return bs.decode("utf-8", errors="replace")
