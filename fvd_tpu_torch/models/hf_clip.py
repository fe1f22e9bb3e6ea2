"""CLIP ViT-B/32 of ``checkpoints/hf/clip``: the counterpart of transformers'
``FlaxCLIPModel`` as ``HFClip`` runs it (the two normalised embeddings).

Modules are named as the Flax ones are (``pre_layrnorm`` included, as HF
spells it), so the checkpoint loads through
:func:`fvd_tpu_torch.weights.hf_state_dict`.  The Flax semantics kept:

* vision: NHWC pixels, a patch conv with no bias, ``class_embedding`` in
  front of the patches in raster order, learned positions, ``pre_layrnorm``,
  pre-LN layers, ``post_layernorm`` of the CLS row;
* text: learned token and position embeddings; the causal mask and the
  padding mask as one additive bias of 0 or the float32 minimum;
  ``final_layer_norm``; pooling at the first position whose id is the
  config's ``eos_token_id`` (``argmax(ids == eos)``), or at ``argmax(ids)``
  where that id is 2 (the rule of checkpoints older than transformers PR
  #24773).  This checkpoint's ``eos_token_id`` is 0;
* ``quick_gelu``, LayerNorm at the config's eps, projections with no bias,
  and both embeddings divided by their L2 norm with no epsilon;
* with ``unused``, ``logit_scale``, a 0-d parameter
  (``logit_scale_init_value``, 2.6592 by default), which the forward never
  reads: ``tools/pretrain_hf_clip.py`` scales its logits by
  ``exp(clip(logit_scale, 0, log 100))``.  Inference has none.

Float32 throughout unless ``compute_dtype`` is given: bfloat16 on float32
parameters is how the trainer runs the model
(:mod:`fvd_tpu_torch.models.hf_layers`).  The vision tower's class
embedding is a raw parameter, so the patch row joins it in float32 until
``pre_layrnorm``, as ``jnp.concatenate`` promotes it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from fvd_tpu_torch.models.hf_layers import Conv2d, Embedding, LayerNorm, Linear, set_compute_dtype
from fvd_tpu_torch.models.transformer import HF_ACTIVATIONS, attention_bias, dot_product_attention


class CLIPAttention(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.k_proj, self.v_proj, self.q_proj, self.out_proj = (Linear(d, d) for _ in range(4))

    def forward(self, x: torch.Tensor, bias=None) -> torch.Tensor:
        b, t, d = x.shape
        split = lambda y: y.view(b, t, self.heads, d // self.heads)  # noqa: E731
        o = dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)), bias,
                                  follow_dtype=True)
        return self.out_proj(o.reshape(b, t, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.fc1 = Linear(cfg["hidden_size"], cfg["intermediate_size"])
        self.fc2 = Linear(cfg["intermediate_size"], cfg["hidden_size"])
        self.act = HF_ACTIVATIONS[cfg["hidden_act"]]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm(d, eps=eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNorm(d, eps=eps)

    def forward(self, x: torch.Tensor, bias=None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg["num_hidden_layers"]))

    def forward(self, x: torch.Tensor, bias=None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, bias)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.token_embedding = Embedding(cfg["vocab_size"], cfg["hidden_size"])
        self.position_embedding = Embedding(cfg["max_position_embeddings"], cfg["hidden_size"])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.eos_token_id = cfg.get("eos_token_id", 49407)
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm(cfg["hidden_size"], eps=cfg["layer_norm_eps"])

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """[B, T] ids and mask -> the pooled output [B, D]."""
        t = input_ids.shape[-1]
        pos = torch.arange(t, device=input_ids.device)
        x = self.embeddings.token_embedding(input_ids) + self.embeddings.position_embedding(pos)[None]
        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        bias = attention_bias((attention_mask[:, None, None, :] > 0) & causal, x.dtype)
        x = self.final_layer_norm(self.encoder(x, bias))
        at = input_ids.argmax(dim=-1) if self.eos_token_id == 2 else \
            (input_ids == self.eos_token_id).int().argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), at]


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, p = cfg["hidden_size"], cfg["patch_size"]
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = Conv2d(cfg.get("num_channels", 3), d, p, stride=p, bias=False)
        self.position_embedding = Embedding((cfg["image_size"] // p) ** 2 + 1, d)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:   # [B, H, W, C]
        x = self.patch_embedding(pixels.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        dt = torch.promote_types(cls.dtype, x.dtype)
        x = torch.cat([cls.to(dt), x.to(dt)], dim=1)
        return x + self.position_embedding.table()[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(d, eps=eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = LayerNorm(d, eps=eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] normalised pixels -> the pooled output [B, D]."""
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixels)))
        return self.post_layernorm(x[:, 0])


class CLIPModel(nn.Module):
    """``cfg`` is the checkpoint's ``config.json``; ``compute_dtype`` (None:
    the parameters') is Flax's ``dtype=``; ``unused`` adds ``logit_scale``,
    which only training reads."""

    def __init__(self, cfg: dict, compute_dtype: Optional[torch.dtype] = None, unused: bool = False):
        super().__init__()
        text, vision = cfg["text_config"], cfg["vision_config"]
        self.text_model = CLIPTextTransformer(text)
        self.vision_model = CLIPVisionTransformer(vision)
        self.visual_projection = Linear(vision["hidden_size"], cfg["projection_dim"], bias=False)
        self.text_projection = Linear(text["hidden_size"], cfg["projection_dim"], bias=False)
        if unused:
            self.logit_scale = nn.Parameter(torch.tensor(float(cfg.get("logit_scale_init_value", 2.6592))))
        set_compute_dtype(self, compute_dtype)

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        """``(image_embeds, text_embeds)``, each divided by its L2 norm."""
        ie = self.visual_projection(self.vision_model(pixels))
        te = self.text_projection(self.text_model(input_ids, attention_mask))
        return (ie / torch.linalg.vector_norm(ie, dim=-1, keepdim=True),
                te / torch.linalg.vector_norm(te, dim=-1, keepdim=True))
