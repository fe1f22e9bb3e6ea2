"""Sentence encoder and CLIP-style dual towers: the counterpart of
``fvd_tpu/models/encoders.py``.

Roles filled (SURVEY §2.4): MiniLM-L6-v2 (E1 evidence re-ranking,
``e1_web_evidence.py:330-354``) and CLIP ViT-B/32 (C2 gesture-narration
consistency, ``c2_gesture_narration_check.py:49-121``).

The towers are the flax modules with the flax submodule names, loaded from the
same npz checkpoints through :mod:`fvd_tpu_torch.weights`.  They run in
float32 whatever the vision models' compute dtype, as the flax modules do.
:class:`JaxTextEncoder` and :class:`JaxClip` keep the JAX package's class
names, so a reader finds the counterparts; they need a checkpoint or a params
tree (the port has no random-init model).  :func:`clip_loss` and
:func:`text_info_nce_loss` are the towers' training losses.
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch import weights as weights_mod
from fvd_tpu_torch.models.layers import SameConv2d
from fvd_tpu_torch.models.transformer import ByteTokenizer, MHABlock, layer_norm, sincos_positions

MAX_TEXT_LEN = 128
IMAGE_SIZE = 112
PATCH = 16


def _heads(dim: int, heads: int) -> int:
    return heads or max(1, dim // 32)


class TextTower(nn.Module):
    def __init__(self, dim: int = 192, depth: int = 6, heads: int = 0, out_dim: int = 256):
        super().__init__()
        self.dim = dim
        self.Embed_0 = nn.Embedding(ByteTokenizer.vocab_size, dim)
        for i in range(depth):
            setattr(self, f"MHABlock_{i}", MHABlock(dim, _heads(dim, heads)))
        self.depth = depth
        self.LayerNorm_0 = layer_norm(dim)
        self.Dense_0 = nn.Linear(dim, out_dim)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:   # [B, T] int
        mask = ids != ByteTokenizer.PAD
        x = self.Embed_0(ids.long())
        x = x + torch.from_numpy(sincos_positions(ids.shape[-1], self.dim)).to(x.device)
        attn_mask = mask[:, None, None, :] & mask[:, None, :, None]
        for i in range(self.depth):
            x = getattr(self, f"MHABlock_{i}")(x, mask=attn_mask)
        x = self.LayerNorm_0(x)
        # masked mean pooling (the sentence-transformers pooling)
        denom = mask.sum(dim=-1, keepdim=True).clamp(min=1)
        pooled = (x * mask[..., None]).sum(dim=-2) / denom
        return self.Dense_0(pooled)


class ImageTower(nn.Module):
    def __init__(self, dim: int = 192, depth: int = 6, heads: int = 0, out_dim: int = 256):
        super().__init__()
        self.dim = dim
        self.Conv_0 = SameConv2d(3, dim, PATCH, stride=PATCH)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        for i in range(depth):
            setattr(self, f"MHABlock_{i}", MHABlock(dim, _heads(dim, heads)))
        self.depth = depth
        self.LayerNorm_0 = layer_norm(dim)
        self.Dense_0 = nn.Linear(dim, out_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:  # float [B, 112, 112, 3] in 0..1
        x = self.Conv_0(images.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)          # patches in NHWC raster order
        x = torch.cat([self.cls.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + torch.from_numpy(sincos_positions(x.shape[1], self.dim)).to(x.device)
        for i in range(self.depth):
            x = getattr(self, f"MHABlock_{i}")(x)
        x = self.LayerNorm_0(x)
        return self.Dense_0(x[:, 0])


class ClipModel(nn.Module):
    """Dual towers + learned logit scale (CLIP training objective)."""

    def __init__(self, dim: int = 192, depth: int = 6, out_dim: int = 256):
        super().__init__()
        self.text = TextTower(dim=dim, depth=depth, out_dim=out_dim)
        self.image = ImageTower(dim=dim, depth=depth, out_dim=out_dim)
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        e = self.text(ids)
        return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        e = self.image(images)
        return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)

    def forward(self, images: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return self.encode_image(images) @ self.encode_text(ids).T * self.logit_scale.exp()


def _symmetric_info_nce(logits: torch.Tensor) -> torch.Tensor:
    """The mean of the row-wise and column-wise cross entropy of ``logits``
    [N, N] whose diagonal holds the positives."""
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = -torch.log_softmax(logits, dim=1)[labels, labels].mean()
    lt = -torch.log_softmax(logits, dim=0)[labels, labels].mean()
    return (li + lt) / 2


def clip_loss(model: ClipModel, images: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE on ``model``'s logits (cosines times
    ``exp(logit_scale)``)."""
    return _symmetric_info_nce(model(images, ids))


#: the text tower's contrastive temperature (``tools/pretrain_text_encoder.py``)
TEXT_TEMPERATURE = 0.07


def text_info_nce_loss(model: TextTower, q_ids: torch.Tensor, d_ids: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE of query and document embeddings, unit-normalised,
    at temperature ``TEXT_TEMPERATURE``: the text encoder's training loss."""
    q, d = model(q_ids), model(d_ids)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return _symmetric_info_nce((q @ d.T) / TEXT_TEMPERATURE)


def _load(model: nn.Module, params: Optional[Mapping], checkpoint: Optional[str], device) -> nn.Module:
    if params is None:
        if checkpoint is None:
            raise ValueError("pass a checkpoint or a params tree: the port has no random-init model")
        params = weights_mod.read_npz(checkpoint)
    model.load_state_dict(weights_mod.to_state_dict(params), strict=True)
    return model.eval().to(device)


# ---------------------------------------------------------------------------
# Provider wrappers
# ---------------------------------------------------------------------------
class JaxTextEncoder:
    """TextEncoder protocol over the TextTower (MiniLM role), on ``device``
    (default the card)."""

    def __init__(self, params: Optional[Mapping] = None, dim: int = 192, depth: int = 6,
                 out_dim: int = 256, checkpoint: Optional[str] = None, device=None):
        self.tok = ByteTokenizer()
        self.dim, self.depth, self.out_dim = dim, depth, out_dim
        self.device = resolve_device(device)
        self.model = _load(TextTower(dim=dim, depth=depth, out_dim=out_dim), params, checkpoint,
                           self.device)

    def encode(self, text: str) -> np.ndarray:
        return self.encode_batch([text])[0]

    @torch.no_grad()
    def encode_batch(self, texts: List[str]) -> np.ndarray:
        """One forward over all ``texts``; each row's embedding depends on
        that text only."""
        ids = np.stack([self.tok.encode(t, MAX_TEXT_LEN) for t in texts])
        return self.model(torch.from_numpy(ids).to(self.device)).cpu().numpy()


class JaxClip:
    """ClipProvider protocol over the dual towers (CLIP ViT-B/32 role), on
    ``device`` (default the card).

    ``cal_offset``/``cal_scale`` linearly map this model's cosine range onto
    the reference CLIP's (whose 0.25/0.15 thresholds C2 inherits): computed
    at train time as (mean mismatched cosine, 0.35 / (matched - mismatched))
    and stored in the checkpoint sidecar.
    """

    #: device-forward provider: eligible for cross-video coalescing
    coalescable = True

    def __init__(self, params: Optional[Mapping] = None, dim: int = 192, depth: int = 6,
                 out_dim: int = 256, checkpoint: Optional[str] = None,
                 cal_offset: float = 0.0, cal_scale: float = 1.0, device=None):
        self.tok = ByteTokenizer()
        self.dim, self.depth, self.out_dim = dim, depth, out_dim
        self.cal_offset, self.cal_scale = cal_offset, cal_scale
        self.device = resolve_device(device)
        self.model = _load(ClipModel(dim=dim, depth=depth, out_dim=out_dim), params, checkpoint,
                           self.device)

    def image_text_similarity(self, image: np.ndarray, text: str) -> float:
        return float(self.image_text_similarity_batch([image], [text])[0])

    @torch.no_grad()
    def image_text_similarity_batch(self, images, texts) -> np.ndarray:
        """Paired (image_i, text_i) cosines in one forward of each tower: C2
        scores a whole keyframe set per call.  Images are resized on the host
        as the JAX package resizes them (OpenCV's fixed-point linear rule)
        and shipped as uint8."""
        from fvd_tpu_torch.utils.cv import resize_linear_u8

        imgs = np.stack([resize_linear_u8(im, IMAGE_SIZE, IMAGE_SIZE) for im in images])
        ids = np.stack([self.tok.encode(t, MAX_TEXT_LEN) for t in texts])
        x = torch.from_numpy(imgs).to(self.device).float() / 255.0
        ie = self.model.encode_image(x)
        te = self.model.encode_text(torch.from_numpy(ids).to(self.device))
        sim = (ie * te).sum(dim=-1).cpu().numpy()
        return (sim - self.cal_offset) * self.cal_scale
