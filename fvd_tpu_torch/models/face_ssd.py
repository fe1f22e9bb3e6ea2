"""SSD-style face detector (V1): the counterpart of ``fvd_tpu/models/face_ssd.py``.

:class:`FaceSSD` is the same network as the flax ``FaceSSD`` (a strided-conv
backbone and three detection heads) with submodules named after the flax
auto-names, so a flax params tree loads through :mod:`fvd_tpu_torch.weights`.
:func:`detect_batch` is ``detect_batch_jit``: resize, backbone in
``compute_dtype``, box decode, top-256 prefilter and greedy NMS, batched over
frames.  :class:`SSDFaceDetector` is the V1 provider around it (batched
detect on host frames or a device tensor, through
:func:`~fvd_tpu_torch.parallel.inference.shard_for_inference` so an installed
inference mesh splits the frames over its devices; host unpacking of the
slots with ``s > 0``).

Training: :func:`ssd_loss`, :func:`make_train_step` on ``torch.optim.Adam``
(the update of ``optax.adam``) and :func:`save_params`, which writes the JAX
package's npz; ``weights.seeded(FaceSSD(width), seed)`` gives flax's initial
scales from a numpy seed.
"""

from __future__ import annotations

import functools
from typing import List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch import weights as weights_mod
from fvd_tpu_torch.models.layers import SameConv2d, adam, adam_step, group_norm, in_dtype
from fvd_tpu_torch.ops import detection
from fvd_tpu_torch.ops.image import resize
from fvd_tpu_torch.parallel.inference import shard_for_inference
from fvd_tpu_torch.providers.vision import FaceBox

INPUT_SIZE = 300
#: (feature map size, anchor scales, aspect ratios) per head
HEAD_SPECS = [
    ((38, 38), [0.04, 0.08], [1.0, 1.5]),
    ((19, 19), [0.16, 0.24], [1.0, 1.5]),
    ((10, 10), [0.36, 0.56], [1.0, 1.5]),
]
MEAN_RGB = (123.0, 117.0, 104.0)


def anchors() -> np.ndarray:
    return detection.make_anchors(
        [s for s, _, _ in HEAD_SPECS],
        [sc for _, sc, _ in HEAD_SPECS],
        [ar for _, _, ar in HEAD_SPECS],
    )


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = SameConv2d(in_ch, features, 3, stride=stride, bias=False)
        self.GroupNorm_0 = group_norm(features)

    def forward(self, x):
        return F.relu(self.GroupNorm_0(self.Conv_0(x)))


class FaceSSD(nn.Module):
    """Backbone + per-head (loc, conf) predictors.

    Input float NHWC [B, 300, 300, 3] (mean-subtracted), as the flax model
    takes it; output (loc [B, A, 4], conf_logits [B, A])."""

    def __init__(self, width: int = 32):
        super().__init__()
        w = width
        plan = [(3, w, 2), (w, w, 1), (w, 2 * w, 2), (2 * w, 2 * w, 1), (2 * w, 4 * w, 2),
                (4 * w, 4 * w, 1), (4 * w, 8 * w, 2), (8 * w, 8 * w, 1), (8 * w, 8 * w, 2)]
        for i, (cin, cout, s) in enumerate(plan):
            setattr(self, f"ConvBlock_{i}", ConvBlock(cin, cout, s))
        for h, (cin, (_, scales, ars)) in enumerate(zip((4 * w, 8 * w, 8 * w), HEAD_SPECS)):
            k = len(scales) * len(ars)
            setattr(self, f"Conv_{2 * h}", SameConv2d(cin, 4 * k, 3))
            setattr(self, f"Conv_{2 * h + 1}", SameConv2d(cin, k, 3))
        self.width = width

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        for i in range(5):                      # 150, 150, 75, 75, 38
            x = getattr(self, f"ConvBlock_{i}")(x)
        f1 = self.ConvBlock_5(x)
        f2 = self.ConvBlock_7(self.ConvBlock_6(f1))   # 19
        f3 = self.ConvBlock_8(f2)                     # 10
        b = x.shape[0]
        locs, confs = [], []
        for h, feat in enumerate((f1, f2, f3)):
            # flax reshapes its NHWC head output: anchors run (row, col, k)
            loc = getattr(self, f"Conv_{2 * h}")(feat).permute(0, 2, 3, 1)
            conf = getattr(self, f"Conv_{2 * h + 1}")(feat).permute(0, 2, 3, 1)
            locs.append(loc.reshape(b, -1, 4))
            confs.append(conf.reshape(b, -1))
        return torch.cat(locs, dim=1), torch.cat(confs, dim=1)


def from_params(params: Mapping, device=None) -> FaceSSD:
    """A :class:`FaceSSD` holding a flax params tree (flat npz keys or a
    nested numpy tree); the width is read from the first conv kernel."""
    width = weights_mod.kernel_width(params, "ConvBlock_0.Conv_0")
    model = FaceSSD(width)
    model.load_state_dict(weights_mod.to_state_dict(params), strict=True)
    return model.eval().to(device)


@torch.no_grad()
def detect_batch(
    model: FaceSSD,
    frames: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
    max_out: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 NHWC frames [B, H, W, 3] -> (boxes [B, max_out, 4] normalized
    corners, scores [B, max_out]).

    The backbone runs in ``compute_dtype`` (bf16 by default, as the
    reference); decode and NMS stay float32."""
    x = resize(frames.to(torch.float32), (INPUT_SIZE, INPUT_SIZE), antialias=True)
    x = (x - torch.tensor(MEAN_RGB, device=x.device)).to(compute_dtype)
    loc, conf = in_dtype(model, compute_dtype)(x)
    boxes = detection.decode_boxes(loc.float(), torch.from_numpy(anchors()).to(x.device))
    scores = torch.sigmoid(conf.float())

    # top-k prefilter keeps the NMS IoU matrix small (k^2, not A^2); a stable
    # sort breaks ties by index, as lax.top_k does
    k = min(256, scores.shape[1])
    order = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = order.values[:, :k], order.indices[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    return detection.nms(top_boxes, top_scores, max_out=max_out, iou_threshold=0.45,
                         score_threshold=0.05)


class SSDFaceDetector:
    """FaceDetectorProvider: one batched :func:`detect_batch` forward and one
    host fetch per call, then host unpacking of the slots with a score above
    0 (``fvd_tpu/models/face_ssd.py`` ``SSDFaceDetector``)."""

    model_name = "fvd_tpu_ssd"
    #: nodes may pass a device-resident frame tensor instead of host numpy
    accepts_device_frames = True

    def __init__(self, checkpoint: str, max_out: int = 32,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.model = from_params(weights_mod.read_npz(checkpoint), self.device)
        self.width = self.model.width
        self.max_out = max_out
        self.compute_dtype = compute_dtype

    def detect_batch(self, frames) -> List[List[FaceBox]]:
        """uint8 [T, H, W, 3] RGB, host numpy or a tensor on the detector's
        device -> per-frame detections in pixels."""
        if len(frames) == 0:
            return []
        x = frames if torch.is_tensor(frames) else torch.from_numpy(np.ascontiguousarray(frames))
        h, w = x.shape[1:3]
        # frames are independent: split them over the inference mesh's data
        # devices when one is installed (the call as it is otherwise)
        boxes, scores = shard_for_inference(
            functools.partial(detect_batch, compute_dtype=self.compute_dtype, max_out=self.max_out),
            self.model, x.to(self.device))
        host = torch.cat([boxes, scores[..., None]], dim=-1).cpu().numpy()  # ONE host fetch
        out: List[List[FaceBox]] = []
        for rows in host:
            bb, ss = rows[:, :4], rows[:, 4]
            out.append([FaceBox(b[0] * w, b[1] * h, b[2] * w, b[3] * h, float(s))
                        for b, s in zip(bb, ss) if s > 0.0])
        return out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
#: write a model as the JAX package's flat npz (``face_ssd.npz``), and load one
save_params, load_params = weights_mod.save_npz, weights_mod.load_npz


def ssd_loss(model: FaceSSD, frames: torch.Tensor, labels: torch.Tensor, loc_targets: torch.Tensor,
             neg_ratio: float = 3.0) -> torch.Tensor:
    """BCE confidence loss with hard-negative mining plus a smooth-L1 loc
    loss, per image over its positives.

    frames float [B, 300, 300, 3] (already mean-subtracted); labels [B, A]
    in {0, 1}; loc_targets [B, A, 4] encoded offsets.  The negatives kept
    are the ``neg_ratio * n_pos`` with the largest BCE, ranked by a stable
    sort as ``jnp.argsort`` ranks them, so tied logits keep the lower anchor
    index; positives rank last."""
    loc, conf = model(frames)
    pos = labels > 0.5
    n_pos = torch.clamp(pos.sum(dim=1), min=1)
    # maximum, not clamp: at a logit of exactly 0 both libraries give max half the gradient
    bce = torch.maximum(conf, torch.zeros_like(conf)) - conf * labels + torch.log1p(torch.exp(-conf.abs()))
    neg_bce = torch.where(pos, float("-inf"), bce.detach())
    order = torch.sort(-neg_bce, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(order.shape[1], device=order.device)
                                            .expand_as(order))
    keep_neg = rank < (neg_ratio * n_pos)[:, None]
    conf_loss = torch.where(pos | keep_neg, bce, 0.0).sum(dim=1) / n_pos

    diff = (loc - loc_targets).abs()
    smooth_l1 = torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5)
    loc_loss = torch.where(pos[..., None], smooth_l1, 0.0).sum(dim=(1, 2)) / n_pos
    return (conf_loss + loc_loss).mean()


def make_train_step(lr: float = 1e-3):
    """-> ``(step, init_opt)``: ``init_opt(model)`` is ``torch.optim.Adam``
    (b1 0.9, b2 0.999, eps 1e-8 outside the square root, as ``optax.adam``)
    and ``step(model, opt, frames, labels, loc_targets)`` updates ``model``
    in place and returns the loss before the update."""
    return functools.partial(adam_step, ssd_loss), functools.partial(adam, lr=lr)
