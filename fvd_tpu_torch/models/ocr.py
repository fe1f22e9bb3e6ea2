"""OCR: text-region detector + CTC recognizer: the counterpart of
``fvd_tpu/models/ocr.py``.

Role (SURVEY §2.4): EasyOCR's CRAFT detector + CRNN recognizer in V2
(``v2_ocr_overlays.py:31-44``).

* :class:`TextRegionNet` (v1) and :class:`TextRegionNetV2` produce a
  per-pixel text logit map; region boxes come from connected components of
  the thresholded map on the host (:func:`region_boxes`);
* :class:`CTCRecognizer` reads a fixed-size grey line crop into per-step
  class logits, decoded greedily (:func:`ctc_greedy_decode`);
* :class:`JaxOCR` composes the two with the EasyOCR output schema
  ``{text, confidence, bbox}``, detecting either from host frames
  (:meth:`JaxOCR.read_text_batch`) or from the frame tensor V1 already put on
  the device (:meth:`JaxOCR.read_text_batch_device`).

The modules take NHWC input as the flax ones do and name their submodules
after the flax auto-names, so the npz checkpoints load through
:mod:`fvd_tpu_torch.weights`.  The v2 detector computes in bfloat16 whatever
the caller's dtype, as its flax module does (``dtype=jnp.bfloat16``), adding
each conv's bias after the conv's rounding as flax does; the v1 detector and
the recognizer compute in float32.  :func:`ctc_loss` is the recognizer's
training loss and :func:`detector_loss` the detectors'.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch import weights as weights_mod
from fvd_tpu_torch.models.layers import SameConv2d, conv_in_dtype
from fvd_tpu_torch.ops.image import resize
from fvd_tpu_torch.parallel.inference import shard_for_inference

LINE_H, LINE_W = 32, 256
DET_SIZE = 256
#: CTC vocabulary: blank(0) + printable ASCII 32..126
CTC_BLANK = 0
CTC_VOCAB = [chr(c) for c in range(32, 127)]
CTC_CLASSES = len(CTC_VOCAB) + 1


def _pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def _up2(x: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` to exactly twice the size: a repeat."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class TextRegionNet(nn.Module):
    """The v1 U-Net: float NHWC [B, H, W, 3] in 0..1 -> logits [B, H, W]."""

    def __init__(self, width: int = 16):
        super().__init__()
        w = width
        self.Conv_0 = SameConv2d(3, w, 3)
        self.Conv_1 = SameConv2d(w, 2 * w, 3)
        self.Conv_2 = SameConv2d(2 * w, 4 * w, 3)
        self.Conv_3 = SameConv2d(6 * w, 2 * w, 3)
        self.Conv_4 = SameConv2d(3 * w, w, 3)
        self.Conv_5 = SameConv2d(w, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        d1 = F.relu(self.Conv_0(x))
        d2 = F.relu(self.Conv_1(_pool2(d1)))
        d3 = F.relu(self.Conv_2(_pool2(d2)))
        u2 = F.relu(self.Conv_3(torch.cat([_up2(d3), d2], dim=1)))
        u1 = F.relu(self.Conv_4(torch.cat([_up2(u2), d1], dim=1)))
        return self.Conv_5(u1)[:, 0]


class TextRegionNetV2(nn.Module):
    """The v2 U-Net (space-to-depth 4x4 input, bf16 convs at 128/256
    channels, a depth-to-space head): float NHWC [B, H, W, 3] in 0..1, H and
    W multiples of 16 -> float32 logits [B, H, W].

    ``compute_dtype`` is flax's ``dtype=jnp.bfloat16``: the input and each
    conv's weights are cast to it inside the forward, differentiably, so
    training updates the float32 parameters as optax does.  Another dtype
    (float64 for parity checks) computes the same graph in it."""

    def __init__(self, width: int = 128, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        w = width
        self.compute_dtype = compute_dtype
        self.Conv_0 = SameConv2d(48, w, 3)
        self.Conv_1 = SameConv2d(w, 2 * w, 3)
        self.Conv_2 = SameConv2d(2 * w, 2 * w, 3)
        self.Conv_3 = SameConv2d(4 * w, w, 3)
        self.Conv_4 = SameConv2d(2 * w, w, 3)
        self.Conv_5 = SameConv2d(w, 16, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, wd, c = x.shape
        x = x.to(self.compute_dtype)
        # space-to-depth: channel (dy, dx, c), as the flax reshape/transpose
        x = x.reshape(b, h // 4, 4, wd // 4, 4, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h // 4, wd // 4, 16 * c)
        x = x.permute(0, 3, 1, 2)
        d1 = F.relu(conv_in_dtype(self.Conv_0, x))                                   # H/4, w
        d2 = F.relu(conv_in_dtype(self.Conv_1, _pool2(d1)))                          # H/8, 2w
        d3 = F.relu(conv_in_dtype(self.Conv_2, _pool2(d2)))                          # H/16, 2w
        u2 = F.relu(conv_in_dtype(self.Conv_3, torch.cat([_up2(d3), d2], dim=1)))    # H/8, w
        u1 = F.relu(conv_in_dtype(self.Conv_4, torch.cat([_up2(u2), d1], dim=1)))    # H/4, w
        out = conv_in_dtype(self.Conv_5, u1)                                         # 4x4 subpixels
        out = out.to(torch.promote_types(out.dtype, torch.float32))
        out = out.permute(0, 2, 3, 1).reshape(b, h // 4, wd // 4, 4, 4)
        return out.permute(0, 1, 3, 2, 4).reshape(b, h, wd)


DET_ARCHS = {"v1": TextRegionNet, "v2": TextRegionNetV2}
DET_DEFAULT_WIDTH = {"v1": 16, "v2": 128}


class CTCRecognizer(nn.Module):
    """float NHWC [B, 32, 256, 1] in 0..1 -> logits [B, T=64, classes]."""

    def __init__(self, width: int = 32):
        super().__init__()
        w = width
        self.Conv_0 = SameConv2d(1, w, 3)
        self.Conv_1 = SameConv2d(w, 2 * w, 3)
        self.Conv_2 = SameConv2d(2 * w, 4 * w, 3)
        self.Dense_0 = nn.Linear(4 * w * (LINE_H // 8), 4 * w)
        self.Dense_1 = nn.Linear(4 * w, CTC_CLASSES)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = _pool2(F.relu(self.Conv_0(x)))                  # 16 x 128
        x = _pool2(F.relu(self.Conv_1(x)))                  # 8 x 64
        x = F.max_pool2d(F.relu(self.Conv_2(x)), (2, 1), (2, 1))   # 4 x 64
        b, c, h, t = x.shape
        # time-major features in flax's (h, c) order per step
        x = x.permute(0, 3, 2, 1).reshape(b, t, h * c)
        return self.Dense_1(F.relu(self.Dense_0(x)))


def ctc_greedy_decode(logits: np.ndarray) -> List[str]:
    """Collapse repeats + drop blanks."""
    out = []
    for row in np.argmax(logits, axis=-1):
        chars = []
        prev = -1
        for k in row:
            if k != prev and k != CTC_BLANK:
                chars.append(CTC_VOCAB[k - 1])
            prev = k
        out.append("".join(chars))
    return out


def encode_ctc_labels(text: str, max_len: int = 32) -> np.ndarray:
    ids = [CTC_VOCAB.index(c) + 1 for c in text if c in CTC_VOCAB][:max_len]
    out = np.zeros(max_len, np.int32)
    out[: len(ids)] = ids
    return out


def ctc_loss(model: CTCRecognizer, images: torch.Tensor, labels: torch.Tensor, label_pad: int = 0) -> torch.Tensor:
    """Mean CTC negative log-likelihood of ``labels`` [B, N] (left-aligned,
    padded with ``label_pad``) under the recognizer's logits, with
    ``optax.ctc_loss``'s semantics: blank 0, every one of the T logit frames
    valid.  Where no alignment exists (more labels and repeats than frames)
    ``optax`` gives a large finite value, from its ``log_epsilon`` of -1e5
    in place of log 0, and this gives ``inf``."""
    logits = model(images)                                   # [B, T, K]
    logp = torch.log_softmax(logits, dim=-1).transpose(0, 1)  # [T, B, K]
    b, t = logits.shape[:2]
    target_lengths = (labels != label_pad).sum(dim=-1)
    input_lengths = torch.full((b,), t, dtype=torch.long, device=logits.device)
    nll = F.ctc_loss(logp, labels.long(), input_lengths, target_lengths, blank=CTC_BLANK, reduction="none")
    return nll.mean()


def detector_loss(model: nn.Module, images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Mean per-pixel binary cross-entropy of the detector's logits against
    the text ``masks`` [B, H, W], in the JAX tool's stable form
    ``max(z, 0) - z * m + log1p(exp(-|z|))``, with JAX's derivatives at
    ``z == 0`` (a pixel whose features are all dead has the bias alone for
    logit, 0 at the seeded init): ``jnp.maximum`` splits the gradient, as
    ``torch.maximum`` does, and ``jnp.abs`` takes slope 1 there, where
    ``torch.abs`` takes 0."""
    z = model(images)
    abs_z = torch.where(z >= 0, z, -z)
    return (torch.maximum(z, torch.zeros_like(z)) - z * masks + torch.log1p(torch.exp(-abs_z))).mean()


@torch.no_grad()
def detect_forward(model: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """Text probability map [B, H, W] of uint8 or 0..1 float NHWC images."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    return torch.sigmoid(model(images))


@torch.no_grad()
def detect_packed_mask(model: nn.Module, frames_u8: torch.Tensor, thr_logit: float = 0.0) -> torch.Tensor:
    """Device-resident detection: native uint8 frames [B, H, W, 3] -> the
    boolean text mask [B, 256, 256] on the frames' device.

    Consumes the frame tensor V1 already uploaded (no second host-to-device
    copy), resizes to the detector grid there with ``jax.image``'s linear
    rule, and thresholds in logit space (``sigmoid(z) > t <=> z >
    logit(t)``).  The JAX package packs the mask into bits to shrink its
    fetch; the port fetches the boolean mask, the same masks."""
    x = frames_u8.float() / 255.0
    x = resize(x, (DET_SIZE, DET_SIZE), antialias=False)
    return model(x) > thr_logit


@torch.no_grad()
def recognize_forward(model: CTCRecognizer, lines: torch.Tensor) -> torch.Tensor:
    """CTC logits of uint8 or 0..1 float line crops [B, 32, 256, 1]."""
    if lines.dtype == torch.uint8:
        lines = lines.float() / 255.0
    return model(lines)


def _from_params(model: nn.Module, params: Mapping, device) -> nn.Module:
    model.load_state_dict(weights_mod.to_state_dict(params), strict=True)
    return model.eval().to(device)


def load_detector(ckpt_path: str, device=None) -> Tuple[nn.Module, int, str]:
    """-> (model, width, arch) from an ``ocr_det.npz`` checkpoint and its
    sidecar json ({"arch": "v2", "width": 128}; absent sidecar = the v1/16
    legacy layout)."""
    arch, width = "v1", 16
    sidecar = ckpt_path.replace(".npz", ".json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
        arch = meta.get("arch", "v1")
        width = int(meta.get("width", DET_DEFAULT_WIDTH[arch]))
    model = _from_params(DET_ARCHS[arch](width=width), weights_mod.read_npz(ckpt_path),
                         resolve_device(device))
    return model, width, arch


def load_recognizer(ckpt_path: str, width: int = 32, device=None) -> CTCRecognizer:
    return _from_params(CTCRecognizer(width=width), weights_mod.read_npz(ckpt_path), resolve_device(device))


def region_boxes(prob_map: np.ndarray, threshold: float = 0.5, min_area: int = 16):
    """Connected components of the thresholded text map -> pixel boxes."""
    from fvd_tpu_torch.utils.cv import component_boxes

    mask = (np.asarray(prob_map) > threshold).astype(np.uint8)
    return [(x, y, w, h) for x, y, w, h, area in component_boxes(mask) if area >= min_area]


class JaxOCR:
    """OCRProvider: detector + recognizer, EasyOCR-shaped output, on
    ``device`` (default the card)."""

    model_name = "fvd_tpu_ocr"
    #: device-forward provider: eligible for cross-video coalescing
    coalescable = True

    def __init__(self, detector: nn.Module, recognizer: CTCRecognizer, det_width: int = 16,
                 rec_width: int = 32, region_threshold: float = 0.5, det_arch: str = "v1",
                 device=None):
        self.device = resolve_device(device)
        self.detector = detector.to(self.device)
        self.recognizer = recognizer.to(self.device)
        self.det_width = det_width
        self.det_arch = det_arch
        self.rec_width = rec_width
        self.region_threshold = region_threshold

    @classmethod
    def from_checkpoints(cls, det_ckpt: str, rec_ckpt: str, device=None) -> "JaxOCR":
        """The detector of ``det_ckpt`` (arch and width from its sidecar) and
        the width-32 recognizer of ``rec_ckpt``."""
        dev = resolve_device(device)
        detector, det_width, det_arch = load_detector(det_ckpt, dev)
        return cls(detector, load_recognizer(rec_ckpt, 32, dev), det_width=det_width,
                   det_arch=det_arch, device=dev)

    def read_text(self, image: np.ndarray) -> List[Dict[str, Any]]:
        return self.read_text_batch([image])[0]

    def read_text_batch(self, images) -> List[List[Dict[str, Any]]]:
        """All frames in two forwards: the detector over the frame batch,
        resized on the host as the JAX package does (OpenCV's linear rule) and
        split over the inference mesh where one is installed, and the recognizer over every region crop of every frame."""
        from fvd_tpu_torch.utils.cv import resize_linear_u8

        if len(images) == 0:
            return []
        det_in = np.stack([resize_linear_u8(im, DET_SIZE, DET_SIZE) for im in images])
        probs = shard_for_inference(detect_forward, self.detector,
                                    torch.from_numpy(det_in).to(self.device)).cpu().numpy()
        masks = (probs > self.region_threshold).astype(np.uint8)
        return self._recognize_regions(images, masks)

    def read_text_batch_device(self, dev_frames: torch.Tensor, images) -> List[List[Dict[str, Any]]]:
        """Detection from the device-resident native frames ``dev_frames``
        (see :func:`detect_packed_mask`): no frame re-upload.  ``images``
        supplies the host pixels for line crops (the host frame cache already
        holds them)."""
        if len(images) == 0:
            return []
        thr = float(self.region_threshold)
        thr_logit = float(np.log(thr / (1.0 - thr)))
        masks = detect_packed_mask(self.detector, dev_frames, thr_logit).cpu().numpy()
        return self._recognize_regions(images, masks[: len(images)].astype(np.uint8))

    def _recognize_regions(self, images, masks) -> List[List[Dict[str, Any]]]:
        """Shared tail: connected components -> line crops -> one bucketed
        recognizer forward -> greedy CTC decode."""
        from fvd_tpu_torch.utils.cv import resize_linear_u8, rgb_to_gray_u8

        lines: List[np.ndarray] = []
        line_meta: List[tuple] = []  # (frame index, pixel box)
        for fi, (image, mask) in enumerate(zip(images, masks)):
            if not mask.any():  # no text: skip connected-components + crops
                continue
            h, w = image.shape[:2]
            sx, sy = w / DET_SIZE, h / DET_SIZE
            for (x, y, bw, bh) in region_boxes(mask):
                px, py = int(x * sx), int(y * sy)
                pw, ph = max(1, int(bw * sx)), max(1, int(bh * sy))
                crop = image[py: py + ph, px: px + pw]
                if crop.size == 0:
                    continue
                lines.append(resize_linear_u8(rgb_to_gray_u8(crop), LINE_W, LINE_H))
                line_meta.append((fi, (px, py, pw, ph)))

        out: List[List[Dict[str, Any]]] = [[] for _ in images]
        if not lines:
            return out
        # the JAX package's power-of-two batch bucket (at least 8)
        n_lines = len(lines)
        bucket = 1 << max(3, (n_lines - 1).bit_length())
        batch = np.zeros((bucket, LINE_H, LINE_W), np.uint8)
        batch[:n_lines] = np.stack(lines)  # uint8: /255 happens on the device
        logits = recognize_forward(self.recognizer, torch.from_numpy(batch).to(self.device)[..., None])
        logits = logits.cpu().numpy()[:n_lines]
        texts = ctc_greedy_decode(logits)
        # host-side softmax confidence (no extra device op)
        lse = np.log(np.sum(np.exp(logits - logits.max(-1, keepdims=True)), -1)) \
            + logits.max(-1, keepdims=False)
        confs = np.exp(logits.max(-1) - lse).mean(-1)
        for (fi, (px, py, pw, ph)), text, conf in zip(line_meta, texts, confs):
            if not text:
                continue
            out[fi].append(
                {
                    "text": text,
                    "confidence": float(conf),
                    "bbox": [[px, py], [px + pw, py], [px + pw, py + ph], [px, py + ph]],
                }
            )
        return out
