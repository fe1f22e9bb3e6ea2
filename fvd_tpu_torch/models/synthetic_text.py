"""Procedural text for OCR pretraining: the counterpart of
``fvd_tpu/models/synthetic_text.py``, drawn with numpy where the JAX package
calls OpenCV.

Strings on textured backgrounds with known content and boxes train the CTC
recognizer to read and the region detector to localize.  The text is OpenCV
5's (:mod:`fvd_tpu_torch.utils.text`: the same sizes, glyphs and
placement), the blurs, warps, morphology, resize and grey conversion are
OpenCV's bit for bit (:mod:`fvd_tpu_torch.utils.cv`).  Every random draw
comes in the JAX package's order, so one ``np.random.RandomState`` gives the
same strings, labels, masks and lines, and leaves the same state behind.
"""

from __future__ import annotations

import string
from typing import List, Tuple

import numpy as np

from fvd_tpu_torch.models.ocr import DET_SIZE, LINE_H, LINE_W, encode_ctc_labels
from fvd_tpu_torch.utils import cv
from fvd_tpu_torch.utils import text as T

#: Training alphabet: uppercase + digits + space (broadcast-overlay style)
ALPHABET = string.ascii_uppercase + string.digits + " "
#: the faces augmented training draws; the held-out faces of
#: ``tools/eval_heldout.py`` (DUPLEX, COMPLEX, TRIPLEX, SIMPLEX | ITALIC) stay out
TRAIN_FONTS = (T.FONT_HERSHEY_SIMPLEX, T.FONT_HERSHEY_PLAIN, T.FONT_HERSHEY_COMPLEX_SMALL,
               T.FONT_HERSHEY_SCRIPT_SIMPLEX, T.FONT_HERSHEY_PLAIN | T.FONT_ITALIC,
               T.FONT_HERSHEY_COMPLEX_SMALL | T.FONT_ITALIC)


def random_text(rng: np.random.RandomState, min_len=3, max_len=12) -> str:
    n = rng.randint(min_len, max_len + 1)
    return "".join(ALPHABET[rng.randint(len(ALPHABET))] for _ in range(n)).strip() or "A"


def _train_font(rng: np.random.RandomState) -> int:
    """A font face for augmented training renders (never a held-out one)."""
    return int(TRAIN_FONTS[rng.randint(len(TRAIN_FONTS))])


def _augment_line(rng: np.random.RandomState, line: np.ndarray) -> np.ndarray:
    """Font-agnostic shape/photometric jitter on a [H, W] float 0..1 line:
    shear (slant), stroke-width morphology, blur, contrast/gamma, noise."""
    h, w = line.shape[:2]
    img = line[..., 0] if line.ndim == 3 else line
    if rng.rand() < 0.7:  # horizontal shear: italic-like slant
        s = rng.uniform(-0.25, 0.25)
        m = np.float32([[1, s, -s * h / 2], [0, 1, 0]])
        img = cv.warp_affine_f32(img, m, w, h)
    if rng.rand() < 0.5:  # stroke width: dilate or erode one step
        img = cv.dilate2_f32(img) if rng.rand() < 0.5 else cv.erode2_f32(img)
    if rng.rand() < 0.5:
        img = cv.gaussian_blur_f32(img, 3, rng.uniform(0.3, 1.0))
    if rng.rand() < 0.5:  # contrast/gamma jitter
        img = np.clip(img ** rng.uniform(0.7, 1.4) * rng.uniform(0.8, 1.2), 0, 1)
    if rng.rand() < 0.3:
        img = np.clip(img + rng.randn(h, w).astype(np.float32) * 0.03, 0, 1)
    return img.astype(np.float32)[..., None]


def render_line(rng: np.random.RandomState, text: str, font: int | None = None) -> np.ndarray:
    """One text line -> float [LINE_H, LINE_W, 1] in 0..1: the text at a
    random scale and thickness, its tight region resized to the recognizer's
    line shape (the stretch statistics of the detector's region boxes)."""
    if font is None:
        font = T.FONT_HERSHEY_SIMPLEX
    scale = rng.uniform(0.45, 1.6)
    thickness = int(rng.randint(1, 4))
    (tw, th), baseline = T.get_text_size(text, font, scale, thickness)
    mx, my = int(rng.randint(1, 8)), int(rng.randint(1, 8))
    h, w = th + baseline + 2 * my, tw + 2 * mx
    img = np.full((h, w), int(rng.randint(0, 80)), np.uint8)
    img = img + rng.randint(0, 25, img.shape).astype(np.uint8)
    color = int(rng.randint(180, 255))
    T.put_text(img, text, (mx, my + th), font, scale, color, thickness)
    img = cv.resize_linear_u8(img, LINE_W, LINE_H)
    return img.astype(np.float32)[..., None] / 255.0


def _fit_text(text: str, font: int, rng: np.random.RandomState):
    """Scale and thickness drawn for a detector-style scene, the scale cut
    so that the text fits the frame -> (scale, thickness, (tw, th), baseline)."""
    scale = rng.uniform(0.4, 1.4)
    thickness = int(rng.randint(1, 4))
    (tw, th), baseline = T.get_text_size(text, font, scale, thickness)
    if tw >= DET_SIZE - 6:
        scale *= (DET_SIZE - 8) / tw
        (tw, th), baseline = T.get_text_size(text, font, scale, thickness)
    return scale, thickness, (tw, th), baseline


def _scene_background(rng: np.random.RandomState) -> np.ndarray:
    return cv.blur_u8((rng.rand(DET_SIZE, DET_SIZE, 3) * 90).astype(np.uint8), 5)


def scene_crop_line(rng: np.random.RandomState, text: str, font: int | None = None) -> np.ndarray:
    """``text`` in a detector-style scene, cropped the way
    ``read_text_batch`` crops: region box (with detector-like jitter of
    every edge) -> grey -> the recognizer's line shape.  ``font``: a face
    override (training draws SIMPLEX; ``eval_heldout`` passes held-out
    faces)."""
    if font is None:
        font = T.FONT_HERSHEY_SIMPLEX
    scale, thickness, (tw, th), baseline = _fit_text(text, font, rng)
    img = _scene_background(rng)
    x = rng.randint(2, max(3, DET_SIZE - tw - 2))
    y = rng.randint(th + 2, DET_SIZE - baseline - 2)
    color = tuple(int(c) for c in rng.randint(170, 255, 3))
    T.put_text(img, text, (x, y), font, scale, color, thickness)
    x1 = max(0, x - 2 + rng.randint(-3, 4))
    y1 = max(0, y - th - 2 + rng.randint(-3, 4))
    x2 = min(DET_SIZE, x + tw + 2 + rng.randint(-3, 4))
    y2 = min(DET_SIZE, y + baseline + 2 + rng.randint(-3, 4))
    if x2 - x1 < 4 or y2 - y1 < 4:
        x1, y1 = max(0, x - 2), max(0, y - th - 2)
        x2, y2 = min(DET_SIZE, x + tw + 2), min(DET_SIZE, y + baseline + 2)
    line = cv.resize_linear_u8(cv.rgb_to_gray_u8(img[y1:y2, x1:x2]), LINE_W, LINE_H)
    return line.astype(np.float32)[..., None] / 255.0


def recognizer_batch(rng: np.random.RandomState, batch: int, augment: bool = False):
    """(lines float [B, 32, 256, 1], labels [B, 32] int32, texts): half
    :func:`render_line` strips, half :func:`scene_crop_line` crops (long
    chyron-length strings included).  ``augment``: every odd item draws a
    training face (:func:`_train_font`) and goes through
    :func:`_augment_line`."""
    lines = np.zeros((batch, LINE_H, LINE_W, 1), np.float32)
    labels = np.zeros((batch, 32), np.int32)
    texts: List[str] = []
    for i in range(batch):
        aug = augment and i % 2 == 1
        font = _train_font(rng) if aug else None
        if i % 4 < 2:
            text = random_text(rng)
            lines[i] = render_line(rng, text, font=font)
        else:
            text = random_text(rng, 4, 18)
            lines[i] = scene_crop_line(rng, text, font=font)
        if aug:
            lines[i] = _augment_line(rng, lines[i])
        labels[i] = encode_ctc_labels(text)
        texts.append(text)
    return lines, labels, texts


def detector_sample(rng: np.random.RandomState, augment: bool = False,
                    font: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """One detection image: RGB uint8 [DET_SIZE, DET_SIZE, 3] with 1-3 text
    strips, and its text mask [DET_SIZE, DET_SIZE] float.  ``augment``: each
    strip in a training face; ``font``: every strip in this face (wins over
    ``augment``)."""
    img = _scene_background(rng)
    mask = np.zeros((DET_SIZE, DET_SIZE), np.float32)
    for _ in range(rng.randint(1, 4)):
        text = random_text(rng, 4, 14)
        strip_font = font if font is not None else (_train_font(rng) if augment else T.FONT_HERSHEY_SIMPLEX)
        scale, thickness, (tw, th), baseline = _fit_text(text, strip_font, rng)
        x = rng.randint(2, max(3, DET_SIZE - tw - 2))
        y = rng.randint(th + 2, DET_SIZE - baseline - 2)
        color = tuple(int(c) for c in rng.randint(170, 255, 3))
        T.put_text(img, text, (x, y), strip_font, scale, color, thickness)
        mask[max(0, y - th - 2): min(DET_SIZE, y + baseline + 2),
             max(0, x - 2): min(DET_SIZE, x + tw + 2)] = 1.0
    return img, mask


def detector_batch(rng: np.random.RandomState, batch: int, augment: bool = False):
    """(images float [B, 256, 256, 3] in 0..1, masks [B, 256, 256]); every
    odd sample ``augment``-ed."""
    imgs = np.zeros((batch, DET_SIZE, DET_SIZE, 3), np.float32)
    masks = np.zeros((batch, DET_SIZE, DET_SIZE), np.float32)
    for i in range(batch):
        img, mask = detector_sample(rng, augment=augment and i % 2 == 1)
        imgs[i] = img.astype(np.float32) / 255.0
        masks[i] = mask
    return imgs, masks
