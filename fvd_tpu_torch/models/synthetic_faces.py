"""Procedural face dataset for training the SSD detector and the hourglass:
the counterpart of ``fvd_tpu/models/synthetic_faces.py``'s ``render_face``,
``detector_batch`` and ``landmark_batch``, drawn with numpy
(:mod:`fvd_tpu_torch.utils.draw`, :mod:`fvd_tpu_torch.utils.cv`) where the
JAX package calls OpenCV.

Every random draw comes in the JAX package's order, so one
``np.random.RandomState`` gives the same faces, boxes, landmarks, anchor
labels and offsets, and leaves the same state behind.  The pixels differ
along the outlines of the drawn shapes (see :mod:`fvd_tpu_torch.utils.draw`);
the warps and the resize are OpenCV's.

The realism levers of the JAX package (``photometric``, ``shaded``,
``portrait`` and the ``dense`` mixture) are not ported yet: asking for one
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from fvd_tpu_torch.models.face_ssd import MEAN_RGB, anchors
from fvd_tpu_torch.ops import detection
from fvd_tpu_torch.synthetic import TEMPLATE_68, draw_face
from fvd_tpu_torch.utils import cv, draw

__all__ = ["TEMPLATE_68", "draw_face", "render_face", "detector_batch", "landmark_batch"]

#: where the realism levers wait in ROADMAP.md
LEVERS_TODO = "ROADMAP.md section 1 item 9 (the realism levers)"


def refuse_levers(**flags) -> None:
    """Raise for a realism lever that is asked for: the port does not draw
    them yet, and ignoring one would train on other data than asked."""
    asked = sorted(name for name, on in flags.items() if on)
    if asked:
        raise NotImplementedError(f"{', '.join(asked)}: not ported yet, see {LEVERS_TODO}")


def render_face(
    rng: np.random.RandomState, size: int = 300, aperture: float | None = None,
    augment: bool = False, hard: bool = False, photometric: bool = False,
    shaded: bool = False, portrait: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (image uint8 [size, size, 3], gt box [4] normalized corners,
    landmarks [68, 2] in pixels).

    ``augment``: backgrounds of three kinds, wider face shapes and skins,
    accessory strokes, occluders, an in-plane rotation (landmarks and box
    follow) and a gain and bias.  ``hard`` (implies ``augment``): the
    accessories at p 0.9, more occluders and a wider rotation in one
    sample."""
    refuse_levers(photometric=photometric, shaded=shaded, portrait=portrait)
    if hard:
        augment = True
    bg = (rng.uniform(0.3, 0.6) if hard else rng.rand()) if augment else 1.0
    if bg < 0.3:
        # smooth gradient over a solid colour, materialised at full width
        base = rng.rand(3) * 200
        ramp = np.linspace(0, rng.uniform(0, 90), size)
        img = np.clip(base[None, None] + ramp[:, None, None], 0, 255).astype(np.uint8)
        img = np.ascontiguousarray(np.broadcast_to(img, (size, size, 3)))
    elif bg < 0.6:
        # sinusoidal stripes at a random orientation, frequency and contrast
        # over a gradient
        base = rng.rand(3) * 180
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        th = rng.uniform(0, np.pi)
        phase = xx * np.cos(th) + yy * np.sin(th)
        stripes = rng.uniform(10, 45) * np.sin(phase / rng.uniform(4, 24))
        grad = (yy / size) * rng.uniform(0, 90)
        img = np.clip(base[None, None] + (stripes + grad)[..., None], 0, 255).astype(np.uint8)
        img = np.ascontiguousarray(img)
    else:
        # blurred noise texture
        img = cv.blur_u8((rng.rand(size, size, 3) * 60 + rng.rand(3) * 120).astype(np.uint8), 5)

    if augment:
        fw = rng.uniform(0.22, 0.62) * size
        fh = fw * rng.uniform(1.0, 1.6)
        skin = np.array([rng.randint(130, 250), rng.randint(95, 210), rng.randint(75, 200)])
    else:
        fw = rng.uniform(0.25, 0.6) * size
        fh = fw * rng.uniform(1.1, 1.4)
        skin = np.array([rng.randint(160, 230), rng.randint(120, 190), rng.randint(100, 170)])
    cx = rng.uniform(fw / 2 + 2, size - fw / 2 - 2)
    cy = rng.uniform(fh / 2 + 2, size - fh / 2 - 2)
    pts = draw_face(img, cx, cy, fw, fh, skin, aperture)

    if augment:
        # face-anchored accessory strokes: eye rings and a bridge bar, a crown arc
        stroke = tuple(int(c) for c in (skin * rng.uniform(0.15, 0.6)))
        p_acc = 0.9 if hard else 0.4
        if rng.rand() < p_acc:
            for exc in (-0.2, 0.2):
                c = (int(cx + exc * fw), int(cy - 0.12 * fh))
                radius = max(2, int(fw * rng.uniform(0.08, 0.16)))
                draw.circle(img, c, radius, stroke, rng.randint(1, 4))
            draw.line(img, (int(cx - 0.2 * fw), int(cy - 0.12 * fh)),
                      (int(cx + 0.2 * fw), int(cy - 0.12 * fh)), rng.randint(1, 4), stroke)
        if rng.rand() < p_acc:
            _crown(img, cx, cy, fw, fh, stroke, rng)
        _occluders(img, rng, size, rng.randint(1, 4) if hard else rng.randint(0, 3))
        # in-plane rotation (landmarks and box follow)
        angle = rng.uniform(-20, 20) if hard else rng.uniform(-15, 15)
        M = cv.rotation_matrix_2d((cx, cy), angle, 1.0)
        img = cv.warp_affine_u8(img, M, size, size)
        pts = (pts @ M[:, :2].T + M[:, 2]).astype(np.float32)
        gain = rng.uniform(0.7, 1.3)
        bias = rng.uniform(-25, 25)
        img = np.clip(img.astype(np.float32) * gain + bias, 0, 255).astype(np.uint8)
        # gt box: the exact bounding box of the rotated face ellipse
        th = np.deg2rad(angle)
        a, b = fw / 2.0, fh / 2.0
        hw = float(np.sqrt((a * np.cos(th)) ** 2 + (b * np.sin(th)) ** 2))
        hh = float(np.sqrt((a * np.sin(th)) ** 2 + (b * np.cos(th)) ** 2))
        box = np.array([(cx - hw) / size, (cy - hh) / size,
                        (cx + hw) / size, (cy + hh) / size], np.float32)
        return img, np.clip(box, 0.0, 1.0), pts

    x1, y1 = cx - fw / 2, cy - fh / 2
    box = np.array([x1 / size, y1 / size, (x1 + fw) / size, (y1 + fh) / size], np.float32)
    return img, box, pts


def _crown(img, cx, cy, fw, fh, stroke, rng) -> None:
    """A filled upper half-ellipse over the crown (hair- or hat-like)."""
    center = (int(cx), int(cy - rng.uniform(0.0, 0.2) * fh))
    axes = (int(fw * rng.uniform(0.4, 0.62)), int(fh * rng.uniform(0.35, 0.55)))
    draw.fill_ellipse(img, center, axes, stroke, 0, 180, 360)


def _occluders(img, rng, size: int, count: int) -> None:
    """``count`` random filled rectangles and rotated ellipses."""
    for _ in range(count):
        color = tuple(int(c) for c in rng.randint(0, 255, 3))
        p = (rng.randint(0, size), rng.randint(0, size))
        if rng.rand() < 0.5:
            q = (p[0] + rng.randint(5, size // 4), p[1] + rng.randint(3, size // 6))
            draw.fill_rectangle(img, p, q, color)
        else:
            axes = (rng.randint(4, size // 6), rng.randint(3, size // 8))
            draw.fill_ellipse(img, p, axes, color, rng.uniform(0, 180))


def detector_batch(rng: np.random.RandomState, batch: int, size: int = 300,
                   augment: bool = False, photometric: bool = False,
                   dense: bool = False, shaded: bool = False,
                   portrait: bool = False):
    """Training batch for the SSD: (frames float32 [B, size, size, 3] less
    ``MEAN_RGB``, anchor labels [B, A], encoded loc targets [B, A, 4], gt
    boxes [B, 4]).  ``augment`` renders the even samples augmented, every
    fourth one ``hard``."""
    refuse_levers(photometric=photometric, dense=dense, shaded=shaded, portrait=portrait)
    A = anchors()
    frames = np.zeros((batch, size, size, 3), np.float32)
    labels = np.zeros((batch, A.shape[0]), np.float32)
    locs = np.zeros((batch, A.shape[0], 4), np.float32)
    boxes_out = []
    for i in range(batch):
        img, box, _ = render_face(rng, size, augment=augment and i % 2 == 0, hard=augment and i % 4 == 0)
        frames[i] = img.astype(np.float32) - np.asarray(MEAN_RGB)
        lab, matched = detection.match_anchors(box[None], A)
        enc = np.array(detection.encode_boxes(matched, A))
        enc[lab == 0] = 0
        labels[i] = lab
        locs[i] = enc
        boxes_out.append(box)
    return frames, labels, locs, np.stack(boxes_out)


def landmark_batch(rng: np.random.RandomState, batch: int, crop: int = 128,
                   augment: bool = False, photometric: bool = False,
                   shaded: bool = False, hard_half: bool = False,
                   portrait: bool = False):
    """Training batch for the hourglass: (crops float32 [B, crop, crop, 3] in
    0..1, targets [B, 68, 2] in [0, 1]): faces with a random mouth aperture,
    cropped around the gt box with jitter.  ``augment`` renders the even
    samples augmented, every fourth one ``hard``, or all of them with
    ``hard_half``."""
    refuse_levers(photometric=photometric, shaded=shaded, portrait=portrait)
    crops = np.zeros((batch, crop, crop, 3), np.float32)
    targets = np.zeros((batch, 68, 2), np.float32)
    size = 256
    for i in range(batch):
        aug_i = augment and i % 2 == 0
        img, box, pts = render_face(rng, size, aperture=rng.uniform(0.0, 1.0), augment=aug_i,
                                    hard=aug_i if hard_half else (augment and i % 4 == 0))
        x1, y1, x2, y2 = (box * size).astype(int)
        jx = int(rng.uniform(-0.05, 0.05) * (x2 - x1))
        jy = int(rng.uniform(-0.05, 0.05) * (y2 - y1))
        cx1, cy1 = max(0, x1 + jx), max(0, y1 + jy)
        cx2, cy2 = min(size, x2 + jx), min(size, y2 + jy)
        sub = img[cy1:cy2, cx1:cx2]
        if sub.size == 0:
            sub = img
            cx1 = cy1 = 0
            cx2 = cy2 = size
        crops[i] = cv.resize_linear_u8(sub, crop, crop).astype(np.float32) / 255.0
        targets[i, :, 0] = (pts[:, 0] - cx1) / max(cx2 - cx1, 1)
        targets[i, :, 1] = (pts[:, 1] - cy1) / max(cy2 - cy1, 1)
    return crops, np.clip(targets, 0.0, 1.0)
