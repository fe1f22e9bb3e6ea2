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

The realism levers are the JAX package's too: :func:`face_shading_realism`
(``shaded``), :func:`photometric_randomize` (``photometric``, its motion blur
``cv2.filter2D`` and its JPEG round trip through
:mod:`fvd_tpu_torch.utils.jpeg`), :func:`portrait_realism` and
:func:`_clutter_background` (``portrait``) and ``detector_batch``'s
``dense`` mixture, with OpenCV's blurs and filters from
:mod:`fvd_tpu_torch.utils.cv`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from fvd_tpu_torch.models.face_ssd import MEAN_RGB, anchors
from fvd_tpu_torch.ops import detection
from fvd_tpu_torch.synthetic import TEMPLATE_68, draw_face
from fvd_tpu_torch.utils import cv, draw, jpeg

__all__ = ["TEMPLATE_68", "draw_face", "face_shading_realism", "photometric_randomize", "portrait_realism",
           "render_face", "detector_batch", "landmark_batch"]


def face_shading_realism(img: np.ndarray, cx: float, cy: float, fw: float,
                         fh: float, rng: np.random.RandomState) -> np.ndarray:
    """Shading inside the face ellipse (in place; the gt box does not move):
    a quadratic rim falloff and a directional light gradient, multiplicative
    skin mottling (blurred noise), an optional specular sheen, and a
    feathered edge that alpha-blends a blurred copy along the boundary."""
    h, w = img.shape[:2]
    mask = np.zeros((h, w), np.float32)
    draw.fill_ellipse(mask, (int(cx), int(cy)), (int(fw / 2), int(fh / 2)), 1.0)
    out = img.astype(np.float32)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # normalised elliptical radius^2 inside the face
    r2 = (((xx - cx) / max(fw / 2, 1)) ** 2
          + ((yy - cy) / max(fh / 2, 1)) ** 2)
    shade = 1.0 - rng.uniform(0.15, 0.45) * np.clip(r2, 0, 1)  # rim falloff
    th = rng.uniform(0, 2 * np.pi)
    direction = ((xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)) / max(fh, 1)
    shade *= 1.0 + rng.uniform(0.1, 0.35) * np.clip(direction, -0.6, 0.6)

    # low-frequency skin mottling
    k = int(max(fw, 8)) // 4 * 2 + 1
    mottle = cv.gaussian_blur_f32(rng.randn(h, w).astype(np.float32), k)
    mottle /= max(float(np.abs(mottle).max()), 1e-6)
    shade *= 1.0 + rng.uniform(0.04, 0.12) * mottle

    # specular sheen (forehead or nose tip)
    if rng.rand() < 0.6:
        sx = cx + rng.uniform(-0.15, 0.15) * fw
        sy = cy - rng.uniform(-0.1, 0.35) * fh
        sr = rng.uniform(0.08, 0.2) * fw
        shade += rng.uniform(0.1, 0.3) * np.exp(
            -(((xx - sx) ** 2 + (yy - sy) ** 2) / max(2 * sr * sr, 1)))

    out *= (1.0 + (shade - 1.0) * mask)[..., None]

    # feathered boundary: a blurred copy blended in along the edge band
    fk = max(3, int(fw * 0.04)) | 1
    soft_mask = cv.gaussian_blur_f32(mask, fk)
    edge = np.clip(4.0 * soft_mask * (1.0 - soft_mask), 0.0, 1.0)
    blurred = cv.gaussian_blur_f32(out, fk)
    out = out * (1.0 - edge[..., None]) + blurred * edge[..., None]

    np.clip(out, 0, 255, out=out)
    img[:] = out.astype(np.uint8)
    return img


def photometric_randomize(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Photometric domain randomisation (the gt box does not move): a
    directional lighting ramp, white-balance gains, a motion blur, sensor
    noise, a desaturation toward luma and a JPEG round trip at a random
    quality.  The arithmetic after the white balance is float64, as numpy
    promotes it in the JAX package."""
    size_h, size_w = img.shape[:2]
    out = img.astype(np.float32)
    if rng.rand() < 0.7:
        yy, xx = np.mgrid[0:size_h, 0:size_w].astype(np.float32)
        th = rng.uniform(0, 2 * np.pi)
        ramp = xx * np.cos(th) + yy * np.sin(th)
        lo, hi = float(ramp.min()), float(ramp.max())
        ramp = (ramp - lo) / max(hi - lo, 1e-6)
        out = out * (1.0 - rng.uniform(0.0, 0.5) * ramp[..., None])
    out = out * rng.uniform(0.85, 1.15, 3)[None, None]
    if rng.rand() < 0.4:
        # a one-row box kernel rotated about its centre
        k = int(rng.randint(3, 10))
        kern = np.zeros((k, k), np.float32)
        kern[k // 2, :] = 1.0
        rot = cv.rotation_matrix_2d((k / 2 - 0.5, k / 2 - 0.5), float(rng.uniform(0, 180)), 1.0)
        kern = cv.warp_affine_zero_f32(kern, rot, k, k)
        kern /= max(float(kern.sum()), 1e-6)
        out = cv.filter2d(out, kern)
    out = out + rng.randn(size_h, size_w, 3).astype(np.float32) * rng.uniform(0, 12)
    if rng.rand() < 0.3:
        luma = out @ np.array([0.299, 0.587, 0.114], np.float32)
        mix = rng.uniform(0.5, 1.0)
        out = out * (1 - mix) + luma[..., None] * mix
    img = np.clip(out, 0, 255).astype(np.uint8)
    if rng.rand() < 0.5:
        # the JAX package hands these RGB pixels to OpenCV as BGR: encode
        # and decode them in that order
        img = jpeg.decode_jpeg_color(jpeg.encode_jpeg(img[..., ::-1], quality=int(rng.randint(30, 92))))[..., ::-1]
    return np.ascontiguousarray(img)


def portrait_realism(img: np.ndarray, bg: np.ndarray, cx: float, cy: float,
                     fw: float, fh: float, rng: np.random.RandomState) -> np.ndarray:
    """Portrait structure (in place; the gt box stays the face ellipse): a
    tapered jaw carved back to the pre-face background ``bg``, a textured
    hair cap clipped to a wavy hairline, an occasional hat band, and eye
    whites, irises, pupils, socket arcs, a nose line with nostrils and a lip
    line."""
    size_h, size_w = img.shape[:2]
    if rng.rand() < 0.7:
        taper = rng.uniform(0.62, 0.88)
        face = np.zeros((size_h, size_w), np.uint8)
        draw.fill_ellipse(face, (int(cx), int(cy)), (int(fw / 2), int(fh / 2)), 1)
        head = np.zeros_like(face)
        draw.fill_ellipse(head, (int(cx), int(cy)), (int(fw / 2), int(fh / 2)), 1, 0, 180, 360)
        draw.fill_ellipse(head, (int(cx), int(cy)), (max(2, int(fw / 2 * taper)), int(fh / 2)), 1, 0, 0, 180)
        cut = (face == 1) & (head == 0)
        img[cut] = bg[cut]
    if rng.rand() < 0.85:
        tone = rng.randint(15, 110)
        hcol = np.clip(tone * rng.uniform(0.6, 1.5, 3), 0, 235)
        mask = np.zeros((size_h, size_w), np.uint8)
        hx = cx + rng.uniform(-0.14, 0.14) * fw
        hy = cy - rng.uniform(0.02, 0.15) * fh
        axes = (int(fw / 2 * rng.uniform(1.0, 1.3)), int(fh / 2 * rng.uniform(0.8, 1.1)))
        draw.fill_ellipse(mask, (int(hx), int(hy)), axes, 1, rng.uniform(-12, 12), 180, 360)
        hairline = cy - rng.uniform(0.16, 0.34) * fh
        wiggle = rng.uniform(0.0, 0.06) * fh * np.sin(
            np.arange(size_w)[None, :] / rng.uniform(5, 18) + rng.uniform(0, 6.28))
        yy = np.arange(size_h)[:, None].astype(np.float32)
        mask = mask.astype(bool) & (yy < hairline + wiggle)
        if mask.any():
            xx = np.arange(size_w)[None, :].astype(np.float32)
            strands = 16 * np.sin((xx + 0.4 * yy) / rng.uniform(1.5, 4.0))
            strands = strands + rng.randn(size_h, size_w) * 7
            hair = np.clip(hcol[None, None] + strands[..., None], 0, 255).astype(np.uint8)
            img[mask] = hair[mask]
    if rng.rand() < 0.25:
        bandc = tuple(int(c) for c in rng.randint(20, 200, 3))
        y0 = int(cy - fh / 2 + rng.uniform(0.0, 0.1) * fh)
        h_band = max(3, int(rng.uniform(0.08, 0.2) * fh))
        draw.fill_rectangle(img, (int(cx - 0.75 * fw), y0 - h_band), (int(cx + 0.75 * fw), y0), bandc)
    if rng.rand() < 0.6:
        ew = max(2, int(fw * 0.09))
        eh = max(1, int(fw * 0.05))
        for exc in (-0.2, 0.2):
            ex, ey = int(cx + exc * fw), int(cy - 0.12 * fh)
            white = tuple(int(v) for v in rng.randint(200, 246, 3))
            draw.fill_ellipse(img, (ex, ey), (ew, eh), white)
            iris = tuple(int(v) for v in rng.randint(20, 120, 3))
            ir = max(1, int(fw * 0.035))
            ix = ex + int(rng.uniform(-0.3, 0.3) * ew)
            draw.fill_disc(img, (ix, ey), ir, iris)
            draw.fill_disc(img, (ix, ey), max(1, ir // 2), (15, 12, 12))
            # upper-lid / socket shadow arc
            draw.ellipse(img, (ex, ey - eh), (ew + 1, eh), 0, 180, 360, (60, 45, 40), 1)
        ny = int(cy + 0.10 * fh)
        draw.line(img, (int(cx - 0.01 * fw), int(cy - 0.05 * fh)), (int(cx - 0.03 * fw), ny), 1, (90, 65, 60))
        for sx in (-1, 1):
            draw.fill_disc(img, (int(cx + sx * 0.05 * fw), ny), max(1, int(fw * 0.015)), (70, 50, 45))
        my = int(cy + 0.28 * fh)
        draw.line(img, (int(cx - fw * 0.14), my), (int(cx + fw * 0.14), my), 1, (70, 25, 25))
    return img


def _clutter_background(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Indoor-portrait background clutter: overlapping filled and outlined
    rectangles, a 3x3 box blur, and an optional radial vignette."""
    size_h, size_w = img.shape[:2]
    for _ in range(rng.randint(4, 12)):
        c = tuple(int(v) for v in rng.randint(0, 210, 3))
        x0, y0 = rng.randint(-20, size_w - 5), rng.randint(-20, size_h - 5)
        w = rng.randint(10, size_w // 2)
        h = rng.randint(10, size_h // 2)
        thickness = -1 if rng.rand() < 0.7 else rng.randint(1, 4)
        if thickness < 0:
            draw.fill_rectangle(img, (x0, y0), (x0 + w, y0 + h), c)
        else:
            draw.rectangle(img, (x0, y0), (x0 + w, y0 + h), thickness, c)
    img = cv.blur_u8(img, 3)
    if rng.rand() < 0.6:
        yy, xx = np.mgrid[0:size_h, 0:size_w].astype(np.float32)
        r2 = (((xx - size_w / 2) / size_w) ** 2 + ((yy - size_h / 2) / size_h) ** 2)
        fall = 1.0 - rng.uniform(0.2, 0.55) * np.clip(r2 * 2.0, 0, 1)
        img = np.clip(img.astype(np.float32) * fall[..., None], 0, 255).astype(np.uint8)
    return np.ascontiguousarray(img)


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
    sample.  ``portrait`` adds background clutter to half the samples and
    :func:`portrait_realism` after the face, ``shaded``
    :func:`face_shading_realism` after that, and ``photometric``
    :func:`photometric_randomize` at the end of the augmented branch."""
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
    if portrait and rng.rand() < 0.5:
        img = _clutter_background(img, rng)

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
    bg_copy = img.copy() if portrait else None
    pts = draw_face(img, cx, cy, fw, fh, skin, aperture)
    if portrait:
        # before the shading, so the rim and the feathering soften the
        # carved jaw and the hairline
        img = portrait_realism(img, bg_copy, cx, cy, fw, fh, rng)
    if shaded:
        # before the accessories (strokes stay crisp) and the rotation (the
        # light turns with the head)
        img = face_shading_realism(img, cx, cy, fw, fh, rng)

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
        if photometric:
            img = photometric_randomize(img, rng)
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
    fourth one ``hard``, and ``photometric`` randomises the even ones.
    ``dense`` re-weights the mixture: 3/4 augmented, the even half hard, every
    augmented sample photometric.  ``shaded`` and ``portrait`` apply to all
    but every fourth sample, which stays clean."""
    A = anchors()
    frames = np.zeros((batch, size, size, 3), np.float32)
    labels = np.zeros((batch, A.shape[0]), np.float32)
    locs = np.zeros((batch, A.shape[0], 4), np.float32)
    boxes_out = []
    for i in range(batch):
        if dense:
            aug_i = augment and i % 4 != 3
            hard_i = augment and i % 2 == 0
            photo_i = photometric and aug_i
        else:
            aug_i = augment and i % 2 == 0
            hard_i = augment and i % 4 == 0
            photo_i = photometric and i % 2 == 0
        img, box, _ = render_face(rng, size, augment=aug_i, hard=hard_i, photometric=photo_i,
                                  shaded=shaded and i % 4 != 3, portrait=portrait and i % 4 != 3)
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
    ``hard_half``; ``photometric`` randomises the augmented ones after the
    render, ``portrait`` draws on them, and ``shaded`` shades all but every
    fourth sample."""
    crops = np.zeros((batch, crop, crop, 3), np.float32)
    targets = np.zeros((batch, 68, 2), np.float32)
    size = 256
    for i in range(batch):
        aug_i = augment and i % 2 == 0
        img, box, pts = render_face(rng, size, aperture=rng.uniform(0.0, 1.0), augment=aug_i,
                                    hard=aug_i if hard_half else (augment and i % 4 == 0),
                                    shaded=shaded and i % 4 != 3, portrait=portrait and aug_i)
        if photometric and aug_i:
            img = photometric_randomize(img, rng)
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
