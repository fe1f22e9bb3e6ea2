"""Held-out evaluation of the trained vision and OCR models:

    python -m fvd_tpu_torch.tools.eval_heldout [--n 64] [--json out.json] [--cpu] [--only ocr_det]

The counterpart of the JAX package's ``tools/eval_heldout.py``, with its
flags.  Each model is scored on its training distribution and on a
held-out one, a different parametrisation and not only another seed:

* faces (detector, landmarks, pose): :func:`render_face_heldout`, with
  in-plane rotation, eccentricity and skin outside the training ranges,
  striped gradient backgrounds, glasses and hair;
* OCR (recognizer and region detector): the font faces training never
  draws, DUPLEX, COMPLEX, TRIPLEX and SIMPLEX | ITALIC.  On OpenCV 5, whose
  text :mod:`fvd_tpu_torch.utils.text` reproduces, COMPLEX at thickness 1
  and SIMPLEX | ITALIC draw the training face itself (see that module).

The renders equal the JAX package's for the same seeds (the faces' warp
aside, see :func:`render_face_heldout`).  The models load from
``--ckpt-dir`` (default ``checkpoints/``) through the port's loaders and
run on the card unless ``--cpu`` is given; without a card that raises.  One
line per model, ``<name> {"in_domain": x, "held_out": y, ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Tuple

import numpy as np
import torch

from fvd_tpu_torch import resolve_device, weights
from fvd_tpu_torch.models import face_ssd, landmarks_fan, ocr
from fvd_tpu_torch.models.synthetic_faces import render_face
from fvd_tpu_torch.models.synthetic_pose import CROP_SIZE, euler_to_matrix, warp_by_rotation
from fvd_tpu_torch.models.synthetic_text import detector_sample, random_text, scene_crop_line
from fvd_tpu_torch.synthetic import draw_face
from fvd_tpu_torch.utils import cv, draw
from fvd_tpu_torch.utils import text as T

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT = os.path.join(REPO, "checkpoints")
#: the faces the OCR training renderers never draw
HELD_OUT_FONTS = (T.FONT_HERSHEY_DUPLEX, T.FONT_HERSHEY_COMPLEX, T.FONT_HERSHEY_TRIPLEX,
                  T.FONT_HERSHEY_SIMPLEX | T.FONT_ITALIC)


# ---------------------------------------------------------------------------
# Held-out face renderer
# ---------------------------------------------------------------------------
def render_face_heldout(rng: np.random.RandomState, size: int = 300,
                        aperture: float | None = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``render_face``'s contract, another distribution: rotation,
    eccentricity and skin outside the training ranges, striped backgrounds,
    glasses and hair.  Equal to the JAX package's for the same ``rng``; the
    pixels bit for bit where ``size`` is a multiple of 16, else up to one
    level in the last ``size % 16`` columns of a few rows, where OpenCV's
    affine warp leaves its vector loop (``utils.cv.warp_affine_u8``)."""
    img = np.zeros((size, size, 3), np.uint8)
    base = rng.rand(3) * 150
    grad = np.linspace(0, 80, size)[:, None]
    for c in range(3):
        img[..., c] = np.clip(base[c] + grad + 25 * np.sin(np.arange(size)[None, :] / rng.uniform(6, 18)), 0, 255)

    # eccentricity outside [1.1, 1.4]; size range slightly wider
    fw = rng.uniform(0.22, 0.62) * size
    fh = fw * (rng.uniform(1.0, 1.08) if rng.rand() < 0.5 else rng.uniform(1.45, 1.6))
    cx = rng.uniform(fw / 2 + 2, size - fw / 2 - 2)
    cy = rng.uniform(fh / 2 + 2, size - fh / 2 - 2)
    skin = np.array([rng.randint(130, 255), rng.randint(100, 210), rng.randint(80, 200)])
    pts = draw_face(img, cx, cy, fw, fh, skin, aperture)

    # accessories the training renderer never draws
    dark = (skin * 0.3).astype(int).tolist()
    if rng.rand() < 0.6:  # glasses
        for base_i in (36, 42):
            c = pts[base_i: base_i + 6].mean(axis=0).astype(int)
            draw.circle(img, c, max(3, int(fw * 0.12)), dark, 2)
        left = pts[36:42].mean(axis=0).astype(int)
        right = pts[42:48].mean(axis=0).astype(int)
        draw.line(img, left, right, 2, dark)
    if rng.rand() < 0.6:  # hair arc over the crown
        draw.fill_ellipse(img, (int(cx), int(cy - 0.1 * fh)), (int(fw * 0.55), int(fh * 0.5)), dark, 0, 180, 360)

    # in-plane rotation (training is always upright)
    angle = rng.uniform(-12, 12)
    M = cv.rotation_matrix_2d((cx, cy), angle, 1.0)
    img = cv.warp_affine_u8(img, M, size, size)
    pts = (pts @ M[:, :2].T) + M[:, 2]

    # gt: the exact box of the rotated face ellipse (the training convention)
    th = np.deg2rad(angle)
    a, b = fw / 2.0, fh / 2.0
    hw = float(np.sqrt((a * np.cos(th)) ** 2 + (b * np.sin(th)) ** 2))
    hh = float(np.sqrt((a * np.sin(th)) ** 2 + (b * np.cos(th)) ** 2))
    box = np.array([(cx - hw) / size, (cy - hh) / size, (cx + hw) / size, (cy + hh) / size], np.float32)
    return img, np.clip(box, 0.0, 1.0), pts.astype(np.float32)


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return float(inter / ua) if ua > 0 else 0.0


# ---------------------------------------------------------------------------
# Evaluations (each returns {"in_domain": x, "held_out": y, ...})
# ---------------------------------------------------------------------------
def eval_detector(n: int, seed: int = 7, ckpt_dir: str = CKPT, device=None) -> dict:
    """Mean IoU of the SSD's top box with the gt box."""
    dev = resolve_device(device)
    model = face_ssd.from_params(weights.read_npz(os.path.join(ckpt_dir, "face_ssd.npz")), dev)

    def run(renderer):
        rng = np.random.RandomState(seed)
        frames = np.zeros((n, 300, 300, 3), np.uint8)
        gts = np.zeros((n, 4), np.float32)
        for i in range(n):
            frames[i], gts[i], _ = renderer(rng, 300)
        with torch.no_grad():
            boxes, _ = face_ssd.detect_batch(model, torch.from_numpy(frames).to(dev))
        boxes = boxes.cpu().numpy()
        return float(np.mean([_iou(boxes[i, 0], gts[i]) for i in range(n)]))

    return {"in_domain": run(render_face), "held_out": run(render_face_heldout)}


def eval_landmarks(n: int, seed: int = 11, ckpt_dir: str = CKPT, device=None) -> dict:
    """Mean landmark error in % of the crop's extent."""
    dev = resolve_device(device)
    model = landmarks_fan.from_params(weights.read_npz(os.path.join(ckpt_dir, "landmarks.npz")), dev)

    def run(renderer):
        rng = np.random.RandomState(seed)
        crop = 128
        crops = np.zeros((n, crop, crop, 3), np.uint8)
        targets = np.zeros((n, 68, 2), np.float32)
        for i in range(n):
            img, box, pts = renderer(rng, 256, aperture=rng.uniform(0, 1))
            x1, y1, x2, y2 = np.clip((box * 256).astype(int), 0, 256)
            sub = img[y1:y2, x1:x2]
            if sub.size == 0:
                sub, x1, y1, x2, y2 = img, 0, 0, 256, 256
            crops[i] = cv.resize_linear_u8(sub, crop, crop)
            targets[i, :, 0] = (pts[:, 0] - x1) / max(x2 - x1, 1)
            targets[i, :, 1] = (pts[:, 1] - y1) / max(y2 - y1, 1)
        pred = landmarks_fan.landmarks_forward(model, torch.from_numpy(crops).to(dev)).cpu().numpy()
        err = np.linalg.norm(pred - np.clip(targets, 0, 1), axis=-1).mean()
        return float(err * 100.0)

    return {"in_domain": run(render_face), "held_out": run(render_face_heldout),
            "unit": "% of crop (lower better)"}


def eval_pose(n: int, seed: int = 13, ckpt_dir: str = CKPT, device=None) -> dict:
    """Mean absolute Euler error in degrees of the pose head."""
    dev = resolve_device(device)
    model = landmarks_fan.pose_from_params(weights.read_npz(os.path.join(ckpt_dir, "pose.npz")), dev)

    def run(renderer):
        rng = np.random.RandomState(seed)
        crops = np.zeros((n, CROP_SIZE, CROP_SIZE, 3), np.uint8)
        eulers = np.zeros((n, 3))
        for i in range(n):
            img, box, _ = renderer(rng, 192)
            x1, y1, x2, y2 = np.clip((box * 192).astype(int), 0, 192)
            face = img[y1:y2, x1:x2]
            if face.size == 0:
                face = img
            face = cv.resize_linear_u8(face, CROP_SIZE, CROP_SIZE)
            ang = rng.uniform(-40, 40, 3)
            crops[i] = warp_by_rotation(face, euler_to_matrix(*ang))
            eulers[i] = ang
        pred = landmarks_fan.pose_forward(model, torch.from_numpy(crops).to(dev)).cpu().numpy()
        return float(np.mean(np.abs(pred - eulers)))

    return {"in_domain": run(render_face), "held_out": run(render_face_heldout),
            "unit": "mean abs deg (lower better)"}


def ocr_lines(n: int, seed: int, fonts=None):
    """(lines [n, 32, 256, 1], texts) of ``eval_ocr``: ``scene_crop_line``
    crops, each in a face drawn from ``fonts`` (None: the training face)."""
    rng = np.random.RandomState(seed)
    lines = np.zeros((n, ocr.LINE_H, ocr.LINE_W, 1), np.float32)
    texts = []
    for i in range(n):
        text = random_text(rng, 4, 12)
        font = None if fonts is None else fonts[rng.randint(len(fonts))]
        lines[i] = scene_crop_line(rng, text, font=font)
        texts.append(text)
    return lines, texts


def read_scores(decoded, texts) -> Tuple[float, float]:
    """(exact-match rate, mean per-line character accuracy)."""
    exact = float(np.mean([d == t for d, t in zip(decoded, texts)]))
    chars = [sum(a == b for a, b in zip(d, t)) / max(len(t), 1) for d, t in zip(decoded, texts)]
    return exact, float(np.mean(chars))


def eval_ocr(n: int, seed: int = 17, ckpt_dir: str = CKPT, device=None) -> dict:
    """Exact-match rate (and character accuracy) of the recognizer on
    scene crops in the training face and in the held-out faces."""
    dev = resolve_device(device)
    model = ocr.load_recognizer(os.path.join(ckpt_dir, "ocr_rec.npz"), 32, dev)

    def run(fonts):
        lines, texts = ocr_lines(n, seed, fonts)
        logits = ocr.recognize_forward(model, torch.from_numpy(lines).to(dev)).cpu().numpy()
        return read_scores(ocr.ctc_greedy_decode(logits), texts)

    exact_in, char_in = run(None)
    exact_out, char_out = run(HELD_OUT_FONTS)
    return {"in_domain": exact_in, "held_out": exact_out, "char_in_domain": char_in,
            "char_held_out": char_out, "unit": "exact-match rate"}


def ocr_det_scenes(n: int, seed: int, fonts=None):
    """(images float [n, 256, 256, 3] in 0..1, masks) of ``eval_ocr_det``."""
    rng = np.random.RandomState(seed)
    imgs = np.zeros((n, ocr.DET_SIZE, ocr.DET_SIZE, 3), np.float32)
    masks = np.zeros((n, ocr.DET_SIZE, ocr.DET_SIZE), np.float32)
    for i in range(n):
        font = None if fonts is None else fonts[rng.randint(len(fonts))]
        img, masks[i] = detector_sample(rng, font=font)
        imgs[i] = img.astype(np.float32) / 255.0
    return imgs, masks


def mask_iou(prob: np.ndarray, masks: np.ndarray) -> float:
    """Mean per-image IoU of ``prob > 0.5`` with ``masks > 0.5``."""
    n = len(masks)
    pred, gt = prob > 0.5, masks > 0.5
    inter = (pred & gt).reshape(n, -1).sum(1)
    union = (pred | gt).reshape(n, -1).sum(1)
    return float(np.mean(inter / np.maximum(union, 1)))


def eval_ocr_det(n: int, seed: int = 19, ckpt_dir: str = CKPT, device=None) -> dict:
    """Pixel-mask IoU of the text-region detector (``prob > 0.5``) on scenes
    in the training face and in the held-out faces."""
    dev = resolve_device(device)
    model, _, _ = ocr.load_detector(os.path.join(ckpt_dir, "ocr_det.npz"), dev)

    def run(fonts):
        imgs, masks = ocr_det_scenes(n, seed, fonts)
        return mask_iou(ocr.detect_forward(model, torch.from_numpy(imgs).to(dev)).cpu().numpy(), masks)

    return {"in_domain": run(None), "held_out": run(HELD_OUT_FONTS), "unit": "pixel-mask IoU @0.5"}


EVALS = {"det": eval_detector, "lmk": eval_landmarks, "pose": eval_pose, "ocr": eval_ocr,
         "ocr_det": eval_ocr_det}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true", help="evaluate on the CPU instead of the card")
    ap.add_argument("--only", choices=list(EVALS), default=None)
    ap.add_argument("--ckpt-dir", default=None, help="evaluate checkpoints from this directory instead")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""),
          flush=True)
    ckpt_dir = os.path.abspath(args.ckpt_dir) if args.ckpt_dir else CKPT
    results = {}
    for name, fn in EVALS.items():
        if args.only and name != args.only:
            continue
        results[name] = fn(args.n, ckpt_dir=ckpt_dir, device=device)
        print(name, json.dumps(results[name]), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
