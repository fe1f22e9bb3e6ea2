"""Per-factor detector held-out diagnostic:

    python -m fvd_tpu_torch.tools.diagnose_det_heldout [--n 64] [--ckpt checkpoints/face_ssd.npz] [--cpu]

The counterpart of the JAX package's ``tools/diagnose_det_heldout.py``,
with its flags.  The held-out renderer (``tools/eval_heldout.py``) changes
four things at once: striped backgrounds, out-of-range eccentricity and
skin, accessories (glasses, hair) and in-plane rotation.  This tool toggles
each factor on its own against the in-domain renderer to attribute the IoU
drop, so detector training effort goes at the factor that matters.

:func:`render_factored` draws the JAX tool's pixels bit for bit, with
OpenCV's rasterisation from :mod:`fvd_tpu_torch.utils.draw` and its blur,
rotation matrix and affine warp from :mod:`fvd_tpu_torch.utils.cv`.  The
detector (bfloat16, as the JAX tool's ``detect_batch_jit``) runs on the
card unless ``--cpu`` is given; without a card that raises.  One line per
case, ``<case> mean IoU <x>``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Tuple

import numpy as np
import torch

from fvd_tpu_torch import resolve_device, weights
from fvd_tpu_torch.models import face_ssd
from fvd_tpu_torch.synthetic import draw_face
from fvd_tpu_torch.tools.eval_heldout import CKPT, _iou
from fvd_tpu_torch.utils import cv, draw

#: the factor sets the tool reports, in its order
CASES = [
    ("baseline (in-domain-like)", {}),
    ("stripes", {"stripes": True}),
    ("ecc_skin", {"ecc_skin": True}),
    ("accessories", {"accessories": True}),
    ("rotation", {"rotation": True}),
    ("ALL (held-out-like)", {"stripes": True, "ecc_skin": True, "accessories": True, "rotation": True}),
]


def render_factored(rng: np.random.RandomState, size: int = 300, *, stripes=False, ecc_skin=False,
                    accessories=False, rotation=False,
                    aperture=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One face with each held-out factor on or off -> (image uint8 [size,
    size, 3], gt box [4] in 0..1, landmarks [68, 2] px).  Draws ``rng`` in
    the JAX tool's order."""
    if stripes:
        img = np.zeros((size, size, 3), np.uint8)
        base = rng.rand(3) * 150
        grad = np.linspace(0, 80, size)[:, None]
        for c in range(3):
            img[..., c] = np.clip(base[c] + grad + 25 * np.sin(np.arange(size)[None, :] / rng.uniform(6, 18)), 0, 255)
    else:
        img = (rng.rand(size, size, 3) * 60 + rng.rand(3) * 120).astype(np.uint8)
        img = cv.blur_u8(img, 5)

    if ecc_skin:
        fw = rng.uniform(0.22, 0.62) * size
        fh = fw * (rng.uniform(1.0, 1.08) if rng.rand() < 0.5 else rng.uniform(1.45, 1.6))
        skin = np.array([rng.randint(130, 255), rng.randint(100, 210), rng.randint(80, 200)])
    else:
        fw = rng.uniform(0.25, 0.6) * size
        fh = fw * rng.uniform(1.1, 1.4)
        skin = np.array([rng.randint(160, 230), rng.randint(120, 190), rng.randint(100, 170)])
    cx = rng.uniform(fw / 2 + 2, size - fw / 2 - 2)
    cy = rng.uniform(fh / 2 + 2, size - fh / 2 - 2)
    pts = draw_face(img, cx, cy, fw, fh, skin, aperture)

    if accessories:
        dark = (skin * 0.3).astype(int).tolist()
        if rng.rand() < 0.6:
            for base_i in (36, 42):
                c = pts[base_i: base_i + 6].mean(axis=0).astype(int)
                draw.circle(img, c, max(3, int(fw * 0.12)), dark, 2)
            left = pts[36:42].mean(axis=0).astype(int)
            right = pts[42:48].mean(axis=0).astype(int)
            draw.line(img, left, right, 2, dark)
        if rng.rand() < 0.6:
            draw.fill_ellipse(img, (int(cx), int(cy - 0.1 * fh)), (int(fw * 0.55), int(fh * 0.5)), dark, 0, 180, 360)

    angle = rng.uniform(-12, 12) if rotation else 0.0
    if rotation:
        M = cv.rotation_matrix_2d((cx, cy), angle, 1.0)
        img = cv.warp_affine_u8(img, M, size, size)
        pts = (pts @ M[:, :2].T) + M[:, 2]
    th = np.deg2rad(angle)
    a, b = fw / 2.0, fh / 2.0
    hw = float(np.sqrt((a * np.cos(th)) ** 2 + (b * np.sin(th)) ** 2))
    hh = float(np.sqrt((a * np.sin(th)) ** 2 + (b * np.cos(th)) ** 2))
    box = np.array([(cx - hw) / size, (cy - hh) / size, (cx + hw) / size, (cy + hh) / size], np.float32)
    return img, np.clip(box, 0.0, 1.0), pts.astype(np.float32)


def case_frames(n: int, factors: dict, seed: int = 7, size: int = 300) -> Tuple[np.ndarray, np.ndarray]:
    """The tool's ``n`` frames and gt boxes of one factor set (seed 7)."""
    rng = np.random.RandomState(seed)
    frames = np.zeros((n, size, size, 3), np.uint8)
    gts = np.zeros((n, 4), np.float32)
    for i in range(n):
        frames[i], gts[i], _ = render_factored(rng, size, **factors)
    return frames, gts


def mean_iou(model: face_ssd.FaceSSD, frames: np.ndarray, gts: np.ndarray,
             compute_dtype: torch.dtype = torch.bfloat16) -> float:
    """Mean IoU of the detector's top box with the gt boxes, one batch on
    the model's device, the backbone in ``compute_dtype``."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        boxes, _ = face_ssd.detect_batch(model, torch.from_numpy(frames).to(dev), compute_dtype=compute_dtype)
    boxes = boxes.cpu().numpy()
    return float(np.mean([_iou(boxes[i, 0], gts[i]) for i in range(len(gts))]))


def main(argv=None) -> Dict[str, float]:
    """-> {case: mean IoU}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--cpu", action="store_true", help="run the detector on the CPU instead of the card")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    model = face_ssd.from_params(weights.read_npz(args.ckpt or os.path.join(CKPT, "face_ssd.npz")), dev)
    out = {}
    for name, factors in CASES:
        out[name] = mean_iou(model, *case_frames(args.n, factors))
        print(f"{name:28s} mean IoU {out[name]:.3f}", flush=True)
    return out


if __name__ == "__main__":
    main()
