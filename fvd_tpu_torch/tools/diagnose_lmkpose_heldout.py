"""Per-factor landmark and pose held-out diagnostic:

    python -m fvd_tpu_torch.tools.diagnose_lmkpose_heldout [--n 64] [--lmk-ckpt X] [--pose-ckpt Y] [--cpu]

The counterpart of the JAX package's ``tools/diagnose_lmkpose_heldout.py``,
with its flags.  The held-out face renderer changes four factors at once
(stripes, out-of-range eccentricity and skin, accessories, in-plane
rotation); :mod:`fvd_tpu_torch.tools.diagnose_det_heldout` attributes the
detector's gap per factor, and this tool does the same for the landmark
regressor and the pose head, so further training goes at the factor that
matters, or the numbers show a flat profile.

The crops follow ``eval_heldout`` (the gt-box crop resized to 128 with
OpenCV's linear rule; pose additionally warps by a known rotation), drawn
by :func:`~fvd_tpu_torch.tools.diagnose_det_heldout.render_factored`, whose
rng order differs from ``render_face_heldout``'s: the rows match
``eval_heldout``'s held-out cells in distribution, not sample for sample.
The hourglass (bfloat16, as in the JAX tool) and the pose head (float32,
its width from the checkpoint's sidecar) run on the card unless ``--cpu``
is given; without a card that raises.  A header, then one line per case:
landmark error in % of the crop and pose error in mean degrees.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from fvd_tpu_torch import resolve_device, weights
from fvd_tpu_torch.models import landmarks_fan
from fvd_tpu_torch.models.synthetic_pose import CROP_SIZE, euler_to_matrix, warp_by_rotation
from fvd_tpu_torch.tools.diagnose_det_heldout import CASES, render_factored
from fvd_tpu_torch.tools.eval_heldout import CKPT
from fvd_tpu_torch.utils import cv


def lmk_crops(n: int, factors: dict, seed: int = 11) -> Tuple[np.ndarray, np.ndarray]:
    """(crops uint8 [n, 128, 128, 3], landmark targets [n, 68, 2] in the
    crop's unit square) of one factor set: 256-pixel faces with a random
    aperture, cut at the gt box."""
    rng = np.random.RandomState(seed)
    crops = np.zeros((n, 128, 128, 3), np.uint8)
    targets = np.zeros((n, 68, 2), np.float32)
    for i in range(n):
        img, box, pts = render_factored(rng, 256, aperture=rng.uniform(0, 1), **factors)
        x1, y1, x2, y2 = np.clip((box * 256).astype(int), 0, 256)
        sub = img[y1:y2, x1:x2]
        if sub.size == 0:
            sub, x1, y1, x2, y2 = img, 0, 0, 256, 256
        crops[i] = cv.resize_linear_u8(sub, 128, 128)
        targets[i, :, 0] = (pts[:, 0] - x1) / max(x2 - x1, 1)
        targets[i, :, 1] = (pts[:, 1] - y1) / max(y2 - y1, 1)
    return crops, targets


def pose_crops(n: int, factors: dict, seed: int = 13) -> Tuple[np.ndarray, np.ndarray]:
    """(crops uint8 [n, CROP_SIZE, CROP_SIZE, 3], Euler angles [n, 3]) of
    one factor set: 192-pixel faces cut at the gt box, resized and warped by
    a random rotation of up to 40 degrees on each axis."""
    rng = np.random.RandomState(seed)
    crops = np.zeros((n, CROP_SIZE, CROP_SIZE, 3), np.uint8)
    eulers = np.zeros((n, 3))
    for i in range(n):
        img, box, _ = render_factored(rng, 192, **factors)
        x1, y1, x2, y2 = np.clip((box * 192).astype(int), 0, 192)
        face = img[y1:y2, x1:x2]
        if face.size == 0:
            face = img
        face = cv.resize_linear_u8(face, CROP_SIZE, CROP_SIZE)
        ang = rng.uniform(-40, 40, 3)
        crops[i] = warp_by_rotation(face, euler_to_matrix(*ang))
        eulers[i] = ang
    return crops, eulers


def load_models(lmk_ckpt: str | None, pose_ckpt: str | None, device):
    """(hourglass, pose head) on ``device``; the pose head at the width its
    sidecar names (32 without one)."""
    lmk = landmarks_fan.from_params(weights.read_npz(lmk_ckpt or os.path.join(CKPT, "landmarks.npz")), device)
    pose_path = pose_ckpt or os.path.join(CKPT, "pose.npz")
    width = 32
    if os.path.exists(pose_path.replace(".npz", ".json")):
        with open(pose_path.replace(".npz", ".json")) as f:
            width = int(json.load(f).get("width", 32))
    params = weights.read_npz(pose_path)
    if weights.kernel_width(params, "Conv_0") != width:
        raise ValueError(f"{pose_path}: its sidecar names width {width}, its kernels hold "
                         f"{weights.kernel_width(params, 'Conv_0')}")
    return lmk, landmarks_fan.pose_from_params(params, device)


def lmk_error(model, crops: np.ndarray, targets: np.ndarray, compute_dtype: torch.dtype = torch.bfloat16) -> float:
    """Mean landmark error in % of the crop, the hourglass in ``compute_dtype``."""
    dev = next(model.parameters()).device
    pred = landmarks_fan.landmarks_forward(model, torch.from_numpy(crops).to(dev), compute_dtype).cpu().numpy()
    return float(np.linalg.norm(pred - np.clip(targets, 0, 1), axis=-1).mean() * 100.0)


def pose_error(model, crops: np.ndarray, eulers: np.ndarray) -> float:
    """Mean absolute Euler error in degrees."""
    dev = next(model.parameters()).device
    pred = landmarks_fan.pose_forward(model, torch.from_numpy(crops).to(dev)).cpu().numpy()
    return float(np.mean(np.abs(pred - eulers)))


def main(argv=None) -> Dict[str, Tuple[float, float]]:
    """-> {case: (landmark % of crop, pose mean degrees)}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--lmk-ckpt", default=None)
    ap.add_argument("--pose-ckpt", default=None)
    ap.add_argument("--cpu", action="store_true", help="run the models on the CPU instead of the card")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    lmk, pose = load_models(args.lmk_ckpt, args.pose_ckpt, dev)
    print(f"{'factor':28s} {'lmk % of crop':>14s} {'pose mean deg':>14s}", flush=True)
    out = {}
    for name, factors in CASES:
        out[name] = (lmk_error(lmk, *lmk_crops(args.n, factors)), pose_error(pose, *pose_crops(args.n, factors)))
        print(f"{name:28s} {out[name][0]:14.3f} {out[name][1]:14.3f}", flush=True)
    return out


if __name__ == "__main__":
    main()
