"""Procedural head-pose dataset: the counterpart of
``fvd_tpu/models/synthetic_pose.py``.  Frontal procedural faces
(:mod:`fvd_tpu_torch.models.synthetic_faces`) are lifted into 3D, rotated by
R = Rz(roll) Ry(yaw) Rx(pitch) (the decomposition that
:func:`fvd_tpu_torch.models.landmarks_fan.euler_from_matrix_deg` inverts)
and re-projected with a weak-perspective camera, which gives (image, R)
pairs for the 6D pose head.  The random draws come in the JAX package's
order, so one ``RandomState`` gives the same rotations and leaves the same
state; the warp and the resize are OpenCV's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from fvd_tpu_torch.models.landmarks_fan import CROP_SIZE
from fvd_tpu_torch.models.synthetic_faces import _occluders, photometric_randomize, render_face
from fvd_tpu_torch.utils import cv, draw


def euler_to_matrix(pitch_deg: float, yaw_deg: float, roll_deg: float) -> np.ndarray:
    """R = Rz(roll) @ Ry(yaw) @ Rx(pitch), float64 [3, 3]."""
    p, y, r = np.deg2rad([pitch_deg, yaw_deg, roll_deg])
    Rx = np.array([[1, 0, 0], [0, np.cos(p), -np.sin(p)], [0, np.sin(p), np.cos(p)]])
    Ry = np.array([[np.cos(y), 0, np.sin(y)], [0, 1, 0], [-np.sin(y), 0, np.cos(y)]])
    Rz = np.array([[np.cos(r), -np.sin(r), 0], [np.sin(r), np.cos(r), 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def warp_by_rotation(img: np.ndarray, R: np.ndarray, depth: float = 2.0) -> np.ndarray:
    """Rotate the image plane in 3D by ``R`` and re-project it (weak
    perspective, edges replicated)."""
    h, w = img.shape[:2]
    half = np.array([w / 2, h / 2])
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
    src = (corners * half + half).astype(np.float32)
    rot = np.concatenate([corners, np.zeros((4, 1))], axis=1) @ R.T  # unit plane, z = 0
    z = rot[:, 2] + depth
    dst = (rot[:, :2] * (depth / z[:, None]) * half + half).astype(np.float32)
    return cv.warp_perspective_u8(img, cv.perspective_transform(src, dst), w, h)


def _face_crop(img: np.ndarray, box: np.ndarray, size: int) -> np.ndarray:
    """The gt box of ``img`` resized to the pose crop (the whole image where
    the box is empty)."""
    x1, y1, x2, y2 = (box * size).astype(int)
    face = img[max(0, y1):y2, max(0, x1):x2]
    if face.size == 0:
        face = img
    return cv.resize_linear_u8(face, CROP_SIZE, CROP_SIZE)


def pose_batch(
    rng: np.random.RandomState, batch: int, max_angle: float = 40.0,
    augment: bool = False, photometric: bool = False, shaded: bool = False,
    hard_half: bool = False, portrait: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (crops float32 [B, 128, 128, 3] in 0..1, R [B, 3, 3], euler degrees
    [B, 3]).  ``augment`` renders the even samples augmented, every fourth
    one ``hard``, or all of them with ``hard_half``; ``photometric``
    randomises the augmented ones, ``portrait`` draws on them, and
    ``shaded`` shades all but every fourth sample."""
    crops = np.zeros((batch, CROP_SIZE, CROP_SIZE, 3), np.float32)
    Rs = np.zeros((batch, 3, 3), np.float64)
    eulers = np.zeros((batch, 3), np.float64)
    for i in range(batch):
        aug_i = augment and i % 2 == 0
        img, box, _ = render_face(rng, 192, augment=aug_i,
                                  hard=aug_i if hard_half else (augment and i % 4 == 0),
                                  shaded=shaded and i % 4 != 3, portrait=portrait and aug_i)
        if photometric and aug_i:
            img = photometric_randomize(img, rng)
        face = _face_crop(img, box, 192)
        pitch = rng.uniform(-max_angle, max_angle)
        yaw = rng.uniform(-max_angle, max_angle)
        roll = rng.uniform(-max_angle, max_angle)
        R = euler_to_matrix(pitch, yaw, roll)
        crops[i] = warp_by_rotation(face, R).astype(np.float32) / 255.0
        Rs[i] = R
        eulers[i] = (pitch, yaw, roll)
    return crops, Rs, eulers


def _accessory_pass(img: np.ndarray, box: np.ndarray, pts: np.ndarray,
                    rng: np.random.RandomState, size: int) -> np.ndarray:
    """A copy of a rendered face with accessory strokes: eye rings and a
    bridge at the eye landmarks' centroids, a crown cap, free occluders."""
    out = img.copy()
    x1, y1, x2, y2 = box * size
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    fw, fh = max(x2 - x1, 8.0), max(y2 - y1, 8.0)
    face_mean = img[int(max(0, y1)):int(y2), int(max(0, x1)):int(x2)]
    base = face_mean.reshape(-1, 3).mean(axis=0) if face_mean.size else np.full(3, 128.0)
    stroke = tuple(int(c) for c in (base * rng.uniform(0.15, 0.6)))
    if rng.rand() < 0.7:
        left = tuple(pts[36:42].mean(axis=0).astype(int))
        right = tuple(pts[42:48].mean(axis=0).astype(int))
        rad = max(2, int(fw * rng.uniform(0.08, 0.16)))
        th = rng.randint(1, 4)
        draw.circle(out, left, rad, stroke, th)
        draw.circle(out, right, rad, stroke, th)
        draw.line(out, left, right, th, stroke)
    if rng.rand() < 0.7:
        center = (int(cx), int(cy - rng.uniform(0.0, 0.2) * fh))
        axes = (int(fw * rng.uniform(0.4, 0.62)), int(fh * rng.uniform(0.35, 0.55)))
        draw.fill_ellipse(out, center, axes, stroke, 0, 180, 360)
    _occluders(out, rng, size, rng.randint(1, 4))
    return out


def pose_batch_paired(
    rng: np.random.RandomState, batch: int, max_angle: float = 40.0,
    photometric: bool = False, shaded: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (crops A, crops B float32 [B, 128, 128, 3] in 0..1, R [B, 3, 3]):
    the same face under the same rotation, A clean and B with accessory
    strokes, for the pose consistency loss.  ``shaded`` shades a face with
    probability 3/4, ``photometric`` randomises B with probability 1/2."""
    size = 192
    cropsA = np.zeros((batch, CROP_SIZE, CROP_SIZE, 3), np.float32)
    cropsB = np.zeros((batch, CROP_SIZE, CROP_SIZE, 3), np.float32)
    Rs = np.zeros((batch, 3, 3), np.float64)
    for i in range(batch):
        img, box, pts = render_face(rng, size, shaded=shaded and rng.rand() < 0.75)
        imgB = _accessory_pass(img, box, pts, rng, size)
        if photometric and rng.rand() < 0.5:
            imgB = photometric_randomize(imgB, rng)
        R = euler_to_matrix(*rng.uniform(-max_angle, max_angle, 3))
        for crops, src in ((cropsA, img), (cropsB, imgB)):
            crops[i] = warp_by_rotation(_face_crop(src, box, size), R).astype(np.float32) / 255.0
        Rs[i] = R
    return cropsA, cropsB, Rs
