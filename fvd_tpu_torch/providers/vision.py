"""Vision model provider seams: the port's copy of ``fvd_tpu/providers/vision.py``
(face detection, landmarks+pose, OCR).

The reference wraps OpenCV-DNN SSD (V1), face_alignment FAN + SixDRepNet
(V3/V4) and EasyOCR (V2); its tests script all of them with fixed outputs
(``tests/test_v3_mouth_landmarks.py:35-90`` etc.).  Protocols here operate on
*batched frame tensors* — the TPU-native contract — so production
implementations are single batched forwards over ``uint8[T, H, W, 3]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Protocol

import numpy as np


@dataclass
class FaceBox:
    """One detection in pixel coords."""

    x1: float
    y1: float
    x2: float
    y2: float
    confidence: float


class FaceDetectorProvider(Protocol):
    def detect_batch(self, frames: np.ndarray) -> List[List[FaceBox]]:
        """uint8 [T, H, W, 3] RGB -> per-frame detections."""
        ...

    @property
    def model_name(self) -> str: ...


class LandmarkProvider(Protocol):
    def landmarks_batch(self, frames: np.ndarray) -> List[List[np.ndarray]]:
        """uint8 [T, H, W, 3] RGB -> per-frame list of [68, 2or3] arrays."""
        ...

    def pose_batch(self, crops: np.ndarray) -> np.ndarray:
        """uint8 [N, H, W, 3] face crops -> [N, 3] (pitch, yaw, roll) deg."""
        ...

    @property
    def model_name(self) -> str: ...


class OCRProvider(Protocol):
    def read_text(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """RGB uint8 image -> [{text, confidence, bbox([[x,y]x4])}]."""
        ...

    @property
    def model_name(self) -> str: ...


# ---------------------------------------------------------------------------
# Deterministic implementations
# ---------------------------------------------------------------------------
class NullOCR:
    model_name = "null"

    def read_text(self, image: np.ndarray) -> List[Dict[str, Any]]:
        return []


class ScriptedOCR:
    model_name = "scripted"

    def __init__(self, detections: Optional[List[Dict[str, Any]]] = None):
        self.detections = detections or []

    def read_text(self, image: np.ndarray) -> List[Dict[str, Any]]:
        return list(self.detections)


class ScriptedLandmarks:
    """Scripted landmark/pose provider (the reference's V3/V4 test style).

    ``frames_landmarks``: function or list giving per-frame landmark lists.
    ``poses``: [N,3] array returned cyclically for pose_batch.
    """

    model_name = "scripted"

    def __init__(self, frames_landmarks=None, poses=None):
        self._frames_landmarks = frames_landmarks
        self._poses = np.asarray(poses) if poses is not None else np.zeros((1, 3))
        self._pose_i = 0

    def landmarks_batch(self, frames: np.ndarray) -> List[List[np.ndarray]]:
        n = len(frames)
        if self._frames_landmarks is None:
            return [[] for _ in range(n)]
        if callable(self._frames_landmarks):
            return [self._frames_landmarks(i, frames[i]) for i in range(n)]
        out = []
        for i in range(n):
            src = self._frames_landmarks[min(i, len(self._frames_landmarks) - 1)]
            out.append([np.asarray(lm, dtype=np.float64) for lm in src])
        return out

    def pose_batch(self, crops: np.ndarray) -> np.ndarray:
        n = len(crops)
        idx = (np.arange(n) + self._pose_i) % len(self._poses)
        self._pose_i = (self._pose_i + n) % len(self._poses)
        return self._poses[idx]
