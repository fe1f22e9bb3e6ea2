"""LR fusion helpers: the port of ``fvd_tpu/ops/fusion.py``.

The final ``fake_probability`` is a numerically stable sigmoid over 9
features (reference ``lr_node.py:142-155``), trained online with plain SGD
``w <- w - 0.005*(p-label)*f`` (``lr_node.py:181-192``).  The per-video path
is float64 Python, bit-compatible with the reference, and touches no device.

Training over the whole feature cache (the batch harness's
``--train-device``) is the device half: the corpus becomes one float32
``[N, D]`` tensor on the caller's device, and each "epoch over the corpus
with per-video sequential updates" is a loop over videos of tensor ops that
never reads a value back until it ends.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

#: Canonical feature order (reference lr_node.py:130-140 insertion order).
FEATURE_ORDER: Tuple[str, ...] = (
    "speech_rate",
    "pause_ratio",
    "lip_sync",
    "gesture_score",
    "blink_rate",
    "headpose_jerk",
    "texture",
    "claim_reliability",
    "evidence_reliability",
)

DEFAULT_LEARNING_RATE = 0.005  # lr_node.py:183


def stable_sigmoid(z: float) -> float:
    """Branch-stable sigmoid (reference lr_node.py:152-155)."""
    if z >= 0:
        return 1.0 / (1.0 + math.exp(-z))
    ez = math.exp(z)
    return ez / (1.0 + ez)


def predict_host(features: Dict[str, float], weights: Dict[str, float]) -> float:
    """Scalar LR forward, identical accumulation order to the reference
    (bias first, then features in dict insertion order, lr_node.py:144-150)."""
    z = weights.get("bias", 0.0)
    for k, v in features.items():
        z += weights.get(k, 0.0) * v
    return stable_sigmoid(z)


def sgd_update_host(
    features: Dict[str, float],
    weights: Dict[str, float],
    label: int,
    lr: float = DEFAULT_LEARNING_RATE,
) -> Tuple[Dict[str, float], float]:
    """One online update (reference lr_node.py:181-192). Returns
    (new_weights, probability_before_update)."""
    p = predict_host(features, weights)
    error = p - float(label)
    new_w = dict(weights)
    new_w["bias"] = new_w.get("bias", 0.0) - lr * error * 1.0
    for k, v in features.items():
        new_w[k] = new_w.get(k, 0.0) - lr * error * v
    return new_w, p


def features_to_vector(features: Dict[str, float]) -> np.ndarray:
    return np.array([features.get(k, 0.0) for k in FEATURE_ORDER], dtype=np.float32)


def weights_to_vectors(weights: Dict[str, float]) -> Tuple[np.ndarray, np.ndarray]:
    w = np.array([weights.get(k, 0.0) for k in FEATURE_ORDER], dtype=np.float32)
    b = np.array(weights.get("bias", 0.0), dtype=np.float32)
    return w, b


def vectors_to_weights(w: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    out = {"bias": float(b)}
    for k, v in zip(FEATURE_ORDER, np.asarray(w).tolist()):
        out[k] = float(v)
    return out


def predict_batch(feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Vectorized LR forward over an [N, D] feature matrix."""
    return torch.sigmoid(feats @ w + b)


def sgd_epoch(feats: torch.Tensor, labels: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              lr: float = DEFAULT_LEARNING_RATE) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sequential pass over the corpus (per-video SGD, like replaying the
    reference batch harness).  Returns (w, b, per-video probabilities
    *before* each update)."""
    probs = []
    for f, y in zip(feats, labels):
        p = torch.sigmoid(f @ w + b)
        err = p - y
        w, b = w - lr * err * f, b - lr * err
        probs.append(p)
    return w, b, torch.stack(probs) if probs else feats.new_zeros((0,))


def train_until_correct(feats: torch.Tensor, labels: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        lr: float = DEFAULT_LEARNING_RATE,
                        max_epochs: int = 100) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device analog of the harness's retry-until-correct loop
    (``batch_test.py:158-189``): for each video in order, repeat the SGD
    update until the thresholded prediction matches the label (at most
    ``max_epochs`` updates).  Returns (w, b, updates per video, int32).

    The JAX package runs a ``while_loop`` per video.  Once a video's
    prediction is right, ``w`` and ``b`` stop changing, so ``max_epochs``
    steps that update only while the video is still wrong give the same
    ``w``, ``b`` and counts with no host sync inside the loop."""
    iters = []
    for f, y in zip(feats, labels):
        n = torch.zeros((), dtype=torch.int32, device=feats.device)
        for _ in range(max_epochs):
            p = torch.sigmoid(f @ w + b)
            wrong = torch.where(y > 0.5, p <= 0.5, p > 0.5)
            err = torch.where(wrong, p - y, torch.zeros_like(p))
            w, b = w - lr * err * f, b - lr * err
            n = n + wrong.to(torch.int32)
        iters.append(n)
    return w, b, torch.stack(iters) if iters else torch.zeros((0,), dtype=torch.int32, device=feats.device)
