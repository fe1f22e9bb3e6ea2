"""LR fusion helpers: the host half of ``fvd_tpu/ops/fusion.py``.

The final ``fake_probability`` is a numerically stable sigmoid over 9
features (reference ``lr_node.py:142-155``), trained online with plain SGD
``w <- w - 0.005*(p-label)*f`` (``lr_node.py:181-192``).  The per-video path
is float64 Python, bit-compatible with the reference, and touches no device.
The batched training programs (``predict_batch``, ``sgd_epoch``,
``train_until_correct``) come with their only caller, the batch harness's
device training.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

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
