"""Text / image embedding provider seams: the port's copy of
``fvd_tpu/providers/encoders.py``.

The reference uses MiniLM for E1 evidence re-ranking (``e1:330-354``) and
CLIP ViT-B/32 for C2 image-text consistency (``c2:49-54,117-121``).  The
protocols here are vector-in/vector-out; production implementations can wrap
the models of ``fvd_tpu_torch/models``; the default implementations are
deterministic and dependency-free:

* ``HashingTextEncoder`` — a hashed bag-of-words embedding; cosine similarity
  is a real lexical-overlap signal, so ranking behavior is meaningful (and
  stable) without model weights.
* ``StubClip`` — scripted image/text scores for tests (the reference mocks
  CLIP the same way).
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Optional, Protocol

import numpy as np


class TextEncoder(Protocol):
    def encode(self, text: str) -> np.ndarray: ...


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


class HashingTextEncoder:
    """Hashed bag-of-words embedding (dim buckets, l2-normalized)."""

    def __init__(self, dim: int = 256):
        self.dim = dim

    def encode(self, text: str) -> np.ndarray:
        vec = np.zeros(self.dim, np.float32)
        for tok in re.findall(r"[a-z0-9]+", text.lower()):
            h = int.from_bytes(hashlib.md5(tok.encode()).digest()[:4], "little")
            vec[h % self.dim] += 1.0
        n = np.linalg.norm(vec)
        return vec / n if n > 0 else vec


class ClipProvider(Protocol):
    def image_text_similarity(self, image: np.ndarray, text: str) -> float:
        """Cosine similarity between an RGB uint8 image and a text."""
        ...


class StubClip:
    """Deterministic CLIP stand-in.

    Scores come from a scripted map keyed by text substring; unmatched pairs
    get ``default`` (above the reference's 0.25 'Consistent' threshold so
    hermetic runs look like aligned footage).
    """

    def __init__(self, scripted: Optional[Dict[str, float]] = None, default: float = 0.3):
        self.scripted = scripted or {}
        self.default = default
        self.calls: List[str] = []

    def image_text_similarity(self, image: np.ndarray, text: str) -> float:
        self.calls.append(text)
        for key, score in self.scripted.items():
            if key in text:
                return score
        return self.default

    def image_text_similarity_batch(self, images, texts) -> np.ndarray:
        return np.array([
            self.image_text_similarity(im, t) for im, t in zip(images, texts)
        ])
