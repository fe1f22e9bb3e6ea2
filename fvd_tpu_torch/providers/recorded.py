"""Recorded (deterministic fixture) LLM + search providers: the port of
``fvd_tpu/providers/recorded.py``, plain Python on the host.

The reference's own tests stub its external services at exactly these
seams — OpenAI JSON mode (`tests/test_c3_openai_primary.py:13-37`) and the
search chain (`tests/test_e1_web_evidence.py`) — so the full
C3 -> E1 -> E2 -> E3 claim/evidence pipeline is exercisable hermetically.
These providers do the same for this framework's bench and demo paths: no
network, no credentials, byte-deterministic, but every downstream node runs
its REAL logic (query fan-out, dedup, embedding re-rank, reliability
arithmetic, verdict bands) on non-degenerate data.

``RecordedLLM`` routes on each node's prompt contract and synthesizes a
valid response; ``RecordedSearch`` derives a stable result set per query
from a fixed domain roster.  Both produce outputs that vary with the input
(hash-seeded), so per-video features spread instead of collapsing to one
value.

The texture score decodes the crop's JPEG bytes with ``utils/jpeg.py`` and
takes ``utils/cv.py``'s Laplacian, OpenCV's to the bit, so its 3-decimal
score equals the JAX package's.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any, Dict, List, Optional

import numpy as np

from fvd_tpu_torch.providers.search import SearchResult, make_result
from fvd_tpu_torch.utils.cv import laplacian_f32
from fvd_tpu_torch.utils.jpeg import decode_jpeg_gray


def _h(data: bytes) -> int:
    return int.from_bytes(hashlib.md5(data).digest()[:8], "big")


def _unit(data: bytes) -> float:
    """Deterministic uniform [0, 1) from bytes."""
    return (_h(data) % (1 << 32)) / float(1 << 32)


# ---------------------------------------------------------------------------
# LLM
# ---------------------------------------------------------------------------
class RecordedLLM:
    """Deterministic LLM: recognizes each node's JSON contract by its prompt
    markers (the prompts are parity-locked to the reference, so the markers
    are stable) and answers in kind."""

    available = True
    model_name = "recorded"

    def chat_json(self, system: str, prompt: str) -> Optional[Dict[str, Any]]:
        if "Extract verifiable factual claims" in prompt:
            return {"claims": self._claims_from_prompt(prompt)}
        if "evaluating source reliability" in prompt:
            return self._reliability_from_prompt(prompt)
        return None

    def vision_json(self, system: str, prompt: str,
                    images: List[bytes]) -> Optional[Dict[str, Any]]:
        blob = b"".join(images) if images else prompt.encode()
        if "fake_probability" in system or "fake_probability" in prompt:
            # heuristic forensic analyst standing in for the vision LLM
            # (reference v5 contract: {fake_probability, reasoning}): scores
            # the crop's high-frequency residual energy — deterministic, and
            # genuinely responsive to texture manipulation, so V5's feature
            # separates tampered faces instead of emitting noise
            p = self._texture_probability(images)
            if p is None:  # undecodable image: stable hash fallback
                p = 0.15 + 0.5 * _unit(blob)
            return {"fake_probability": round(p, 3),
                    "reasoning": "recorded fixture: high-frequency residual score"}
        if "consistent" in prompt:
            ok = _h(blob) % 4 != 0  # mostly consistent, some inconsistent
            return {"consistent": ok, "reason": "recorded fixture"}
        return None

    @staticmethod
    def _texture_probability(images: List[bytes]) -> Optional[float]:
        """Mean |Laplacian| of the face crop (images[0]) mapped to [0, 1).

        Clean renders/camera faces sit well under hf~12; additive
        manipulation noise pushes hf up roughly 3.6x its sigma."""
        if not images:
            return None
        try:
            img = decode_jpeg_gray(images[0])
            if img is None or img.size == 0:
                return None
            hf = float(np.mean(np.abs(laplacian_f32(img))))
            return float(np.clip((hf - 6.0) / 30.0, 0.02, 0.98))
        except Exception:
            return None

    # -- contract synthesis ------------------------------------------------
    @staticmethod
    def _claims_from_prompt(prompt: str) -> List[str]:
        """Claim extraction (reference c3:19-115 contract): pull the
        TRANSCRIPT/OCR sections out of the prompt, split into clause-sized
        claims."""
        m = re.search(r"TRANSCRIPT:\n(.*?)\n\nON-SCREEN TEXT \(OCR\):\n(.*?)\n\nInstructions",
                      prompt, re.S)
        transcript, ocr = (m.group(1), m.group(2)) if m else (prompt, "")
        claims: List[str] = []
        # sentence-split; unpunctuated ASR text falls back to word chunks
        for sent in re.split(r"[.!?]\s+", transcript.strip()):
            words = sent.split()
            if len(words) >= 24:
                for i in range(0, len(words) - 5, 10):
                    claims.append(" ".join(words[i:i + 10]))
            elif len(words) >= 4:
                claims.append(" ".join(words))
        for line in ocr.splitlines():
            if len(line.split()) >= 3:
                claims.append(line.strip())
        return claims[:3]  # reference-scale claim counts keep E1 fan-out sane

    @staticmethod
    def _reliability_from_prompt(prompt: str) -> Optional[Dict[str, Any]]:
        m = re.search(r"- Domain: (\S+)", prompt)
        if not m:
            return None
        domain = m.group(1)
        tier = {
            "reuters.com": 0.93, "apnews.com": 0.92, "bbc.com": 0.90,
            "nature.com": 0.94, "census.gov": 0.95, "nasa.gov": 0.95,
            "snopes.com": 0.85, "factcheck.org": 0.86,
        }
        base = tier.get(domain, 0.35 + 0.4 * _unit(domain.encode()))
        return {"score": round(base, 3),
                "reason": f"recorded fixture: {domain} reliability"}


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------
#: (domain, title template) — a mix of the trust tiers E2's arithmetic
#: distinguishes (.gov bonus, high-trust roster, unknown https, plain http)
_ROSTER = [
    ("reuters.com", "Fact check: {q}"),
    ("apnews.com", "AP verification: {q}"),
    ("bbc.com", "Reality Check: {q}"),
    ("census.gov", "Official statistics: {q}"),
    ("snopes.com", "Rating: {q}"),
    ("factcheck.org", "Checking claims: {q}"),
    ("medium.com", "What I found about {q}"),
    ("wordpress-newsblog.com", "SHOCKING: {q}"),
    ("dailybuzzfeed.net", "You won't believe: {q}"),
]


class RecordedSearch:
    """Deterministic results per query from a fixed roster; URL identity is
    claim-scoped so E1's URL dedup across the 7 query variants behaves like
    a real engine (same article surfacing for related queries)."""

    def __init__(self, results_per_query: int = 5):
        self.results_per_query = results_per_query
        self.calls = 0

    def search(self, query: str, max_results: int = 5) -> List[SearchResult]:
        self.calls += 1
        # claim-scope the article id: strip the variant boilerplate so
        # "X fact check" and "proof that X" hit overlapping URLs
        core = re.sub(
            r"^(is it true that|proof that|evidence for)\s+|"
            r"\s+(fact check|debunked|fake|hoax)$", "", query.strip())
        seed = _h(core.encode())
        n = min(self.results_per_query, max_results)
        start = seed % len(_ROSTER)
        out: List[SearchResult] = []
        # one variant-dependent result; the rest claim-scoped so the
        # variants overlap (giving E1 dedup real work) without being identical
        variant_off = _h(query.encode()) % 2
        for i in range(n):
            off = variant_off if i == n - 1 else 0
            domain, title_t = _ROSTER[(start + i * 2 + off) % len(_ROSTER)]
            article = f"{(seed + i * 977) % 100000:05d}"
            scheme = "http" if domain.endswith(".net") else "https"
            out.append(make_result(
                title=title_t.format(q=core[:60]),
                url=f"{scheme}://{domain}/articles/{article}",
                snippet=(f"Coverage of the claim '{core[:120]}' with sourcing "
                         f"and context from {domain}."),
                source=domain,
            ))
        return out
