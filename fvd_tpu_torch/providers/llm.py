"""LLM provider seam: the protocol and the no-key provider of
``fvd_tpu/providers/llm.py``.

The reference calls GPT-4o in four nodes (V5 vision forensics, C2 gesture
fallback, C3 claim extraction, E2 reliability scoring) and degrades
gracefully without an API key; the Null implementation reproduces the no-key
behavior exactly.  The scripted and networked providers come with the nodes
that call them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Protocol, Sequence


class LLMProvider(Protocol):
    def chat_json(self, system: str, prompt: str) -> Optional[Dict[str, Any]]:
        """JSON-mode chat completion; None on failure/unavailable."""
        ...

    def vision_json(
        self, system: str, prompt: str, images: Sequence[bytes]
    ) -> Optional[Dict[str, Any]]:
        """JSON-mode vision completion over JPEG byte images; None on
        failure/unavailable."""
        ...

    @property
    def available(self) -> bool: ...


class NullLLM:
    """No API key: every call returns None (reference no-key paths)."""

    available = False

    def chat_json(self, system: str, prompt: str) -> Optional[Dict[str, Any]]:
        return None

    def vision_json(self, system, prompt, images) -> Optional[Dict[str, Any]]:
        return None
