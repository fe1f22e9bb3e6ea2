"""LLM provider seam: the protocol and the no-key provider of
``fvd_tpu/providers/llm.py``.

The reference calls GPT-4o in four nodes (V5 vision forensics, C2 gesture
fallback, C3 claim extraction, E2 reliability scoring) and degrades
gracefully without an API key; the Null implementation reproduces the no-key
behavior exactly, and ScriptedLLM reproduces the reference's canned-response
test style (e.g. ``tests/test_v5_texture_ela.py:57-92``).  The networked
provider is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Protocol, Sequence


class LLMProvider(Protocol):
    def chat_json(self, system: str, prompt: str) -> Optional[Dict[str, Any]]:
        """JSON-mode chat completion; None on failure/unavailable."""
        ...

    def vision_json(
        self, system: str, prompt: str, images: Sequence[bytes]
    ) -> Optional[Dict[str, Any]]:
        """JSON-mode vision completion over encoded images (JPEG bytes);
        None on failure/unavailable."""
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


class ScriptedLLM:
    """Deterministic canned responses for tests and hermetic runs.

    ``responses`` maps a substring of the prompt (or system prompt) to a
    response dict; first match wins.  ``default`` is returned when nothing
    matches; a queue can be given instead for strictly ordered responses.
    """

    available = True

    def __init__(
        self,
        responses: Optional[Dict[str, Dict[str, Any]]] = None,
        queue: Optional[List[Dict[str, Any]]] = None,
        default: Optional[Dict[str, Any]] = None,
    ):
        self.responses = responses or {}
        self.queue = list(queue) if queue else None
        self.default = default
        self.calls: List[Dict[str, Any]] = []

    def _next(self, system: str, prompt: str) -> Optional[Dict[str, Any]]:
        self.calls.append({"system": system, "prompt": prompt})
        if self.queue is not None:
            return self.queue.pop(0) if self.queue else self.default
        for key, resp in self.responses.items():
            if key in prompt or key in system:
                return resp
        return self.default

    def chat_json(self, system: str, prompt: str) -> Optional[Dict[str, Any]]:
        return self._next(system, prompt)

    def vision_json(self, system, prompt, images) -> Optional[Dict[str, Any]]:
        return self._next(system, prompt)
