"""LLM provider seam: the protocol and the no-key provider of
``fvd_tpu/providers/llm.py``.

The reference calls GPT-4o in four nodes (V5 vision forensics, C2 gesture
fallback, C3 claim extraction, E2 reliability scoring) and degrades
gracefully without an API key; the Null implementation reproduces the no-key
behavior exactly, and ScriptedLLM reproduces the reference's canned-response
test style (e.g. ``tests/test_v5_texture_ela.py:57-92``).  ``OpenAILLM`` is
the networked provider: the JAX package's request over ``urllib.request``
instead of the ``openai`` client.
"""

from __future__ import annotations

import base64
import json
import os
import random
import time
import urllib.error
import urllib.request
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


class OpenAILLM:
    """OpenAI chat completions over ``urllib`` (gated on a key).

    Mirrors the reference call shapes, as the JAX package's ``OpenAILLM``
    sends them through the ``openai`` client: gpt-4o, JSON response format,
    temperature 0.1 in ``chat_json`` and none in ``vision_json``, images as
    ``data:image/jpeg;base64,`` URLs, a 30 s timeout
    (``c3_claim_extraction.py:56-65``, ``v5_texture_ela.py:102-125``).  The
    key comes from ``api_key`` or ``OPENAI_API_KEY``, the base URL from
    ``OPENAI_BASE_URL`` (default ``https://api.openai.com/v1``), and
    ``OPENAI_ORG_ID`` / ``OPENAI_PROJECT_ID`` become the client's headers.
    Like the client's default ``max_retries=2``, a connection error, a
    timeout, or a status of 408, 409, 429 or 500 and above is tried twice
    more after 0.5 s and 1 s (less up to a quarter of jitter; a
    ``Retry-After`` of up to 60 s is honoured instead).  Any failure gives
    None.
    """

    MAX_RETRIES = 2

    def __init__(self, model: str = "gpt-4o", api_key: Optional[str] = None):
        self.model = model
        self.api_key = api_key or os.getenv("OPENAI_API_KEY")
        self.base_url = (os.environ.get("OPENAI_BASE_URL") or "https://api.openai.com/v1").rstrip("/")

    @property
    def available(self) -> bool:
        return bool(self.api_key)

    def request(self, body: Dict[str, Any]) -> urllib.request.Request:
        headers = {"Authorization": f"Bearer {self.api_key}", "Content-Type": "application/json",
                   "Accept": "application/json"}
        for env, header in (("OPENAI_ORG_ID", "OpenAI-Organization"), ("OPENAI_PROJECT_ID", "OpenAI-Project")):
            if os.environ.get(env):
                headers[header] = os.environ[env]
        return urllib.request.Request(f"{self.base_url}/chat/completions", data=json.dumps(body).encode(),
                                      headers=headers, method="POST")

    def _post(self, body: Dict[str, Any]) -> Dict[str, Any]:
        for attempt in range(self.MAX_RETRIES + 1):
            try:
                with urllib.request.urlopen(self.request(body), timeout=30.0) as resp:
                    return json.loads(resp.read().decode("utf-8"))
            except urllib.error.HTTPError as e:
                retry = e.code in (408, 409, 429) or e.code >= 500
                if not retry or attempt == self.MAX_RETRIES:
                    raise
                delay = _retry_after(e.headers)
            except OSError:  # URLError, a timeout, a dropped connection
                if attempt == self.MAX_RETRIES:
                    raise
                delay = None
            time.sleep(delay if delay is not None else min(0.5 * 2 ** attempt, 8.0) * (1 - 0.25 * random.random()))
        raise AssertionError("unreachable")

    def _complete(self, messages: List[Dict[str, Any]], **extra) -> Optional[Dict[str, Any]]:
        if not self.available:
            return None
        try:
            resp = self._post({"model": self.model, "messages": messages,
                               "response_format": {"type": "json_object"}, **extra})
            content = resp["choices"][0]["message"]["content"]
            return json.loads(content) if content else None
        except Exception:
            return None

    def chat_json(self, system: str, prompt: str) -> Optional[Dict[str, Any]]:
        return self._complete([{"role": "system", "content": system}, {"role": "user", "content": prompt}],
                              temperature=0.1)

    def vision_json(self, system, prompt, images) -> Optional[Dict[str, Any]]:
        content: List[Dict[str, Any]] = [{"type": "text", "text": prompt}]
        for img in images:
            b64 = base64.b64encode(img).decode()
            content.append({"type": "image_url", "image_url": {"url": f"data:image/jpeg;base64,{b64}"}})
        return self._complete([{"role": "system", "content": system}, {"role": "user", "content": content}])


def _retry_after(headers) -> Optional[float]:
    """Seconds of a ``Retry-After`` header of at most 60 s, else None."""
    try:
        seconds = float(headers.get("Retry-After", ""))
    except (TypeError, ValueError, AttributeError):
        return None
    return seconds if 0 < seconds <= 60 else None
