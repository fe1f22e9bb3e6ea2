"""Hermetic stand-ins for the networked services, on 127.0.0.1.

:class:`LoopbackServices` is an ``http.server`` on a free loopback port, in a
daemon thread, that answers as the four backends of
``providers/{llm,search}.py`` from fixed payloads:

* ``POST /serper/search`` (Serper): ``SERPER_PAYLOAD`` for a query naming the
  first claim, else HTTP 500, so the chain falls through;
* ``GET /customsearch/v1`` (Google CSE): ``CSE_PAYLOAD`` for a query naming
  the second claim, else no ``items``;
* ``POST /html/`` (DuckDuckGo): ``DDG_HTML`` for any query;
* ``POST /v1/chat/completions`` (OpenAI): the reply a ``ScriptedLLM`` of
  ``LLM_RESPONSES`` gives the request's system and user text, as JSON in
  ``choices[0].message.content`` (``null`` where it gives none); statuses
  queued in ``chat_failures`` are answered first, one a request.

:meth:`LoopbackServices.pointed` points the backends there (their endpoint
class attributes, ``OPENAI_BASE_URL`` and dummy keys) and restores them after.
:func:`scripted_services` gives the in-process LLM and search whose answers a
networked run must reproduce.  Every request is recorded in ``requests``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from fvd_tpu_torch.providers.llm import ScriptedLLM
from fvd_tpu_torch.providers.search import (DuckDuckGoSearch, GoogleCSESearch, SerperSearch, StaticSearch,
                                            make_result)

#: what the scripted LLM extracts from any transcript
CLAIMS = ["the moon landing happened in 1969", "water boils at 100 degrees", "the eiffel tower is in paris"]
#: the claim whose queries Serper answers, and the one Google CSE answers;
#: the third falls through to DuckDuckGo
SERPER_KEY, CSE_KEY = "moon landing", "water boils"

SERPER_PAYLOAD = {"organic": [
    {"link": "https://www.nasa.gov/apollo11", "title": "Apollo 11", "snippet": "The moon landing of 1969.",
     "date": "Jul 20, 1969"},
    {"link": "https://en.wikipedia.org/wiki/Apollo_11", "title": "Apollo 11 - Wikipedia",
     "snippet": "The first crewed moon landing."},
    {"link": "http://moon-hoax.example.com/fake", "title": "It was staged", "snippet": "A hoax site."},
]}
CSE_PAYLOAD = {"items": [
    {"link": "https://www.bbc.com/science/boiling", "title": "Boiling point", "snippet": "Water boils at 100 C."},
    {"link": "https://chem.mit.edu/water", "title": "Phase changes", "snippet": "Boiling water at sea level."},
]}
DDG_HTML = """<html><body>
<div class="result">
  <a class="result__a" href="//duckduckgo.com/l/?uddg=https%3A%2F%2Fwww.toureiffel.paris%2Fen&amp;rut=abc">Eiffel
  Tower official site</a>
  <a class="result__snippet" href="//duckduckgo.com/l/?uddg=https%3A%2F%2Fwww.toureiffel.paris%2Fen">The tower
  stands in <b>Paris</b>, France.</a>
</div>
<div class="result">
  <a class="result__a" href="https://news.example.org/eiffel">Plain link result</a>
</div>
</body></html>
"""
LLM_RESPONSES: Dict[str, Dict[str, Any]] = {
    "Extract verifiable factual claims": {"claims": CLAIMS},
    "forensic image analyst": {"fake_probability": 0.3, "reasoning": "scripted"},
    "evaluating source reliability": {"score": 0.8, "reason": "scripted"},
}

#: what each backend returns for its payload, as the port's parsers read it
SERPER_RESULTS = [make_result(i["link"], i["title"], i["snippet"], "serper", i.get("date"))
                  for i in SERPER_PAYLOAD["organic"]]
CSE_RESULTS = [make_result(i["link"], i["title"], i["snippet"], "google") for i in CSE_PAYLOAD["items"]]
DDG_RESULTS = DuckDuckGoSearch.parse_html(DDG_HTML)


def scripted_services() -> Tuple[ScriptedLLM, StaticSearch]:
    """The in-process LLM and search that answer as the server does."""
    return (ScriptedLLM(responses=LLM_RESPONSES),
            StaticSearch({SERPER_KEY: SERPER_RESULTS, CSE_KEY: CSE_RESULTS}, default=DDG_RESULTS))


def user_text(messages: List[Dict[str, Any]]) -> Tuple[str, str]:
    """(system, prompt) of a chat request's messages; a vision request's
    prompt is its text part."""
    system = next((m["content"] for m in messages if m["role"] == "system"), "")
    content = next((m["content"] for m in messages if m["role"] == "user"), "")
    if isinstance(content, list):
        content = "".join(p.get("text", "") for p in content if p.get("type") == "text")
    return system, content


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, format, *args):  # noqa: A002 (the base class's name)
        pass

    def _reply(self, status: int, body: str, content_type: str = "application/json") -> None:
        data = body.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        query = urllib.parse.parse_qs(url.query)
        self.server.owner._record("GET", url.path, dict(self.headers), query)
        if url.path != "/customsearch/v1":
            return self._reply(404, "{}")
        q = query.get("q", [""])[0]
        self._reply(200, json.dumps(CSE_PAYLOAD if CSE_KEY in q else {}))

    def do_POST(self):
        owner = self.server.owner
        body = self.rfile.read(int(self.headers.get("Content-Length", 0))).decode()
        path = urllib.parse.urlparse(self.path).path
        if path == "/html/":
            q = urllib.parse.parse_qs(body).get("q", [""])[0]
            owner._record("POST", path, dict(self.headers), q)
            return self._reply(200, DDG_HTML, "text/html; charset=utf-8")
        payload = json.loads(body or "{}")
        owner._record("POST", path, dict(self.headers), payload)
        if path == "/serper/search":
            q = payload.get("q", "")
            return self._reply(200, json.dumps(SERPER_PAYLOAD)) if SERPER_KEY in q else self._reply(500, "{}")
        if path == "/v1/chat/completions":
            with owner._lock:
                status = owner.chat_failures.pop(0) if owner.chat_failures else None
            if status is not None:
                return self._reply(status, json.dumps({"error": {"message": f"scripted {status}"}}))
            reply = ScriptedLLM(responses=LLM_RESPONSES)._next(*user_text(payload.get("messages", [])))
            content = None if reply is None else json.dumps(reply)
            return self._reply(200, json.dumps({"choices": [{"index": 0, "message": {
                "role": "assistant", "content": content}}]}))
        self._reply(404, "{}")


class LoopbackServices:
    """The fixed backends on ``http://127.0.0.1:<port>``; a context manager
    that starts the server and shuts it down."""

    def __init__(self):
        self.requests: List[Tuple[str, str, Dict[str, str], Any]] = []
        self.chat_failures: List[int] = []
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _record(self, method, path, headers, payload) -> None:
        with self._lock:
            self.requests.append((method, path, headers, payload))

    @property
    def base(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def __enter__(self) -> "LoopbackServices":
        self._server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        self._server.daemon_threads = True
        self._server.owner = self
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)

    def counts(self) -> Dict[str, int]:
        """Requests received per path."""
        out: Dict[str, int] = {}
        with self._lock:
            for _, path, _, _ in self.requests:
                out[path] = out.get(path, 0) + 1
        return out

    @contextlib.contextmanager
    def pointed(self):
        """The backends' endpoints, ``OPENAI_BASE_URL`` and dummy keys for the
        LLM, Serper and Google CSE pointed at this server (and no proxy for
        it) while the block runs; restored after."""
        attrs = {SerperSearch: f"{self.base}/serper/search", GoogleCSESearch: f"{self.base}/customsearch/v1",
                 DuckDuckGoSearch: f"{self.base}/html/"}
        env = {"OPENAI_BASE_URL": f"{self.base}/v1", "OPENAI_API_KEY": "loopback-key",
               "SERPER_API_KEY": "loopback-key", "GOOGLE_API_KEY": "loopback-key", "GOOGLE_CX": "loopback-cx",
               "NO_PROXY": "127.0.0.1,localhost", "no_proxy": "127.0.0.1,localhost"}
        saved_attrs = {cls: cls.ENDPOINT for cls in attrs}
        saved_env = {k: os.environ.get(k) for k in env}
        try:
            for cls, url in attrs.items():
                cls.ENDPOINT = url
            os.environ.update(env)
            yield self
        finally:
            for cls, url in saved_attrs.items():
                cls.ENDPOINT = url
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
