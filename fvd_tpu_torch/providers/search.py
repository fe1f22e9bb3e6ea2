"""Web-search provider seam: the protocol, the result schema and the
hermetic providers of ``fvd_tpu/providers/search.py``.

The reference's E1 node implements a Serper -> Google CSE -> DuckDuckGo
fallback chain (``e1_web_evidence.py:220-319``).  Here each backend is one
provider and the chain itself is a provider (``ChainSearch``), so the
fallback behavior is testable without monkeypatching.  Result schema matches
the reference ``EvidenceResult`` TypedDict (``e1:34-41``): url, title,
snippet, source, date, relevance_score.

The networked backends (Serper, Google CSE, keyless DuckDuckGo), the shared
disk cache and ``default_chain`` speak HTTP through ``urllib.request`` where
the JAX package uses ``requests``: the same URLs, query parameters, headers,
bodies and timeouts, and an HTTP status of 400 or above raises, as
``raise_for_status`` does.  Each endpoint is a class attribute.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional, Protocol

SearchResult = Dict[str, Any]


def make_result(
    url: str,
    title: str = "",
    snippet: str = "",
    source: str = "stub",
    date: Optional[str] = None,
) -> SearchResult:
    return {
        "url": url,
        "title": title,
        "snippet": snippet,
        "source": source,
        "date": date,
        "relevance_score": 0.0,
    }


class SearchProvider(Protocol):
    def search(self, query: str, max_results: int = 5) -> List[SearchResult]: ...


class NullSearch:
    """No network: every query returns no results."""

    def search(self, query: str, max_results: int = 5) -> List[SearchResult]:
        return []


class StaticSearch:
    """Deterministic results from a mapping (substring match on query)."""

    def __init__(self, mapping: Dict[str, List[SearchResult]], default: Optional[List[SearchResult]] = None):
        self.mapping = mapping
        self.default = default or []
        self.queries: List[str] = []

    def search(self, query: str, max_results: int = 5) -> List[SearchResult]:
        self.queries.append(query)
        for key, results in self.mapping.items():
            if key in query:
                return results[:max_results]
        return self.default[:max_results]


class FailingSearch:
    """Always raises — for exercising the fallback chain in tests."""

    def __init__(self, exc: Exception = RuntimeError("search backend down")):
        self.exc = exc
        self.calls = 0

    def search(self, query: str, max_results: int = 5) -> List[SearchResult]:
        self.calls += 1
        raise self.exc


class ChainSearch:
    """Try providers in order; first non-empty result wins; failures fall
    through (the reference's search_robust, e1:220-261)."""

    def __init__(self, providers: List[SearchProvider]):
        self.providers = providers

    def search(self, query: str, max_results: int = 5) -> List[SearchResult]:
        for p in self.providers:
            try:
                results = p.search(query, max_results)
            except Exception:
                continue
            if results:
                return results
        return []


_USER_AGENT = "Mozilla/5.0 (fvd-tpu evidence fetcher)"


def _charset(content_type: str) -> str:
    """The text encoding ``requests`` reads a body in: the header's charset,
    else ISO-8859-1 for ``text/*`` (RFC 2616) and UTF-8 otherwise."""
    for param in content_type.split(";")[1:]:
        key, _, value = param.strip().partition("=")
        if key.lower() == "charset" and value:
            return value.strip("'\"")
    return "ISO-8859-1" if "text" in content_type else "utf-8"


def _fetch(req: urllib.request.Request, timeout: float) -> str:
    """The body of ``req``'s response as text.  ``urlopen`` raises
    ``urllib.error.HTTPError`` for a status of 400 or above (and for a
    redirect it cannot follow), where ``requests`` needs
    ``raise_for_status``."""
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read().decode(_charset(resp.headers.get("Content-Type", "")), errors="replace")


class SerperSearch:
    """Serper.dev backend (gated on key; reference e1:263-282)."""

    ENDPOINT = "https://google.serper.dev/search"

    def __init__(self, api_key: Optional[str] = None):
        self.api_key = api_key or os.environ.get("SERPER_API_KEY")

    def request(self, query: str, max_results: int = 5) -> urllib.request.Request:
        return urllib.request.Request(
            self.ENDPOINT, data=json.dumps({"q": query, "num": max_results}).encode(), method="POST",
            headers={"X-API-KEY": self.api_key, "Content-Type": "application/json"})

    def search(self, query: str, max_results: int = 5) -> List[SearchResult]:
        if not self.api_key:
            return []
        body = _fetch(self.request(query, max_results), timeout=5)
        return [
            make_result(item.get("link", ""), item.get("title", ""), item.get("snippet", ""), "serper",
                        item.get("date"))
            for item in json.loads(body).get("organic", [])
        ]


class GoogleCSESearch:
    """Google Custom Search backend (reference e1:284-302)."""

    ENDPOINT = "https://www.googleapis.com/customsearch/v1"

    def __init__(self, api_key: Optional[str] = None, cx: Optional[str] = None):
        self.api_key = api_key or os.environ.get("GOOGLE_API_KEY")
        self.cx = cx or os.environ.get("GOOGLE_CX")

    def request(self, query: str, max_results: int = 5) -> urllib.request.Request:
        params = urllib.parse.urlencode({"key": self.api_key, "cx": self.cx, "q": query, "num": max_results})
        return urllib.request.Request(f"{self.ENDPOINT}?{params}")

    def search(self, query: str, max_results: int = 5) -> List[SearchResult]:
        if not (self.api_key and self.cx):
            return []
        body = _fetch(self.request(query, max_results), timeout=5)
        return [
            make_result(item.get("link", ""), item.get("title", ""), item.get("snippet", ""), "google")
            for item in json.loads(body).get("items", [])
        ]


class DuckDuckGoSearch:
    """Keyless DuckDuckGo backend (reference ``e1:304-319`` uses the ``ddgs``
    package; like the JAX package this talks to the public HTML endpoint
    and parses it with the stdlib parser: same position in the fallback
    chain, no extra dependency)."""

    ENDPOINT = "https://html.duckduckgo.com/html/"

    def request(self, query: str) -> urllib.request.Request:
        return urllib.request.Request(
            self.ENDPOINT, data=urllib.parse.urlencode({"q": query}).encode(), method="POST",
            headers={"User-Agent": _USER_AGENT, "Content-Type": "application/x-www-form-urlencoded"})

    def search(self, query: str, max_results: int = 5) -> List[SearchResult]:
        body = _fetch(self.request(query), timeout=8)
        return self.parse_html(body)[:max_results]

    @staticmethod
    def parse_html(html: str) -> List[SearchResult]:
        """Extract (url, title, snippet) triples from a DDG html/ page."""
        from html.parser import HTMLParser

        class _P(HTMLParser):
            def __init__(self):
                super().__init__()
                self.results: List[SearchResult] = []
                self._mode: Optional[str] = None  # "title" | "snippet"
                self._href = ""
                self._text: List[str] = []

            def handle_starttag(self, tag, attrs):
                a = dict(attrs)
                cls = a.get("class", "")
                if tag == "a" and "result__a" in cls:
                    self._mode = "title"
                    self._href = a.get("href", "")
                    self._text = []
                elif tag == "a" and "result__snippet" in cls:
                    self._mode = "snippet"
                    self._text = []

            def handle_data(self, data):
                if self._mode:
                    self._text.append(data)

            def handle_endtag(self, tag):
                if tag != "a" or not self._mode:
                    return
                text = "".join(self._text).strip()
                if self._mode == "title":
                    url = DuckDuckGoSearch._unwrap_redirect(self._href)
                    self.results.append(make_result(url, text, "", "duckduckgo"))
                elif self._mode == "snippet" and self.results:
                    self.results[-1]["snippet"] = text
                self._mode = None

        p = _P()
        p.feed(html)
        return [r for r in p.results if r["url"]]

    @staticmethod
    def _unwrap_redirect(href: str) -> str:
        """DDG links via //duckduckgo.com/l/?uddg=<urlencoded target>."""
        if "uddg=" in href:
            qs = urllib.parse.parse_qs(urllib.parse.urlparse(href).query)
            target = qs.get("uddg", [""])[0]
            if target:
                return urllib.parse.unquote(target)
        return href


class CachedSearch:
    """Disk-backed cross-process query cache around any backend.

    The reference declares Redis (``pyproject.toml:23``, E-nodes README) but
    ships only an in-memory per-run dict (``e1:190-191,356-362``).  This is
    the shared-cache capability done host-side: one JSON file per query
    under ``cache_dir`` (atomic rename writes, so concurrent batch workers
    can share it), with a TTL.  E1's in-run dict still sits above this.  The
    file name and entry are the JAX package's, so either package's entries
    are hits for the other.
    """

    def __init__(self, backend: SearchProvider, cache_dir: str, ttl_s: float = 7 * 24 * 3600.0):
        self.backend = backend
        self.cache_dir = cache_dir
        self.ttl_s = ttl_s
        os.makedirs(cache_dir, exist_ok=True)

    def _path(self, query: str, max_results: int) -> str:
        key = hashlib.sha1(f"{max_results}|{query}".encode()).hexdigest()
        return os.path.join(self.cache_dir, f"{key}.json")

    def search(self, query: str, max_results: int = 5) -> List[SearchResult]:
        path = self._path(query, max_results)
        try:
            with open(path) as f:
                entry = json.load(f)
            if time.time() - entry["t"] <= self.ttl_s:
                return entry["results"]
        except (OSError, ValueError, KeyError):
            pass
        results = self.backend.search(query, max_results)
        if results:  # only cache hits; misses may be transient backend state
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump({"t": time.time(), "query": query, "results": results}, f)
                os.replace(tmp, path)
            except OSError:
                pass
        return results


def default_chain() -> SearchProvider:
    """Serper -> Google CSE -> DuckDuckGo (the reference chain, e1:220-261),
    wrapped in the shared disk cache when FVD_SEARCH_CACHE_DIR is set."""
    chain: SearchProvider = ChainSearch([SerperSearch(), GoogleCSESearch(), DuckDuckGoSearch()])
    cache_dir = os.environ.get("FVD_SEARCH_CACHE_DIR")
    if cache_dir:
        chain = CachedSearch(chain, cache_dir)
    return chain


def describe(search: SearchProvider) -> str:
    """A search provider's class, with a chain's and a cache's backends:
    ``CachedSearch(ChainSearch(SerperSearch, GoogleCSESearch, DuckDuckGoSearch))``."""
    if isinstance(search, CachedSearch):
        return f"CachedSearch({describe(search.backend)})"
    if isinstance(search, ChainSearch):
        return f"ChainSearch({', '.join(describe(p) for p in search.providers)})"
    return type(search).__name__
