"""Web-search provider seam: the protocol, the result schema and the
hermetic providers of ``fvd_tpu/providers/search.py``.

The reference's E1 node implements a Serper -> Google CSE -> DuckDuckGo
fallback chain (``e1_web_evidence.py:220-319``).  Here each backend is one
provider and the chain itself is a provider (``ChainSearch``), so the
fallback behavior is testable without monkeypatching.  Result schema matches
the reference ``EvidenceResult`` TypedDict (``e1:34-41``): url, title,
snippet, source, date, relevance_score.  The networked backends are not
ported yet.
"""

from __future__ import annotations

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
