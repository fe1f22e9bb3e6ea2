"""Web-search provider seam: the protocol and the no-network provider of
``fvd_tpu/providers/search.py``.  The backends and the fallback
chain come with the E1 node.
"""

from __future__ import annotations

from typing import Any, Dict, List, Protocol

SearchResult = Dict[str, Any]


class SearchProvider(Protocol):
    def search(self, query: str, max_results: int = 5) -> List[SearchResult]: ...


class NullSearch:
    """No network: every query returns no results."""

    def search(self, query: str, max_results: int = 5) -> List[SearchResult]:
        return []
