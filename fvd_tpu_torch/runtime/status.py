"""Dependency-aware status tracking for UIs: the port's copy of
``fvd_tpu/runtime/status.py``.

Reimplements the observable behavior of the reference Streamlit status board
(``app.py:224-313``) and its tested logic (``tests/test_frontend_logic.py``):

* an incoming completion event is only *valid* if every parent already
  completed (out-of-order stream events are deferred, not dropped);
* node status is ``done`` if completed, ``running`` if all parents are done
  (or it has none), else ``queued``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Set, Tuple


@dataclass
class StatusBoard:
    nodes_order: Sequence[str]
    edges: Sequence[Tuple[str, str]]
    done_nodes: Set[str] = field(default_factory=set)
    _deferred: Set[str] = field(default_factory=set)

    def __post_init__(self):
        self.node_parents: Dict[str, Set[str]] = {}
        for src, dst in self.edges:
            self.node_parents.setdefault(dst, set()).add(src)

    # -- event ingestion ------------------------------------------------
    def valid_batch(self, completed: Iterable[str]) -> Set[str]:
        """Which of these completions are consistent with dependency order
        (parents all done)?  Mirrors app.py:260-267."""
        batch = set(completed) | self._deferred
        valid = {
            n for n in batch if self.node_parents.get(n, set()) <= self.done_nodes
        }
        self._deferred = batch - valid
        return valid

    def mark_done(self, completed: Iterable[str]) -> Set[str]:
        """Ingest completions; returns the accepted (valid) subset. Deferred
        events are retried on subsequent calls."""
        accepted: Set[str] = set()
        progressed = True
        pending = set(completed)
        while progressed:
            valid = self.valid_batch(pending)
            pending = set()
            accepted |= valid
            self.done_nodes |= valid
            progressed = bool(valid) and bool(self._deferred)
        return accepted

    # -- rendering ------------------------------------------------------
    def statuses(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for n in self.nodes_order:
            if n in self.done_nodes:
                out[n] = "done"
                continue
            parents = self.node_parents.get(n, set())
            out[n] = "running" if parents <= self.done_nodes else "queued"
        return out

    def render_lines(self) -> List[str]:
        icons = {"done": "[x]", "running": "[~]", "queued": "[ ]"}
        st = self.statuses()
        return [f"{icons[st[n]]} {n}" for n in self.nodes_order]
