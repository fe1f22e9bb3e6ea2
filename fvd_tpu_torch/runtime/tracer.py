"""Structured tracing: the port's copy of ``fvd_tpu/runtime/tracer.py``.

The reference has no tracer — progress is ``print(..., flush=True)`` and a
per-item wall-time in E2 (``e2:274-280``).  Here every node and kernel span
is recorded with wall time and, where the JAX package opens a
``jax.profiler.TraceAnnotation``, opened as a
``torch.profiler.record_function`` range, so node and coalesced-group spans
line up with the card's kernels in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Span:
    name: str
    start_s: float
    end_s: float = 0.0
    cpu_s: float = 0.0  # thread CPU time inside the span (excludes blocking)
    meta: Dict[str, object] = field(default_factory=dict)

    @property
    def elapsed_s(self) -> float:
        return self.end_s - self.start_s


class Tracer:
    def __init__(self, use_profiler_annotations: bool = True):
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._use_profiler = use_profiler_annotations

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        sp = Span(name=name, start_s=time.perf_counter(), meta=dict(meta))
        cpu0 = time.thread_time()
        ctx = contextlib.nullcontext()
        if self._use_profiler:
            import torch.profiler

            ctx = torch.profiler.record_function(name)
        try:
            with ctx:
                yield sp
        finally:
            sp.end_s = time.perf_counter()
            sp.cpu_s = time.thread_time() - cpu0
            with self._lock:
                self.spans.append(sp)

    def summary(self) -> Dict[str, float]:
        """Total seconds per span name."""
        out: Dict[str, float] = {}
        with self._lock:
            for sp in self.spans:
                out[sp.name] = out.get(sp.name, 0.0) + sp.elapsed_s
        return out

    def counts(self) -> Dict[str, int]:
        """Number of spans per name (e.g. merged device programs run)."""
        out: Dict[str, int] = {}
        with self._lock:
            for sp in self.spans:
                out[sp.name] = out.get(sp.name, 0) + 1
        return out

    def summary_cpu(self) -> Dict[str, float]:
        """Total thread-CPU seconds per span name.

        This is the host cost of each span — blocking on device work, locks
        and futures is excluded — which wall spans inflate under many-video
        overlap."""
        out: Dict[str, float] = {}
        with self._lock:
            for sp in self.spans:
                out[sp.name] = out.get(sp.name, 0.0) + sp.cpu_s
        return out

    def dump_json(self, path: str) -> None:
        with self._lock:
            data = [
                {"name": s.name, "start_s": s.start_s, "elapsed_s": s.elapsed_s, **s.meta}
                for s in self.spans
            ]
        with open(path, "w") as f:
            json.dump(data, f, indent=2)


class _NullTracer(Tracer):
    def __init__(self):
        super().__init__(use_profiler_annotations=False)

    @contextlib.contextmanager
    def span(self, name: str, **meta):  # pragma: no cover - trivial
        yield Span(name=name, start_s=0.0)


_tracer: Tracer = _NullTracer()


def get_tracer() -> Tracer:
    return _tracer


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    global _tracer
    _tracer = tracer if tracer is not None else _NullTracer()
    return _tracer
