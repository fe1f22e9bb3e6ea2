"""Background artifact writes: the part of ``fvd_tpu/runtime/io_pool.py`` that
the scheduler and its nodes call.

Bulk artifacts that nothing downstream reads (the viz mp4s) are written off
the node's critical path: ``defer_artifact`` registers a pending background
write against the run's artifact dir and the node returns immediately; the
scheduler calls ``flush_artifacts(run_dir)`` once the whole DAG finished, so
the encode overlaps downstream nodes (and, under multi-video overlap, other
videos' device work) instead of gating the node's children.  ``_get_pool``
is the shared pool such writes run on.

The JPEG encode cache, ``ArtifactWriter`` and ``AsyncFrameSink`` come with
the media nodes that write JPEGs and videos.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

_pool_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None


def _get_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=2,
                                       thread_name_prefix="fvd-artifact")
        return _pool


_deferred_lock = threading.Lock()
_deferred: "dict[str, List[Future]]" = {}


def defer_artifact(run_dir: str, future: Future) -> None:
    """Register a pending background artifact write for ``run_dir``.

    The write completes on its own thread; ``flush_artifacts`` (called by
    the scheduler at end of run) waits for it and surfaces failures.
    """
    with _deferred_lock:
        _deferred.setdefault(run_dir or "", []).append(future)


def flush_artifacts(run_dir: Optional[str] = None) -> List[str]:
    """Wait for deferred artifact writes; returns error strings.

    ``run_dir=None`` flushes every registered dir (tool/teardown use).
    """
    with _deferred_lock:
        if run_dir is None:
            pending = [f for fs in _deferred.values() for f in fs]
            _deferred.clear()
        else:
            pending = _deferred.pop(run_dir, []) + _deferred.pop("", [])
    errors: List[str] = []
    for f in pending:
        try:
            f.result()
        except BaseException as e:
            errors.append(repr(e))
    return errors
