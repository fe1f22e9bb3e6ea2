"""Background artifact writes: the port's copy of ``fvd_tpu/runtime/io_pool.py``.

Nodes write their keyframe and face-crop PNGs and their viz videos on
background threads, so the encodes overlap the node's next chunk of device
work; each node drains its writer before returning, so the files exist when
its delta is merged.  PNG (``fvd_tpu_torch/utils/png.py``) takes the place of
the JAX package's OpenCV JPEG: that is the one file format in which the port
diverges.  Each encode is a tracer span, ``artifact/png`` or ``artifact/viz``.

Bulk artifacts that nothing downstream reads (the viz videos) are written off
the node's critical path: ``defer_artifact`` registers a pending background
write against the run's artifact dir and the node returns immediately; the
scheduler calls ``flush_artifacts(run_dir)`` once the whole DAG finished, so
the encode overlaps downstream nodes (and, under multi-video overlap, other
videos' device work) instead of gating the node's children.  ``_get_pool``
is the shared pool such writes run on.  The JAX package's ``AsyncFrameSink``
(a viz stream for runs with the encode cache turned off) has no port: the
port's viz writer always goes through the cache and encodes on this pool.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from fvd_tpu_torch.runtime.tracer import get_tracer

_pool_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None


def _get_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=2,
                                       thread_name_prefix="fvd-artifact")
        return _pool


class _EncodeCache:
    """Content-addressed encoded-artifact bytes (PNG frames, viz videos).

    Re-analysis of identical content re-runs every model forward (the
    per-run sharing rule) but need not re-run identical ENCODES: the cache
    key pins the exact encode inputs (video content key + frame id + crop
    box / data fingerprint), so a later run just writes the stored bytes
    into its own artifact dir.
    """

    def __init__(self, max_bytes: int) -> None:
        self._data: "dict[object, bytes]" = {}
        self._order: List[object] = []
        self._bytes = 0
        self.max_bytes = max_bytes
        self._lock = threading.Lock()

    def get(self, key) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def put(self, key, data: bytes) -> None:
        with self._lock:
            if key in self._data:
                return
            self._data[key] = data
            self._order.append(key)
            self._bytes += len(data)
            while self._bytes > self.max_bytes and len(self._order) > 1:
                old = self._order.pop(0)
                self._bytes -= len(self._data.pop(old))

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._order.clear()
            self._bytes = 0


_png_cache = _EncodeCache(64 << 20)
_viz_cache = _EncodeCache(128 << 20)


def clear_artifact_caches() -> None:
    _png_cache.clear()
    _viz_cache.clear()


def _encode_png(path: str, rgb: np.ndarray, key=None) -> None:
    from fvd_tpu_torch.utils.png import encode_png

    with get_tracer().span("artifact/png"):
        data = None if key is None else _png_cache.get(key)
        if data is None:
            data = encode_png(rgb)
            if key is not None:
                _png_cache.put(key, data)
        with open(path, "wb") as f:
            f.write(data)


def viz_cache_get(key) -> Optional[bytes]:
    return _viz_cache.get(key)


def viz_cache_put(key, data: bytes) -> None:
    _viz_cache.put(key, data)


class ArtifactWriter:
    """Per-node handle onto the shared write pool.

    ``save_png`` returns immediately; ``drain()`` blocks until every queued
    write for THIS writer finished and re-raises the first failure.  The
    caller must not mutate submitted arrays (V-node chunks are read-only
    decoded frames / fresh crops, so this holds).
    """

    def __init__(self) -> None:
        self._futures: List[Future] = []

    def save_png(self, path: str, rgb: np.ndarray, key=None) -> None:
        """``key``: optional content-addressed identity of the encoded bytes
        (see _EncodeCache) — repeated-content runs skip the encode."""
        self._futures.append(_get_pool().submit(_encode_png, path, rgb, key))

    def drain(self) -> None:
        err: Optional[BaseException] = None
        for f in self._futures:
            try:
                f.result()
            except BaseException as e:  # keep draining; report the first
                if err is None:
                    err = e
        self._futures.clear()
        if err is not None:
            raise err


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
