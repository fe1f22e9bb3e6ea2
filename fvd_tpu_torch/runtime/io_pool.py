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
is the shared pool such writes run on.  :class:`AsyncFrameSink` streams a viz
video through one thread of its own: the writer takes it when it has no cache
scope, when a callable batch comes without a fingerprint, or when
``FVD_TPU_NO_ARTIFACT_CACHE`` is set (read at call time, as every A/B switch
of the package is: :func:`artifact_cache_enabled`).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional

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
    into its own artifact dir.  Disable with ``FVD_TPU_NO_ARTIFACT_CACHE=1``.
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


def artifact_cache_enabled() -> bool:
    return not os.environ.get("FVD_TPU_NO_ARTIFACT_CACHE")


def clear_artifact_caches() -> None:
    _png_cache.clear()
    _viz_cache.clear()


def _encode_png(path: str, rgb: np.ndarray, key=None) -> None:
    from fvd_tpu_torch.utils.png import encode_png

    if not artifact_cache_enabled():
        key = None
    with get_tracer().span("artifact/png"):
        data = None if key is None else _png_cache.get(key)
        if data is None:
            data = encode_png(rgb)
            if key is not None:
                _png_cache.put(key, data)
        with open(path, "wb") as f:
            f.write(data)


def viz_cache_get(key) -> Optional[bytes]:
    return _viz_cache.get(key) if artifact_cache_enabled() else None


def viz_cache_put(key, data: bytes) -> None:
    if artifact_cache_enabled():
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


class AsyncFrameSink:
    """A frame sink on a thread of its own, around a blocking batch writer.

    ``append(batch)`` queues (bounded, so memory stays capped at ``maxsize``
    batches) and one worker thread feeds ``write_batch`` in order.  A batch
    may be a zero-argument callable returning the frame array: the drawing
    then runs on the sink's thread too, off the node's critical path.
    ``close()`` flushes, calls ``close_fn`` and re-raises the first failure
    of the worker; ``close_async()`` does the same on the worker and returns
    a Future.
    """

    def __init__(self, write_batch: Callable[[np.ndarray], None], close_fn: Callable[[], None],
                 maxsize: int = 4):
        self._q: "queue.Queue[object]" = queue.Queue(maxsize=maxsize)
        self._write_batch = write_batch
        self._close_fn = close_fn
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _release(self) -> None:
        try:
            self._close_fn()
        except BaseException as e:
            if self._error is None:
                self._error = e

    def _worker(self) -> None:
        while True:
            batch = self._q.get()
            try:
                if batch is None:
                    return
                if isinstance(batch, Future):
                    # close_async's sentinel: release the writer and resolve
                    # the future with the first failure, if any
                    self._release()
                    if self._error is not None:
                        batch.set_exception(self._error)
                    else:
                        batch.set_result(None)
                    return
                if self._error is None:
                    if callable(batch):
                        batch = batch()
                    if len(batch):
                        self._write_batch(batch)
            except BaseException as e:
                self._error = e
            finally:
                self._q.task_done()

    def append(self, batch) -> None:
        """``batch``: uint8 [T, H, W, 3], or a zero-argument callable giving one."""
        if callable(batch) or len(batch):
            self._q.put(batch)

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        self._release()
        if self._error is not None:
            raise self._error

    def close_async(self) -> Future:
        """Flush and release on the sink's thread: a Future that resolves
        once everything queued and the release have finished.  Nothing may
        be appended after this."""
        fut: Future = Future()
        self._q.put(fut)
        return fut
