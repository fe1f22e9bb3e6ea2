"""Cross-video coalescing of per-video device programs: the program
coalescer of ``fvd_tpu/providers/coalesce.py``.

Under multi-video overlap (many ``Scheduler.invoke`` calls at once, as
``batch.run_pipeline_many`` runs them) each pipeline issues its own small
device programs.  This layer coalesces concurrent requests into single
device programs, the same dynamic-batching idea as
``fvd_tpu_torch.serving.MicroBatcher``: requests that arrive within the
batching window are grouped by key, run as one batched call, and the results
split back per request.  On the card, C1's group is one launch of
``csrc/lipsync_score.cu`` with one fetch of its results.

The vision wrappers (detector, landmarks, OCR, CLIP) and
``coalesce_providers`` come with the providers they wrap.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import defaultdict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from fvd_tpu_torch.runtime.tracer import get_tracer


@dataclass
class _Req:
    key: tuple
    size: int
    payload: Any
    fut: Future


class _Coalescer:
    """Generic request coalescer.

    ``run_group(key, payloads) -> list-of-results`` executes one merged
    call; requests are grouped by ``key`` and greedily packed so a group's
    total ``size`` stays <= ``max_total`` (an oversized single request runs
    alone — ``run_group`` must handle any size).
    """

    def __init__(self, run_group: Callable[[tuple, List[Any]], List[Any]],
                 max_total: int, max_wait_ms: float = 6.0,
                 run_threads: int = 2):
        self.run_group = run_group
        self.max_total = max_total
        self.max_wait_s = max_wait_ms / 1000.0
        #: adaptive window: where a group's dispatch+fetch round trip is slow,
        #: waiting a bit longer to merge more staggered arrivals into ONE
        #: round trip is a clear win; where it is fast the EMA is small and
        #: the configured window stands.
        #: window = clamp(base, 0.15 * EMA(group seconds), 50 ms).
        self._base_wait_s = self.max_wait_s
        self._rtt_ema: Optional[float] = None
        self._q: "queue.Queue[Optional[_Req]]" = queue.Queue()
        self._running = True
        self._state_lock = threading.Lock()  # serializes submit vs close
        self._stats_lock = threading.Lock()
        self.groups_run = 0
        self.items_served = 0
        # group execution runs on a small pool so consecutive groups'
        # dispatch+fetch round trips pipeline instead of serializing behind
        # the batching thread (the device still orders the programs)
        self._runners = ThreadPoolExecutor(max_workers=max(1, run_threads),
                                           thread_name_prefix="fvd-coalesce-run")
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="fvd-coalesce")
        self._thread.start()

    def submit(self, key: tuple, size: int, payload: Any) -> Future:
        fut: Future = Future()
        # the check and the enqueue are atomic w.r.t. close(): a request can
        # never slip in after the shutdown sentinel and hang its caller
        with self._state_lock:
            if not self._running:
                fut.set_exception(RuntimeError("coalescer is closed"))
                return fut
            self._q.put(_Req(key, size, payload, fut))
        return fut

    def close(self) -> None:
        with self._state_lock:
            self._running = False
            self._q.put(None)
        self._thread.join(timeout=10)
        self._runners.shutdown(wait=True)

    def _drain_window(self, first: _Req) -> List[_Req]:
        items = [first]
        totals: Dict[tuple, int] = {first.key: first.size}
        t0 = time.monotonic()
        while True:
            # homogeneous window whose one key already fills the bucket:
            # stop sleeping and run.  With mixed keys pending, keep the
            # window open — exiting early would flush the other keys as
            # under-filled groups.
            if len(totals) == 1 and next(iter(totals.values())) >= self.max_total:
                return items
            remaining = self.max_wait_s - (time.monotonic() - t0)
            if remaining <= 0:
                return items
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                return items
            if nxt is None:
                self._running = False
                return items
            items.append(nxt)
            totals[nxt.key] = totals.get(nxt.key, 0) + nxt.size

    def _worker(self) -> None:
        while True:
            if not self._running:  # close() sentinel may land mid-window
                break
            first = self._q.get()
            if first is None:
                break
            items = self._drain_window(first)
            by_key: Dict[tuple, List[_Req]] = defaultdict(list)
            for it in items:
                by_key[it.key].append(it)
            for key, reqs in by_key.items():
                chunk: List[_Req] = []
                total = 0
                for r in reqs + [None]:  # sentinel flushes the last chunk
                    if r is not None and (not chunk or total + r.size <= self.max_total):
                        chunk.append(r)
                        total += r.size
                        continue
                    if chunk:
                        self._runners.submit(self._run_chunk, key, chunk)
                    chunk = [r] if r is not None else []
                    total = r.size if r is not None else 0
        # fail anything still queued
        while True:
            try:
                left = self._q.get_nowait()
            except queue.Empty:
                return
            if left is not None:
                left.fut.set_exception(RuntimeError("coalescer closed"))

    def _run_chunk(self, key: tuple, chunk: List[_Req]) -> None:
        try:
            # span name = the op family (key[0]); the rest of the key is
            # geometry.  Shows where merged device-program time actually
            # goes, separate from the node spans' contention-inflated waits.
            t0 = time.monotonic()
            with get_tracer().span(f"coalesce/{key[0]}", n=len(chunk)):
                results = self.run_group(key, [r.payload for r in chunk])
            rtt = time.monotonic() - t0
            if not os.environ.get("FVD_TPU_NO_ADAPTIVE_WINDOW"):
                with self._stats_lock:
                    self._rtt_ema = (rtt if self._rtt_ema is None
                                     else 0.8 * self._rtt_ema + 0.2 * rtt)
                    self.max_wait_s = min(
                        0.050, max(self._base_wait_s, 0.15 * self._rtt_ema))
            if len(results) != len(chunk):  # a silent mismatch would leave
                # the unmatched futures blocking their caller threads forever
                raise RuntimeError(
                    f"coalesced group returned {len(results)} results for "
                    f"{len(chunk)} requests (key={key})"
                )
            with self._stats_lock:
                self.groups_run += 1
                self.items_served += len(chunk)
            for r, res in zip(chunk, results):
                r.fut.set_result(res)
        except BaseException as e:
            for r in chunk:
                r.fut.set_exception(e)


# ---------------------------------------------------------------------------
# Cross-video coalescing of per-video OPS programs (C1 lip-sync so far)
# ---------------------------------------------------------------------------
# These programs are called straight from their nodes, one small dispatch +
# fetch per video.  ``run_program`` funnels them through one shared
# coalescer: concurrent videos' identical-shape programs run as ONE batched
# dispatch with ONE result fetch.

_program_co: Optional[_Coalescer] = None
_program_co_lock = threading.Lock()


def _run_program_group(key: tuple, payloads: List[Any]) -> List[Any]:
    # every payload sharing a key carries an equivalent run_batch — use the
    # first (they close over the same op + parameters by construction)
    run_batch = payloads[0][1]
    return run_batch([p[0] for p in payloads])


def run_program(kind: str, key: tuple, payload: Any,
                run_batch: Callable[[List[Any]], List[Any]]) -> Any:
    """Run one per-video device program, cross-video batched when the
    program coalescer is active (multi-video overlap).

    ``run_batch(payloads) -> results`` must batch the program over the
    group — stack inputs, ONE dispatch, ONE host fetch, split.  Calls with
    equal ``(kind, key)`` are batched together, so the key must pin every
    shape/static parameter of the program AND the parameter identity of
    any model involved.
    """
    co = _program_co
    if co is None:
        return run_batch([payload])[0]
    return co.submit((kind,) + tuple(key), 1, (payload, run_batch)).result()


def program_coalescing_active() -> bool:
    return _program_co is not None


def _activate_program_coalescer(max_wait_ms: float) -> Callable[[], None]:
    """Install the process-wide program coalescer; returns a deactivator.
    Nested activations (bench wraps, then run_pipeline_many wraps again)
    are no-ops that must not deactivate the outer one."""
    global _program_co
    with _program_co_lock:
        if _program_co is not None:
            return lambda: None
        co = _Coalescer(_run_program_group, max_total=16,
                        max_wait_ms=max_wait_ms)
        _program_co = co

    def deactivate() -> None:
        global _program_co
        with _program_co_lock:
            if _program_co is co:
                _program_co = None
        co.close()

    return deactivate

