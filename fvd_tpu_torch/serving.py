"""Batched scoring service: the counterpart of ``fvd_tpu/serving.py``.

* :class:`MicroBatcher` — dynamic batching: requests queue up, a worker
  drains up to ``max_batch`` every ``max_wait_ms``, pads to the next
  power-of-two bucket, runs ONE batched call and hands results to futures.
* :class:`ScoringService` — per-video signal tracks (mouth MAR, audio
  envelope, the other eight features) scored by lip-sync + LR fusion, one
  stage-kernel launch per micro-batch and device over all its videos x
  windows.

With more than one device (by default every visible card) the service shards
each micro-batch over them, as the JAX package shards it over the mesh's
``data`` axis: the batch is padded to a multiple of the device count, each
device scores its slice, and the results come back in request order.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fvd_tpu_torch.ops import fusion
from fvd_tpu_torch.ops.lipsync import lip_sync_score_batch
from fvd_tpu_torch.parallel.mesh import check_devices, visible_devices


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class MicroBatcher:
    """Dynamic request batching onto a batched callable.

    ``batch_fn(inputs: list) -> list`` must accept a padded batch; padding
    uses the first request's input (results for pad slots are discarded).
    """

    def __init__(
        self,
        batch_fn: Callable[[List[Any]], List[Any]],
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
    ):
        self.batch_fn = batch_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._queue: "queue.Queue[Optional[Tuple[Any, Future]]]" = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._running = True
        self._closed = False
        self.batches_run = 0
        self.items_served = 0
        self._thread.start()

    def submit(self, item: Any) -> Future:
        fut: Future = Future()
        if self._closed:
            fut.set_exception(RuntimeError("MicroBatcher is closed"))
            return fut
        self._queue.put((item, fut))
        return fut

    def score(self, item: Any, timeout: Optional[float] = 60.0) -> Any:
        return self.submit(item).result(timeout=timeout)

    def close(self):
        self._closed = True
        self._running = False
        self._queue.put(None)
        self._thread.join(timeout=5)

    def _drain_pending(self):
        """Fail any requests still queued at shutdown instead of leaving
        their futures to time out."""
        while True:
            try:
                entry = self._queue.get_nowait()
            except queue.Empty:
                return
            if entry is not None:
                entry[1].set_exception(RuntimeError("MicroBatcher closed"))

    def _worker(self):
        while self._running:
            first = self._queue.get()
            if first is None:
                self._drain_pending()
                return
            batch = [first]
            t0 = time.monotonic()
            while len(batch) < self.max_batch:
                remaining = self.max_wait_s - (time.monotonic() - t0)
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._running = False
                    break
                batch.append(nxt)

            items = [b[0] for b in batch]
            futures = [b[1] for b in batch]
            # pad to a power-of-two bucket, as the reference bounds its compiles
            padded = list(items)
            target = min(_next_pow2(len(items)), self.max_batch)
            while len(padded) < target:
                padded.append(items[0])
            try:
                results = self.batch_fn(padded)
                self.batches_run += 1
                self.items_served += len(items)
                for fut, res in zip(futures, results):
                    fut.set_result(res)
            except Exception as e:  # the worker must outlive a failed batch
                for fut in futures:
                    fut.set_exception(e)
        self._drain_pending()


@dataclass
class ScoreRequest:
    """One video's scoring inputs.

    mouth: [N] MAR track on the fps grid; audio: [N] envelope;
    other_feats: [8] remaining feature values (order: speech_rate,
    pause_ratio, gesture, blink, jerk, texture, claim_rel, evidence_rel);
    all tracks must share the service's configured N and fps.
    """

    mouth: np.ndarray
    audio: np.ndarray
    other_feats: np.ndarray


class ScoringService:
    """Micro-batched fused scoring: lip-sync cross-correlation + LR fusion
    for a batch of videos per micro-batch.  ``devices`` (default: every
    visible card) score the shards of each micro-batch; a named card that
    is not present raises."""

    def __init__(
        self,
        weights: Dict[str, float],
        n: int,
        fps: float,
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        devices=None,
    ):
        self.devices = check_devices(visible_devices() if devices is None else devices)
        self.n = n
        self.fps = fps
        w, b = fusion.weights_to_vectors(weights)
        self._wb = {d: (torch.from_numpy(w).to(d), torch.from_numpy(b).to(d)) for d in self.devices}
        self.batcher = MicroBatcher(self._batch_fn, max_batch=max_batch, max_wait_ms=max_wait_ms)

    @torch.no_grad()
    def batch_program(self, mouth: torch.Tensor, audio: torch.Tensor, other: torch.Tensor):
        """[B, N], [B, N], [B, 8] on one of the service's devices ->
        (fake_probability [B], lip_sync_score [B])."""
        w, b = self._wb[mouth.device]
        lip = lip_sync_score_batch(mouth, audio, self.fps).score
        feats = torch.cat([other[:, :2], lip[:, None], other[:, 2:]], dim=1)
        return torch.sigmoid(feats @ w + b), lip

    def _batch_fn(self, items: List[ScoreRequest]) -> List[Dict[str, float]]:
        for it in items:
            if np.shape(it.mouth) != (self.n,) or np.shape(it.audio) != (self.n,):
                raise ValueError(f"ScoreRequest tracks must have shape ({self.n},), got "
                                 f"{np.shape(it.mouth)} and {np.shape(it.audio)}")
        n_req, k = len(items), len(self.devices)
        # the batch must divide evenly across the devices
        if n_req % k:
            items = items + [items[0]] * (k - n_req % k)
        host = [np.stack([getattr(i, f) for i in items]).astype(np.float32)
                for f in ("mouth", "audio", "other_feats")]
        per = len(items) // k
        outs = [self.batch_program(*(torch.from_numpy(h[j * per:(j + 1) * per]).to(d) for h in host))
                for j, d in enumerate(self.devices)]
        probs = np.concatenate([p.cpu().numpy() for p, _ in outs])[:n_req]
        lips = np.concatenate([l.cpu().numpy() for _, l in outs])[:n_req]
        return [{"fake_probability": float(p), "lip_sync_score": float(l)}
                for p, l in zip(probs, lips)]

    def score(self, request: ScoreRequest, timeout: Optional[float] = 60.0) -> Dict[str, float]:
        return self.batcher.score(request, timeout)

    def submit(self, request: ScoreRequest) -> Future:
        return self.batcher.submit(request)

    def close(self):
        self.batcher.close()
