"""Cross-video coalescing of model forwards and per-video device programs:
the port of ``fvd_tpu/providers/coalesce.py``.

Under multi-video overlap (many ``Scheduler.invoke`` calls at once, as
``batch.run_pipeline_many`` runs them) each pipeline issues its own small
device programs: per video one detector forward over the sample grid, one
landmark forward, one OCR and one CLIP forward, and the per-video programs
of the nodes.  This layer coalesces concurrent requests into single device
programs, the same dynamic-batching idea as
``fvd_tpu_torch.serving.MicroBatcher`` but for variable-length frame batches:
requests that arrive within the batching window are grouped by key (the op
and its frame geometry), concatenated (on the device when the inputs are
there), padded to a power-of-two bucket ladder (:func:`_pad_target`) so that
groups reuse a small fixed set of shapes, run as one forward, and the results
split back per request.  On the card, C1's group is one launch of
``csrc/lipsync_score.cu`` with one fetch of its results.

Only providers that run real device forwards (``accepts_device_frames`` or
``coalescable``) are wrapped; deterministic host fixtures gain nothing.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import defaultdict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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
            # goes, separate from the node spans' contention-inflated waits;
            # ``size`` is the group's items before padding.
            t0 = time.monotonic()
            with get_tracer().span(f"coalesce/{key[0]}", n=len(chunk), size=sum(r.size for r in chunk)):
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


def _shape_hw(frames) -> Tuple[int, int]:
    return (int(frames.shape[1]), int(frames.shape[2]))


def _pad_target(total: int, bucket: int, floor: int = 32) -> int:
    """Fixed-shape pad size for a group of ``total`` items.

    Power-of-two ladder clamped to ``[floor, bucket]``: staggered pipelines
    rarely fill the full bucket within the 6 ms batching window, and padding
    a 30-frame group to a 256-frame forward wastes ~8x the forward FLOPs
    and ~8x the result fetch.  The ladder keeps the shape count bounded at
    ``log2(bucket/floor)+1`` per op family; oversized groups run exact-shape
    (``run_group`` contract).
    """
    if total > bucket:
        return total
    floor = min(floor, bucket)
    return max(floor, min(bucket, 1 << max(0, (total - 1).bit_length())))


def _concat_pad_device(devs: Sequence[torch.Tensor], pad_to: int) -> torch.Tensor:
    """Concatenate device batches along dim 0 and zero-pad to ``pad_to``
    (item shape, dtype and device taken from the inputs)."""
    total = sum(int(d.shape[0]) for d in devs)
    parts = list(devs)
    if pad_to > total:
        parts.append(torch.zeros((pad_to - total, *devs[0].shape[1:]), dtype=devs[0].dtype,
                                 device=devs[0].device))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _concat_pad_host(frames_list: Sequence[np.ndarray], pad_to: int) -> np.ndarray:
    total = sum(len(f) for f in frames_list)
    first = np.asarray(frames_list[0])
    out = np.zeros((max(pad_to, total), *first.shape[1:]), first.dtype)
    o = 0
    for f in frames_list:
        out[o : o + len(f)] = f
        o += len(f)
    return out


class CoalescingDetector:
    """FaceDetectorProvider wrapper: coalesce concurrent ``detect_batch``
    calls (V1's per-video sample grids) into fixed-bucket forwards.  Like
    every wrapper here it exposes the inner provider's ``device``, where the
    nodes put the frame tensors it reads."""

    def __init__(self, inner, bucket_frames: int = 256, max_wait_ms: float = 6.0):
        self.inner = inner
        self.model_name = inner.model_name
        self.device = getattr(inner, "device", None)
        self.accepts_device_frames = getattr(inner, "accepts_device_frames", False)
        self.bucket_frames = bucket_frames
        self._co = _Coalescer(self._run_group, max_total=bucket_frames,
                              max_wait_ms=max_wait_ms)

    def detect_batch(self, frames) -> List[list]:
        n = len(frames)
        if n == 0:
            return []
        is_dev = not isinstance(frames, np.ndarray)
        key = ("det", _shape_hw(frames), is_dev)
        return self._co.submit(key, n, frames).result()

    def _run_group(self, key: tuple, payloads: List[Any]) -> List[List[list]]:
        _, (h, w), is_dev = key
        lengths = [int(len(p)) for p in payloads]
        total = sum(lengths)
        pad_to = _pad_target(total, self.bucket_frames)
        if is_dev:
            cat = _concat_pad_device(payloads, pad_to)
        else:
            cat = _concat_pad_host(payloads, pad_to)
        res = self.inner.detect_batch(cat)
        out, o = [], 0
        for n in lengths:
            out.append(res[o : o + n])
            o += n
        return out

    def close(self) -> None:
        self._co.close()


class CoalescingLandmarks:
    """LandmarkProvider wrapper: coalesce concurrent landmark / pose
    forwards across overlapped videos.

    * ``landmarks_batch``: frame batches concatenate (device-side when
      device-resident) and pad to ``bucket_frames`` — detector + landmark
      forwards inside the inner provider then run once for the whole group
      at one fixed shape.
    * ``landmarks_pose_batch``: the same, with V4's pose in the program.
    * ``pose_boxes_batch``: per-video frame tensors concatenate with owner
      offsets; one crop+pose forward per group.
    * ``pose_batch`` passes through (host-crop fallback path, not hot).
    """

    def __init__(self, inner, bucket_frames: int = 512, max_wait_ms: float = 6.0):
        self.inner = inner
        self.model_name = inner.model_name
        self.device = getattr(inner, "device", None)
        self.accepts_device_frames = getattr(inner, "accepts_device_frames", False)
        self.bucket_frames = bucket_frames
        self._co = _Coalescer(self._run_group, max_total=bucket_frames,
                              max_wait_ms=max_wait_ms)
        if not hasattr(inner, "pose_boxes_batch"):
            # V4 feature-detects this attribute (None disables the fused path)
            self.pose_boxes_batch = None  # type: ignore[assignment]

    # -- landmark stage ----------------------------------------------------
    def landmarks_batch(self, frames: np.ndarray,
                        device_frames=None) -> List[List[np.ndarray]]:
        n = len(frames)
        if n == 0:
            return []
        key = ("lm", _shape_hw(frames), device_frames is not None)
        return self._co.submit(key, n, (frames, device_frames)).result()

    # -- fused landmark+pose stage ----------------------------------------
    def landmarks_pose_batch(self, frames: np.ndarray, device_frames=None,
                             pose_pad: float = 0.0):
        """Coalesced fused landmarks+pose (see the inner provider's
        ``landmarks_pose_batch``): overlapped videos' chunks merge into ONE
        crop+hourglass+pose forward."""
        n = len(frames)
        if n == 0:
            return [], []
        inner_fn = getattr(self.inner, "landmarks_pose_batch", None)
        if device_frames is None or not self.accepts_device_frames:
            if inner_fn is None:
                return self.landmarks_batch(frames), None
            return inner_fn(frames, device_frames=None, pose_pad=pose_pad)
        if inner_fn is None:  # device inner without the fused program
            return (self.landmarks_batch(frames, device_frames=device_frames),
                    None)
        key = ("lmpose", _shape_hw(frames), float(pose_pad))
        return self._co.submit(key, n, (frames, device_frames)).result()

    # -- pose stage --------------------------------------------------------
    def pose_boxes_batch(self, device_frames, boxes, owners) -> np.ndarray:
        if len(boxes) == 0:
            return np.zeros((0, 3))
        key = ("pose", (int(device_frames.shape[1]), int(device_frames.shape[2])))
        return self._co.submit(
            key, int(device_frames.shape[0]), (device_frames, boxes, owners)
        ).result()

    def pose_batch(self, crops: np.ndarray) -> np.ndarray:
        return self.inner.pose_batch(crops)

    # -- group runners -----------------------------------------------------
    def _run_group(self, key: tuple, payloads: List[Any]) -> List[Any]:
        if key[0] == "lm":
            return self._run_lm(key, payloads)
        if key[0] == "lmpose":
            return self._run_lmpose(key, payloads)
        return self._run_pose(key, payloads)

    def _run_lmpose(self, key: tuple, payloads: List[Any]) -> List[Any]:
        _, (h, w), pose_pad = key
        lengths = [int(len(f)) for f, _ in payloads]
        total = sum(lengths)
        pad_to = _pad_target(total, self.bucket_frames)
        dev = _concat_pad_device([d for _, d in payloads], pad_to)
        proxy = np.broadcast_to(np.zeros((1, h, w, 3), np.uint8),
                                (pad_to, h, w, 3))
        lm_all, pose_all = self.inner.landmarks_pose_batch(
            proxy, device_frames=dev, pose_pad=pose_pad)
        out, o = [], 0
        for n in lengths:
            out.append((lm_all[o:o + n],
                        None if pose_all is None else pose_all[o:o + n]))
            o += n
        return out

    def _run_lm(self, key: tuple, payloads: List[Any]) -> List[Any]:
        _, (h, w), has_dev = key
        lengths = [int(len(f)) for f, _ in payloads]
        total = sum(lengths)
        pad_to = _pad_target(total, self.bucket_frames)
        if has_dev and self.accepts_device_frames:
            dev = _concat_pad_device([d for _, d in payloads], pad_to)
            # the inner provider reads host frames only for their count and
            # (h, w) when a device tensor is supplied: a zero-copy broadcast
            # view stands in for the pixels
            proxy = np.broadcast_to(np.zeros((1, h, w, 3), np.uint8),
                                    (pad_to, h, w, 3))
            res = self.inner.landmarks_batch(proxy, device_frames=dev)
        else:
            cat = _concat_pad_host([f for f, _ in payloads], pad_to)
            res = self.inner.landmarks_batch(cat)
        out, o = [], 0
        for n in lengths:
            out.append(res[o : o + n])
            o += n
        return out

    def _run_pose(self, key: tuple, payloads: List[Any]) -> List[np.ndarray]:
        frame_counts = [int(d.shape[0]) for d, _, _ in payloads]
        total = sum(frame_counts)
        pad_to = _pad_target(total, self.bucket_frames)
        dev = _concat_pad_device([d for d, _, _ in payloads], pad_to)
        boxes_all: List[Any] = []
        owners_all: List[int] = []
        offset = 0
        for (d, boxes, owners), n in zip(payloads, frame_counts):
            boxes_all.extend(boxes)
            owners_all.extend(int(o) + offset for o in owners)
            offset += n
        res = np.asarray(self.inner.pose_boxes_batch(dev, boxes_all, owners_all))
        out, o = [], 0
        for _, boxes, _ in payloads:
            out.append(res[o : o + len(boxes)])
            o += len(boxes)
        return out

    def close(self) -> None:
        self._co.close()


class CoalescingOCR:
    """OCRProvider wrapper: concurrent videos' keyframe sets merge into one
    detector forward at a fixed image bucket (the recognizer batches over
    whatever regions the group produced, as the inner provider already
    does)."""

    def __init__(self, inner, bucket_images: int = 256, max_wait_ms: float = 6.0):
        self.inner = inner
        self.model_name = inner.model_name
        self.device = getattr(inner, "device", None)
        self.bucket_images = bucket_images
        self._co = _Coalescer(self._run_group, max_total=bucket_images,
                              max_wait_ms=max_wait_ms)

    def read_text(self, image: np.ndarray):
        return self.read_text_batch([image])[0]

    def read_text_batch(self, images) -> List[list]:
        if len(images) == 0:
            return []
        return self._co.submit(("ocr",), len(images), list(images)).result()

    def read_text_batch_device(self, dev_frames, images) -> List[list]:
        if len(images) == 0:
            return []
        if getattr(self.inner, "read_text_batch_device", None) is None:
            return self.read_text_batch(images)
        key = ("ocrdev", _shape_hw(dev_frames))
        return self._co.submit(key, len(images), (dev_frames, list(images))).result()

    def _run_group(self, key: tuple, payloads: List[Any]) -> List[Any]:
        if key[0] == "ocrdev":
            return self._run_device(payloads)
        lengths = [len(p) for p in payloads]
        merged: List[np.ndarray] = [im for p in payloads for im in p]
        total = len(merged)
        pad_to = _pad_target(total, self.bucket_images)
        # pad with tiny blank frames so the detector batch hits one compiled
        # shape; their (empty) results are dropped on split
        merged.extend(np.zeros((8, 8, 3), np.uint8) for _ in range(pad_to - total))
        res = self.inner.read_text_batch(merged)
        out, o = [], 0
        for n in lengths:
            out.append(res[o : o + n])
            o += n
        return out

    def _run_device(self, payloads: List[tuple]) -> List[Any]:
        """Device-resident variant: device batches concatenate on the device
        (no host traffic); the padded tail's masks decode to nothing and are
        dropped on split."""
        lengths = [len(ims) for _, ims in payloads]
        total = sum(lengths)
        pad_to = _pad_target(total, self.bucket_images)
        dev = _concat_pad_device([d for d, _ in payloads], pad_to)
        images: List[np.ndarray] = [im for _, ims in payloads for im in ims]
        images.extend(
            np.zeros(images[0].shape, np.uint8) for _ in range(pad_to - total)
        )
        res = self.inner.read_text_batch_device(dev, images)
        out, o = [], 0
        for n in lengths:
            out.append(res[o : o + n])
            o += n
        return out

    def close(self) -> None:
        self._co.close()


class CoalescingClip:
    """ClipProvider wrapper: paired (image, text) similarity requests from
    concurrent videos merge into one dual-tower forward at a fixed bucket."""

    def __init__(self, inner, bucket_pairs: int = 256, max_wait_ms: float = 6.0):
        self.inner = inner
        self.model_name = getattr(inner, "model_name", type(inner).__name__)
        self.device = getattr(inner, "device", None)
        self.bucket_pairs = bucket_pairs
        self._co = _Coalescer(self._run_group, max_total=bucket_pairs,
                              max_wait_ms=max_wait_ms)

    def image_text_similarity(self, image: np.ndarray, text: str) -> float:
        return float(self.image_text_similarity_batch([image], [text])[0])

    def image_text_similarity_batch(self, images, texts) -> np.ndarray:
        if len(images) == 0:
            return np.zeros((0,), np.float32)
        return self._co.submit(
            ("clip",), len(images), (list(images), list(texts))
        ).result()

    def _run_group(self, key: tuple, payloads: List[tuple]) -> List[np.ndarray]:
        lengths = [len(im) for im, _ in payloads]
        images: List[np.ndarray] = [im for ims, _ in payloads for im in ims]
        texts: List[str] = [t for _, ts in payloads for t in ts]
        total = len(images)
        pad_to = _pad_target(total, self.bucket_pairs)
        images.extend(np.zeros((8, 8, 3), np.uint8) for _ in range(pad_to - total))
        texts.extend("" for _ in range(pad_to - total))
        sims = np.asarray(self.inner.image_text_similarity_batch(images, texts))
        out, o = [], 0
        for n in lengths:
            out.append(sims[o : o + n])
            o += n
        return out

    def close(self) -> None:
        self._co.close()


# ---------------------------------------------------------------------------
# Cross-video coalescing of per-video OPS programs (A1, A2's npz decode, A3, V5, C1)
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



def coalesce_providers(providers, bucket_frames: int = 512,
                       detect_bucket_frames: int = 256,
                       max_wait_ms: float = 6.0):
    """Wrap the device-forward providers of a bundle for cross-video
    coalescing and activate the program coalescer.  Returns ``(providers,
    close)``; only providers that run real device forwards
    (``accepts_device_frames`` for the detector and landmarks, ``coalescable``
    for OCR and CLIP) are wrapped, and deterministic host fixtures pass
    through untouched.  A bundle already wrapped comes back as it is;
    ``FVD_TPU_NO_COALESCE`` turns all of it off and
    ``FVD_TPU_COALESCE_WAIT_MS`` sets the batching window.
    """
    import dataclasses

    if os.environ.get("FVD_TPU_NO_COALESCE"):
        return providers, lambda: None

    # A/B lever: the batching window trades per-request latency for fewer
    # device dispatches.
    max_wait_ms = float(os.environ.get("FVD_TPU_COALESCE_WAIT_MS", max_wait_ms))

    wrapped: List[Any] = []
    changes: Dict[str, Any] = {}
    lm = getattr(providers, "landmarks", None)
    if (
        isinstance(lm, CoalescingLandmarks)
        or isinstance(getattr(providers, "face_detector", None), CoalescingDetector)
        or isinstance(getattr(providers, "ocr", None), CoalescingOCR)
        or isinstance(getattr(providers, "clip", None), CoalescingClip)
    ):
        return providers, lambda: None  # already coalescing (idempotent)

    # per-video ops programs (audio chain, lip-sync) coalesce regardless of
    # which providers are wrapped — they run for fixture bundles too
    deactivate_programs = _activate_program_coalescer(max_wait_ms)
    if lm is not None and getattr(lm, "accepts_device_frames", False):
        clm = CoalescingLandmarks(lm, bucket_frames=bucket_frames,
                                  max_wait_ms=max_wait_ms)
        changes["landmarks"] = clm
        wrapped.append(clm)
    det = getattr(providers, "face_detector", None)
    if det is not None and getattr(det, "accepts_device_frames", False):
        cdet = CoalescingDetector(det, bucket_frames=detect_bucket_frames,
                                  max_wait_ms=max_wait_ms)
        changes["face_detector"] = cdet
        wrapped.append(cdet)
    ocr = getattr(providers, "ocr", None)
    if ocr is not None and getattr(ocr, "coalescable", False):
        cocr = CoalescingOCR(ocr, max_wait_ms=max_wait_ms)
        changes["ocr"] = cocr
        wrapped.append(cocr)
    clip = getattr(providers, "clip", None)
    if clip is not None and getattr(clip, "coalescable", False):
        cclip = CoalescingClip(clip, max_wait_ms=max_wait_ms)
        changes["clip"] = cclip
        wrapped.append(cclip)

    if not changes:
        return providers, deactivate_programs
    out = dataclasses.replace(providers, **changes)

    def close() -> None:
        deactivate_programs()
        for w in wrapped:
            w.close()

    return out, close
