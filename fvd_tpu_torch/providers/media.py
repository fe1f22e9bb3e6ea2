"""Media decode providers and frame caches: the counterpart of
``fvd_tpu/providers/media.py``.

Decode happens ONCE per run: ``VideoReader.sample`` returns a contiguous
``uint8[T, H, W, 3]`` RGB batch and every vision node consumes slices of it;
V1 uploads one frame tensor to the device and V3 gathers its frames from it
there (``_DeviceFrameCache``).

The JAX package decodes with OpenCV or a libav shim.  The port uses neither:
it reads raw-RGBA AVI, the layout OpenCV's libav writer gives for fourcc
``RGBA`` (``fvd_tpu_torch/utils/avi.py``), through ``mmap`` with random
access, and :func:`write_video` writes that layout.  A file in any other
container raises ``fvd_tpu_torch.utils.avi.UnsupportedVideo`` naming the
container.  Audio comes from an ffmpeg binary where one exists, else from a
sibling ``.wav`` next to the input, else none (the reference tolerates
missing audio, main.py:267-271).
The viz videos are PNG-in-AVI (fourcc ``png ``), which OpenCV reads
losslessly.
"""

from __future__ import annotations

import inspect
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fvd_tpu_torch.utils import avi


@dataclass
class VideoMeta:
    fps: float
    frame_count: int
    width: int
    height: int

    @property
    def duration(self) -> float:
        return self.frame_count / self.fps if self.fps else 0.0

    @property
    def size(self) -> Tuple[int, int]:
        return (self.width, self.height)


_identity_lock = threading.Lock()
_identity_memo: "dict[tuple, str]" = {}


def content_key(path: str) -> str:
    """Stable content identity for a media file (sha1 of the bytes).

    The frame / device-frame caches key on content, not path: every run
    copies its input into a fresh ``processed/video_<ts>/video.mp4``
    (reference behavior, main.py:60-62), so a path-keyed cache could never
    hit across runs of the same video.  Digests are memoized on (realpath,
    size, mtime_ns).
    """
    import hashlib

    try:
        real = os.path.realpath(path)
        st = os.stat(real)
    except OSError:
        return path
    memo_key = (real, st.st_size, st.st_mtime_ns)
    with _identity_lock:
        cached = _identity_memo.get(memo_key)
    if cached is not None:
        return cached
    h = hashlib.sha1()
    try:
        with open(real, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
    except OSError:
        return path
    key = f"content:{h.hexdigest()}:{st.st_size}"
    with _identity_lock:
        if len(_identity_memo) > 4096:
            _identity_memo.clear()
        _identity_memo[memo_key] = key
    return key


class _FrameCache:
    """Content-keyed decoded-frame cache shared across nodes and runs.

    V1 (1 fps) and V3 (5 fps) read the same video; without sharing, a run
    decodes the file more than once.  The cache holds {content_key ->
    {frame_id: rgb}} with per-key locks and evicts whole entries beyond a
    frame budget; it also memoizes the STACKED batch per sample grid, so an
    identical grid of a resident video is not stacked again.  Consumers never
    mutate sampled batches in place (viz draws copy; crops are read-only
    views).
    """

    def __init__(self, max_frames: int = 4096):
        self._frames: "dict[str, dict[int, np.ndarray]]" = {}
        self._meta: "dict[str, VideoMeta]" = {}
        self._stacks: "dict[str, dict[tuple, np.ndarray]]" = {}
        self._order: List[str] = []
        self._locks: "dict[str, threading.Lock]" = {}
        self._global = threading.Lock()
        self.max_frames = max_frames

    def lock_for(self, path: str):
        key = content_key(path)
        with self._global:
            if key not in self._locks:
                self._locks[key] = threading.Lock()
            return self._locks[key]

    def get_meta(self, path: str) -> Optional["VideoMeta"]:
        return self._meta.get(content_key(path))

    def put_meta(self, path: str, meta: "VideoMeta") -> None:
        self._meta[content_key(path)] = meta

    def lookup(self, path: str, ids: Sequence[int]):
        """Copy out cached frame refs for ``ids`` (under the global lock so a
        concurrent eviction can't tear the view). Returns (found, missing)."""
        key = content_key(path)
        with self._global:
            store = self._frames.get(key, {})
            found = {i: store[i] for i in ids if i in store}
        missing = [i for i in ids if i not in found]
        return found, missing

    def get_stack(self, path: str, ids: Sequence[int]) -> Optional[np.ndarray]:
        key = content_key(path)
        with self._global:
            return self._stacks.get(key, {}).get(tuple(ids))

    def put_stack(self, path: str, ids: Sequence[int], arr: np.ndarray) -> None:
        key = content_key(path)
        with self._global:
            per = self._stacks.setdefault(key, {})
            per[tuple(ids)] = arr
            while len(per) > 4:  # a video sees ~3 grids (union/5fps/1fps)
                per.pop(next(iter(per)))

    def insert(self, path: str, frames: np.ndarray, ids: Sequence[int]) -> None:
        key = content_key(path)
        with self._global:
            store = self._frames.setdefault(key, {})
            if key not in self._order:
                self._order.append(key)
            for f, i in zip(frames, ids):
                store[i] = f
            total = sum(len(s) for s in self._frames.values())
            while total > self.max_frames and len(self._order) > 1:
                victim = self._order.pop(0)
                if victim == key:
                    self._order.append(victim)
                    continue
                total -= len(self._frames.pop(victim, {}))
                self._meta.pop(victim, None)
                self._stacks.pop(victim, None)

    def clear(self) -> None:
        with self._global:
            self._frames.clear()
            self._meta.clear()
            self._stacks.clear()
            self._order.clear()


_frame_cache = _FrameCache()


def _accepts_device_frames_kwarg(provider) -> bool:
    """Does ``provider.landmarks_batch`` take a ``device_frames`` kwarg?"""
    try:
        sig = inspect.signature(provider.landmarks_batch)
    except (TypeError, ValueError):
        return False
    return any(p.name == "device_frames" or p.kind is inspect.Parameter.VAR_KEYWORD
               for p in sig.parameters.values())


class _LandmarkShare:
    """Cross-branch model-result sharing.

    V3 and V4 run the same landmark forward over the same sampled frames (the
    reference runs FAN twice, v3:130 and v4:131); the scheduler runs them
    concurrently, so they share one result per (path, provider, ids): the
    first arrival computes under a per-key lock, a concurrent branch blocks
    briefly and reuses.  Consumers treat landmark lists as read-only.
    """

    def __init__(self, max_entries: int = 64):
        self._results: "dict[tuple, tuple]" = {}
        self._locks: "dict[tuple, threading.Lock]" = {}
        self._order: List[tuple] = []
        self._global = threading.Lock()
        self.max_entries = max_entries
        #: landmark forwards run since the last :meth:`clear`
        self.forwards = 0

    def get(self, path: str, ids: Sequence[int], provider, frames: np.ndarray, device_frames=None,
            pose_pad=None):
        """Returns ``(lm_lists, pose_lists_or_None, entry_pad)``.

        With ``pose_pad`` given, device frames and a provider that has
        ``landmarks_pose_batch``, the shared forward computes landmarks and
        per-detection poses in one program (V3 drops the poses, V4 uses them).
        ``entry_pad`` is the pad the cached poses were computed with: a pose
        consumer asking for another pad runs its own pose forward.
        ``FVD_TPU_NO_FUSED_POSE`` (read at call time) turns the fused program
        off.
        """
        # full ids in the key; the entry keeps a strong ref to the provider so
        # a recycled id() can never alias a dead provider's results
        key = (path, id(provider), tuple(int(i) for i in ids))
        with self._global:
            lock = self._locks.setdefault(key, threading.Lock())
        with lock:
            with self._global:
                if key in self._results:
                    return self._results[key][1]
            if (pose_pad is not None and device_frames is not None
                    and hasattr(provider, "landmarks_pose_batch")
                    and not os.environ.get("FVD_TPU_NO_FUSED_POSE")):
                lm, poses = provider.landmarks_pose_batch(frames, device_frames=device_frames,
                                                          pose_pad=float(pose_pad))
                result = (lm, poses, float(pose_pad))
            elif _accepts_device_frames_kwarg(provider):
                result = (provider.landmarks_batch(frames, device_frames=device_frames), None, None)
            else:
                result = (provider.landmarks_batch(frames), None, None)
            with self._global:
                self.forwards += 1
                self._results[key] = (provider, result)
                self._order.append(key)
                while len(self._order) > self.max_entries:
                    victim = self._order.pop(0)
                    self._results.pop(victim, None)
                    self._locks.pop(victim, None)
            return result

    def clear(self) -> None:
        with self._global:
            self._results.clear()
            self._locks.clear()
            self._order.clear()
            self.forwards = 0


_landmark_share = _LandmarkShare()


class _DeviceFrameCache:
    """One device-resident uint8 frame tensor per (video, device, sample grid).

    Decode once on the host, upload once, and let every V-node consume
    device-side slices: V1 uploads the union sampling grid; V3 (and any other
    consumer of a subset grid) gets its frames by a gather on the device
    instead of a second host-to-device copy.  ``uploads`` and
    ``upload_bytes`` count the copies made since the last :meth:`clear`.
    """

    def __init__(self, max_bytes: int = 1 << 30):
        self._entries: "dict[tuple, list]" = {}  # (content, device) -> [(ids_tuple, tensor)]
        self._order: List[tuple] = []  # ((content, device), ids_tuple) LRU
        self._lock = threading.Lock()
        self.max_bytes = max_bytes
        self.uploads = 0
        self.upload_bytes = 0

    def get(self, path: str, ids: Sequence[int], frames_host=None, device=None):
        """Frames for ``ids`` of ``path`` on ``device`` (default the card), or
        None.  Served from an exact entry, gathered on the device from a
        superset entry, or uploaded from ``frames_host`` when provided."""
        from fvd_tpu_torch import resolve_device

        dev = resolve_device(device)
        key = (content_key(path), str(dev))  # entries are content-addressed
        ids_t = tuple(int(i) for i in ids)
        if not ids_t:
            return None
        with self._lock:
            for eids, arr in self._entries.get(key, []):
                if eids == ids_t:
                    return arr
                eset = {fid: i for i, fid in enumerate(eids)}
                if all(fid in eset for fid in ids_t):
                    pos = torch.tensor([eset[fid] for fid in ids_t], device=dev)
                    return arr.index_select(0, pos)
            if frames_host is None or len(frames_host) != len(ids_t):
                return None
            arr = torch.from_numpy(np.ascontiguousarray(frames_host)).to(dev)
            self.uploads += 1
            self.upload_bytes += arr.numel()
            self._entries.setdefault(key, []).append((ids_t, arr))
            self._order.append((key, ids_t))
            self._evict_locked()
            return arr

    def _evict_locked(self) -> None:
        def total() -> int:
            return sum(a.numel() * a.element_size() for es in self._entries.values() for _, a in es)

        while total() > self.max_bytes and len(self._order) > 1:
            key, ids_t = self._order.pop(0)
            self._entries[key] = [(e, a) for e, a in self._entries.get(key, []) if e != ids_t]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._order.clear()
            self.uploads = 0
            self.upload_bytes = 0


_device_frames = _DeviceFrameCache()


def device_frames_for(path: str, ids: Sequence[int], frames_host=None, device=None):
    """Device-resident frames for a sample grid (see _DeviceFrameCache)."""
    return _device_frames.get(path, ids, frames_host, device)


def shared_landmarks(path: str, ids: Sequence[int], provider, frames: np.ndarray,
                     device_frames=None, pose_pad=None):
    """Landmark forward for ``frames`` (sampled ``ids`` of ``path``), shared
    across concurrently-running nodes.  ``pose_pad`` (V4's crop pad) makes
    the shared forward compute V4's poses in the same program, so that V4
    reuses the entry."""
    if len(ids) == 0:
        return []
    return _landmark_share.get(path, ids, provider, frames, device_frames, pose_pad)[0]


def shared_landmarks_pose(path: str, ids: Sequence[int], provider, frames: np.ndarray,
                          device_frames=None, pose_pad: float = 0.0):
    """Like :func:`shared_landmarks` but returns ``(lm_lists, pose_lists)``;
    ``pose_lists`` is None where the shared entry has no poses (a provider
    without the fused program, ``FVD_TPU_NO_FUSED_POSE``, no device frames)
    or was computed with another pad: the caller then runs its own pose
    forward."""
    if len(ids) == 0:
        return [], None
    lm, poses, entry_pad = _landmark_share.get(path, ids, provider, frames, device_frames, pose_pad)
    if poses is not None and entry_pad == float(pose_pad):
        return lm, poses
    return lm, None


def _keyframe_source(path: str) -> Optional[Tuple[str, int]]:
    """``(video, frame id)`` of a V1 keyframe artifact
    ``<dir>/keyframes/frame_<id>.png`` (the run's video is ``<dir>/video.mp4``),
    or None for a name without a frame id."""
    digits = [t for t in os.path.basename(path).replace(".", "_").split("_") if t.isdigit()]
    if not digits:
        return None
    return os.path.join(os.path.dirname(os.path.dirname(path)), "video.mp4"), int(digits[0])


def cached_keyframe_images(paths: Sequence[str]) -> List[Optional[np.ndarray]]:
    """Raw frames for V1's keyframe artifacts (``<dir>/keyframes/frame_<id>.png``).

    Served from the host frame cache when the source video's decoded frames
    are still resident; else read from the PNG file."""
    from fvd_tpu_torch.utils.png import decode_png

    out: List[Optional[np.ndarray]] = []
    for p in paths:
        frame = None
        source = _keyframe_source(p)
        if source is not None:
            video, fid = source
            found, _ = _frame_cache.lookup(video, [fid])
            frame = found.get(fid)
        if frame is None and os.path.exists(p):
            with open(p, "rb") as f:
                frame = decode_png(f.read())[..., :3]
        out.append(frame)
    return out


def keyframe_device_frames(paths: Sequence[str], device=None):
    """Device-resident native frames for V1's keyframe artifacts, or None.

    Served by a gather on ``device`` (default the card) from the union grid V1
    uploaded (see ``_DeviceFrameCache``); never uploads.  Returns None unless
    every path maps into one cached video: callers then take the host batch
    path."""
    sources = [_keyframe_source(p) for p in paths]
    if not sources or None in sources or len({v for v, _ in sources}) != 1:
        return None
    return _device_frames.get(sources[0][0], [fid for _, fid in sources], device=device)


def clear_frame_cache() -> None:
    _frame_cache.clear()
    _landmark_share.clear()
    _device_frames.clear()


_EMPTY = np.zeros((0, 0, 0, 3), np.uint8)


class VideoReader:
    """Batched probe + frame sampling of raw-RGBA AVI files.

    Decoded frames are shared across nodes via a process-wide cache.
    """

    def __init__(self, use_cache: bool = True):
        self._cache = _frame_cache if use_cache else None

    def probe(self, path: str) -> Optional[VideoMeta]:
        """Metadata, or None for a missing or empty file; a file in another
        container raises ``UnsupportedVideo``."""
        if self._cache is not None:
            cached = self._cache.get_meta(path)
            if cached is not None:
                return cached
        if not os.path.exists(path):
            return None
        fps, frames, w, h = avi.probe(path)
        if fps <= 0 or frames <= 0:
            return None
        meta = VideoMeta(fps=fps, frame_count=frames, width=w, height=h)
        if self._cache is not None:
            self._cache.put_meta(path, meta)
        return meta

    def sample(self, path: str, frame_ids: Sequence[int]) -> Tuple[np.ndarray, List[int]]:
        """Read the requested frames -> (uint8 [T, H, W, 3] RGB, kept ids).

        Results are served from / folded into the shared frame cache so
        concurrent V-nodes read each file at most once."""
        wanted = sorted(set(int(i) for i in frame_ids))
        if self._cache is None:
            return self._sample_uncached(path, wanted)
        with self._cache.lock_for(path):
            found, missing = self._cache.lookup(path, wanted)
            if missing:
                frames, kept = self._sample_uncached(path, missing)
                # serve read frames directly — a concurrent eviction of this
                # path between insert and a re-lookup must not lose them
                found.update(dict(zip(kept, frames)))
                self._cache.insert(path, frames, kept)
            kept = [i for i in wanted if i in found]
            if not kept:
                return _EMPTY, []
            if not missing and not os.environ.get("FVD_TPU_NO_STACK_MEMO"):
                memo = self._cache.get_stack(path, kept)
                if memo is not None:
                    return memo, kept
            stacked = np.stack([found[i] for i in kept])
            if missing:
                # re-point the store at the stack's rows so the transient
                # read buffer isn't held alive as a duplicate copy
                self._cache.insert(path, stacked, kept)
            self._cache.put_stack(path, kept, stacked)
            return stacked, kept

    @staticmethod
    def _sample_uncached(path: str, frame_ids: Sequence[int]) -> Tuple[np.ndarray, List[int]]:
        if not os.path.exists(path):
            return _EMPTY, []
        frames, kept = avi.read_frames(path, frame_ids)
        return (frames, kept) if kept else (_EMPTY, [])

    def sample_at_fps(self, path: str, sample_fps: float) -> Tuple[np.ndarray, List[int], VideoMeta]:
        """Sample frames at ``sample_fps`` using the reference's stride rule
        (``v3:105-106``: stride = max(1, round(fps / target)))."""
        meta = self.probe(path)
        if meta is None:
            return _EMPTY, [], VideoMeta(0, 0, 0, 0)
        stride = max(1, int(round(meta.fps / sample_fps))) if meta.fps else 1
        ids = list(range(0, meta.frame_count, stride))
        frames, kept = self.sample(path, ids)
        return frames, kept, meta


class StreamingSampler:
    """Chunked frame sampling for long videos: yields ``(frames uint8
    [<=chunk, H, W, 3], kept_ids)`` batches, so memory stays bounded by the
    chunk size regardless of duration."""

    def __init__(self, path: str, frame_ids: Sequence[int], chunk_size: int = 512):
        self.path = path
        self.ids = sorted(set(int(i) for i in frame_ids))
        self.chunk_size = max(1, chunk_size)

    def __iter__(self):
        # Short videos (one chunk) go through the shared frame cache so
        # concurrent nodes sampling the same grid read the file once;
        # genuinely long videos stream uncached with bounded memory.
        if len(self.ids) <= self.chunk_size:
            frames, kept = VideoReader().sample(self.path, self.ids)
            if len(kept) > 0:
                yield frames, kept
            return
        for start in range(0, len(self.ids), self.chunk_size):
            frames, kept = VideoReader._sample_uncached(self.path, self.ids[start:start + self.chunk_size])
            if not kept:
                return
            yield frames, kept


class IncrementalVideoWriter:
    """Append-as-you-go PNG-in-AVI writer (viz artifacts for chunked
    processing), in one of two modes.

    * Cached (a ``cache_scope`` and the artifact cache on): appends queue
      their batches with a fingerprint of the drawn content; ``close()`` (or
      ``close_async()`` on the artifact pool) either writes the cached bytes
      of an identical earlier encode or draws and encodes once and stores
      them.
    * Streaming (no ``cache_scope``, or ``FVD_TPU_NO_ARTIFACT_CACHE`` set):
      batches go to an :class:`~fvd_tpu_torch.runtime.io_pool.AsyncFrameSink`,
      which draws and encodes them in order on its own thread; ``close()``
      flushes and raises any encode failure.

    A callable appended without a fingerprint cannot be identified, so it
    turns a cached writer into a streaming one; both modes write the same
    bytes.
    """

    def __init__(self, path: str, fps: float, cache_scope=None):
        """``cache_scope``: stable content identity (e.g. ``(content_key,
        node)``) for the cached mode."""
        from fvd_tpu_torch.runtime import io_pool

        self.path = path
        self.fps = fps
        self._writer: Optional[avi.AviWriter] = None
        #: True once any frames were appended: the file will exist (barring
        #: encode failure) even if close is deferred
        self.appended = False
        self._pending: list = []
        self._sink = None
        self._fp = None
        self._cache_scope = None
        if cache_scope is not None and io_pool.artifact_cache_enabled():
            import hashlib

            self._cache_scope = cache_scope
            self._fp = hashlib.blake2b(digest_size=16)
        else:
            self._sink = io_pool.AsyncFrameSink(self._write_batch, self._release)

    def _write_batch(self, frames_rgb: np.ndarray) -> None:
        from fvd_tpu_torch.runtime.tracer import get_tracer

        with get_tracer().span("artifact/viz", frames=len(frames_rgb)):
            if self._writer is None:
                self._writer = avi.AviWriter(self.path, self.fps, avi.FOURCC_PNG)
            self._writer.write_all(frames_rgb)

    def _release(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def append(self, frames_rgb, fingerprint: bytes | None = None) -> None:
        """RGB uint8 [T,H,W,3] batch, or a zero-arg callable returning one
        (drawing then happens when the writer closes, or on the sink's
        thread).

        ``fingerprint``: bytes pinning the drawn content of this batch, which
        identifies a repeated-content encode without running the draw; an
        array's own bytes where omitted.  A callable without one turns the
        writer to streaming.
        """
        if not callable(frames_rgb) and len(frames_rgb) == 0:
            return
        self.appended = True
        if self._cache_scope is not None:
            if fingerprint is None and callable(frames_rgb):
                self._degrade_to_streaming()
            else:
                if fingerprint is None:
                    fingerprint = np.ascontiguousarray(frames_rgb).tobytes()
                self._fp.update(fingerprint)
                self._pending.append(frames_rgb)
                return
        self._sink.append(frames_rgb)

    def _degrade_to_streaming(self) -> None:
        from fvd_tpu_torch.runtime.io_pool import AsyncFrameSink

        self._cache_scope = None
        self._sink = AsyncFrameSink(self._write_batch, self._release)
        for b in self._pending:
            self._sink.append(b)
        self._pending.clear()

    def _finish_cached(self) -> None:
        from fvd_tpu_torch.runtime import io_pool

        key = (self._cache_scope, round(self.fps, 3), self._fp.hexdigest())
        data = io_pool.viz_cache_get(key)
        if data is not None:
            with open(self.path, "wb") as f:
                f.write(data)
            self._pending.clear()
            return
        try:
            for b in self._pending:
                if callable(b):
                    b = b()
                if len(b):
                    self._write_batch(np.asarray(b))
        finally:
            self._pending.clear()
            self._release()
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                io_pool.viz_cache_put(key, f.read())

    def close(self) -> None:
        if self._cache_scope is not None:
            self._finish_cached()
            return
        self._sink.close()

    def close_async(self):
        """Deferred close: on the artifact pool in the cached mode, on the
        sink's thread in the streaming mode; a Future for
        ``runtime.io_pool.defer_artifact``."""
        if self._cache_scope is not None:
            from fvd_tpu_torch.runtime.io_pool import _get_pool

            return _get_pool().submit(self._finish_cached)
        return self._sink.close_async()


def write_video(path: str, frames: np.ndarray, fps: float) -> None:
    """RGB uint8 [T, H, W, 3] -> raw-RGBA AVI (test fixtures and clips):
    lossless, and what :class:`VideoReader` reads."""
    avi.write_avi(path, frames, fps)


def ffmpeg_bin() -> Optional[str]:
    return shutil.which("ffmpeg")


def extract_audio(video_path: str, out_wav: str, target_sr: int = 44100) -> Optional[str]:
    """Extract an audio track to WAV.

    Priority: ffmpeg binary -> sibling .wav next to the source video -> None
    (reference tolerates missing audio, main.py:267-271).  The JAX package
    tries its libav shim first; the port has none.
    """
    ff = ffmpeg_bin()
    if ff:
        proc = subprocess.run(
            [ff, "-y", "-i", video_path, "-ac", "2", "-f", "wav", out_wav],
            capture_output=True,
        )
        if proc.returncode == 0 and os.path.exists(out_wav):
            return out_wav
    sibling = os.path.splitext(video_path)[0] + ".wav"
    if os.path.exists(sibling):
        shutil.copy2(sibling, out_wav)
        return out_wav
    return None
