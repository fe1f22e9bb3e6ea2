"""The port's A/B switches and its streaming viz writer against the JAX
package's: ``FVD_TPU_NO_ARTIFACT_CACHE`` (``tests/test_artifact_cache.py:41``),
``FVD_TPU_NO_FUSED_POSE`` (``tests/test_frame_cache.py:245``),
``FVD_TPU_NO_STACK_MEMO`` and ``FVD_TPU_NO_DEVICE_OCR`` (V2's device path,
``tests/test_ocr_device_path.py``), each read at call time; the
``AsyncFrameSink`` cases of ``tests/test_io_pool.py:41-92``; and the
``IncrementalVideoWriter``'s streaming and downgrade modes
(``tests/test_artifact_cache.py:101``, ``tests/test_io_pool.py:128``).  Where
a case runs in both packages, the same assertions hold for each."""

import os
import time
import types

import numpy as np
import pytest
import torch

from fvd_tpu.nodes import v2_ocr as jv2
from fvd_tpu.providers import media as jmedia
from fvd_tpu.runtime import io_pool as jio
from fvd_tpu_torch.nodes import v2_ocr as tv2
from fvd_tpu_torch.providers import media as tmedia
from fvd_tpu_torch.runtime import io_pool as tio
from fvd_tpu_torch.runtime.io_pool import AsyncFrameSink, defer_artifact, flush_artifacts
from fvd_tpu_torch.utils import avi, png

PACKAGES = {"jax": (jmedia, jio), "torch": (tmedia, tio)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_caches():
    for media, io_pool in PACKAGES.values():
        media.clear_frame_cache()
        io_pool.clear_artifact_caches()
    yield
    for media, io_pool in PACKAGES.values():
        media.clear_frame_cache()
        io_pool.clear_artifact_caches()


def _frame(seed, hw=(48, 64)):
    return np.random.RandomState(seed).randint(0, 255, (*hw, 3)).astype(np.uint8)


def _read_png_avi(path):
    """The frames of a PNG-in-AVI, walked with ``utils/avi.py`` and decoded
    with ``utils/png.py``, and the stream's fps."""
    f, mm = avi._open(path)
    with f, mm:
        frames, fps = [], None
        for tag, off, size in avi._walk(mm, 12, len(mm)):
            if tag == b"LIST" and bytes(mm[off:off + 4]) == b"movi":
                frames = [png.decode_png(bytes(mm[o:o + s]))
                          for t, o, s in avi._walk(mm, off + 4, off + size) if t == b"00dc"]
            elif tag == b"LIST" and bytes(mm[off:off + 4]) == b"hdrl":
                for t, o, s in avi._walk(mm, off + 4, off + size):
                    if t == b"LIST" and bytes(mm[o:o + 4]) == b"strl":
                        for t2, o2, _ in avi._walk(mm, o + 4, o + s):
                            if t2 == b"strh" and fps is None:
                                scale, rate = np.frombuffer(mm, np.uint32, 2, o2 + 20)
                                fps = rate / scale
    return np.stack(frames), fps


# ---------------------------------------------------------------------------
# FVD_TPU_NO_ARTIFACT_CACHE
# ---------------------------------------------------------------------------
def test_artifact_cache_disabled_by_env(tmp_path, monkeypatch):
    """``tests/test_artifact_cache.py:41``: with the switch set, a keyed
    keyframe encode stores nothing and the viz cache neither serves nor
    stores; unset again, it does both."""
    monkeypatch.setenv("FVD_TPU_NO_ARTIFACT_CACHE", "1")
    assert not tio.artifact_cache_enabled()
    tio._encode_png(str(tmp_path / "x.png"), _frame(1), key=("k",))
    assert tio._png_cache.get(("k",)) is None
    assert png.decode_png(open(tmp_path / "x.png", "rb").read()).tolist() == _frame(1).tolist()
    tio._viz_cache.put(("v",), b"bytes")
    assert tio.viz_cache_get(("v",)) is None
    tio.viz_cache_put(("w",), b"bytes")
    monkeypatch.delenv("FVD_TPU_NO_ARTIFACT_CACHE")
    assert tio.viz_cache_get(("v",)) == b"bytes" and tio.viz_cache_get(("w",)) is None
    tio._encode_png(str(tmp_path / "y.png"), _frame(1), key=("k",))
    assert tio._png_cache.get(("k",)) == open(tmp_path / "y.png", "rb").read()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_viz_writer_streams_when_the_cache_is_off(tmp_path, monkeypatch, pkg):
    """Under ``FVD_TPU_NO_ARTIFACT_CACHE`` a writer given a cache scope
    streams: callables without fingerprints are drawn on the sink's thread,
    nothing enters the viz cache."""
    media, io_pool = PACKAGES[pkg]
    monkeypatch.setenv("FVD_TPU_NO_ARTIFACT_CACHE", "1")
    frames = np.stack([_frame(i) for i in range(3)])
    w = media.IncrementalVideoWriter(str(tmp_path / "s.avi"), 4.0, cache_scope=("ck", "V3"))
    assert w._sink is not None and w._cache_scope is None
    w.append(lambda: frames)
    w.close()
    assert w.appended and os.path.getsize(tmp_path / "s.avi") > 0
    assert io_pool._viz_cache._data == {}


# ---------------------------------------------------------------------------
# FVD_TPU_NO_FUSED_POSE
# ---------------------------------------------------------------------------
class _FusedProvider:
    """``tests/test_frame_cache.py``'s provider: counts forwards, has the
    fused landmark+pose program."""

    model_name = "fused_fake"
    accepts_device_frames = True

    def __init__(self):
        self.lm_calls = 0
        self.fused_calls = 0

    def landmarks_batch(self, frames, device_frames=None):
        self.lm_calls += 1
        return [[np.zeros((68, 2))] for _ in frames]

    def landmarks_pose_batch(self, frames, device_frames=None, pose_pad=0.0):
        self.fused_calls += 1
        return ([[np.zeros((68, 2))] for _ in frames], [[np.array([1.0, 2.0, pose_pad])] for _ in frames])


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("off", [False, True])
def test_shared_landmarks_fused_pose_switch(monkeypatch, pkg, off):
    """``tests/test_frame_cache.py:245``: ``FVD_TPU_NO_FUSED_POSE`` sends the
    shared forward to ``landmarks_batch`` and gives no poses."""
    media, _ = PACKAGES[pkg]
    if off:
        monkeypatch.setenv("FVD_TPU_NO_FUSED_POSE", "1")
    prov = _FusedProvider()
    _, poses = media.shared_landmarks_pose("vidB", [0, 1], prov, np.zeros((2, 8, 8, 3), np.uint8), object(),
                                           pose_pad=0.1)
    assert (poses is None) == off
    assert (prov.fused_calls, prov.lm_calls) == ((0, 1) if off else (1, 0))


# ---------------------------------------------------------------------------
# FVD_TPU_NO_STACK_MEMO
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("off", [False, True])
def test_stack_memo_switch(tmp_path, monkeypatch, pkg, off):
    """A warm re-sample of one grid returns the memoized stack
    (``tests/test_frame_cache.py:46``); under ``FVD_TPU_NO_STACK_MEMO`` it
    stacks afresh, the same pixels."""
    media, _ = PACKAGES[pkg]
    path = str(tmp_path / "v.mp4")
    frames = np.zeros((30, 48, 64, 3), np.uint8)
    for i in range(30):
        frames[i, :, :, 0] = i * 8
    media.write_video(path, frames, 10.0)
    reader = media.VideoReader()
    f1, k1 = reader.sample(path, [0, 6, 12])
    if off:
        monkeypatch.setenv("FVD_TPU_NO_STACK_MEMO", "1")
    f2, k2 = reader.sample(path, [0, 6, 12])
    assert k1 == k2 == [0, 6, 12]
    assert (f2 is f1) != off
    np.testing.assert_array_equal(f1, f2)


# ---------------------------------------------------------------------------
# FVD_TPU_NO_DEVICE_OCR
# ---------------------------------------------------------------------------
class _ScriptedOCR:
    """Reads one word per image and records which of V2's paths it took."""

    model_name = "scripted_ocr"
    device = "cpu"

    def __init__(self):
        self.paths = []

    def read_text_batch(self, images):
        self.paths.append("host")
        return [[{"text": "HOST", "confidence": 0.9, "bbox": [[0, 0], [4, 0], [4, 4], [0, 4]]}] for _ in images]

    def read_text_batch_device(self, dev, images):
        self.paths.append("device")
        return [[{"text": "DEVICE", "confidence": 0.9, "bbox": [[0, 0], [4, 0], [4, 4], [0, 4]]}] for _ in images]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("off", [False, True])
def test_device_ocr_switch(monkeypatch, pkg, off):
    """V2 reads the keyframes off V1's device frames where they are resident;
    ``FVD_TPU_NO_DEVICE_OCR`` sends it to the host batch path instead."""
    node = {"jax": jv2, "torch": tv2}[pkg]
    images = [_frame(3), _frame(4)]
    if pkg == "jax":
        monkeypatch.setattr(jmedia, "cached_keyframe_images", lambda kfs: images)
        monkeypatch.setattr(jmedia, "keyframe_device_frames", lambda kfs, **_: np.stack(images))
    else:
        monkeypatch.setattr(tv2, "cached_keyframe_images", lambda kfs: images)
        monkeypatch.setattr(tv2, "keyframe_device_frames", lambda kfs, **_: torch.from_numpy(np.stack(images)))
    if off:
        monkeypatch.setenv("FVD_TPU_NO_DEVICE_OCR", "1")
    ocr = _ScriptedOCR()
    delta = node.run({"keyframes": ["a/keyframes/frame_0.png", "a/keyframes/frame_5.png"]},
                     providers=types.SimpleNamespace(ocr=ocr))
    want = "HOST" if off else "DEVICE"
    assert ocr.paths == [want.lower()]
    assert [r["detections"][0]["text"] for r in delta["ocr_results"]] == [want, want]


# ---------------------------------------------------------------------------
# AsyncFrameSink (tests/test_io_pool.py:41-92)
# ---------------------------------------------------------------------------
def test_async_frame_sink_preserves_order_and_flushes():
    seen, closed = [], []
    sink = AsyncFrameSink(lambda b: seen.append(b.copy()), lambda: closed.append(True), maxsize=2)
    for i in range(5):
        sink.append(np.full((2, 4, 4, 3), i, np.uint8))
    sink.append(np.zeros((0, 4, 4, 3), np.uint8))  # an empty batch is a no-op
    sink.append(lambda: np.full((1, 4, 4, 3), 5, np.uint8))  # drawn on the sink's thread
    sink.close()
    assert closed == [True]
    assert [b[0, 0, 0, 0] for b in seen] == [0, 1, 2, 3, 4, 5]


def test_async_frame_sink_raises_worker_error_on_close():
    def bad_write(_):
        raise ValueError("encode failed")

    sink = AsyncFrameSink(bad_write, lambda: None)
    sink.append(np.zeros((1, 4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="encode failed"):
        sink.close()


def test_async_frame_sink_close_async_resolves_after_flush():
    seen, closed = [], []

    def slow_write(b):
        time.sleep(0.05)
        seen.append(b.copy())

    sink = AsyncFrameSink(slow_write, lambda: closed.append(True))
    sink.append(np.zeros((2, 4, 4, 3), np.uint8))
    sink.close_async().result(timeout=5)
    assert len(seen) == 1 and closed == [True]


def test_close_async_surfaces_worker_error_via_future():
    def bad_write(_):
        raise ValueError("encode failed")

    sink = AsyncFrameSink(bad_write, lambda: None)
    sink.append(np.zeros((1, 4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="encode failed"):
        sink.close_async().result(timeout=5)


# ---------------------------------------------------------------------------
# the viz writer's streaming and downgrade modes
# ---------------------------------------------------------------------------
def _cached_file(path, frames, fps):
    w = tmedia.IncrementalVideoWriter(str(path), fps, cache_scope=("ref", "V3"))
    w.append(frames)
    w.close()
    return open(path, "rb").read()


def test_viz_writer_streams_without_a_cache_scope(tmp_path):
    """``tests/test_io_pool.py:128``: no cache scope, batches appended as
    they come and flushed through ``defer_artifact``; the file holds every
    frame in order, byte-equal to the cached mode's file of the same
    frames."""
    frames = np.stack([_frame(i) for i in range(6)])
    path = str(tmp_path / "viz.avi")
    w = tmedia.IncrementalVideoWriter(path, 5.0)
    for i in range(3):
        w.append(frames[2 * i:2 * i + 2])
    assert w.appended
    defer_artifact(str(tmp_path), w.close_async())
    assert flush_artifacts(str(tmp_path)) == []
    got, fps = _read_png_avi(path)
    assert np.array_equal(got, frames) and fps == 5.0
    assert open(path, "rb").read() == _cached_file(tmp_path / "ref.avi", frames, 5.0)


def test_viz_writer_downgrades_without_a_fingerprint(tmp_path):
    """``tests/test_artifact_cache.py:101``: a callable without a
    fingerprint turns a cached writer to streaming, which writes the file
    (the port raised ``ValueError`` here before); the batches queued before
    it keep their place, and the bytes equal the cached mode's."""
    frames = np.stack([_frame(i) for i in range(5)])
    path = str(tmp_path / "e.avi")
    w = tmedia.IncrementalVideoWriter(path, 4.0, cache_scope=("ck3", "V3"))
    w.append(frames[:2], fingerprint=b"fp0")
    assert w._sink is None
    w.append(lambda: frames[2:4])
    assert w._sink is not None and w._cache_scope is None
    w.append(lambda: frames[4:], fingerprint=b"fp1")
    w.close()
    got, fps = _read_png_avi(path)
    assert np.array_equal(got, frames) and fps == 4.0
    assert tio._viz_cache._data == {}
    assert open(path, "rb").read() == _cached_file(tmp_path / "ref.avi", frames, 4.0)
