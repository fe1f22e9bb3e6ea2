"""Video and artifact I/O of the port against OpenCV and the JAX package:
raw-RGBA AVI both ways between cv2 and the port, PNG artifacts, the frame
caches, the device frame upload, and the IN node.  Mirrors
``tests/test_ingest.py`` and ``tests/test_frame_cache.py``.

The JAX package decodes with its libav shim where ``native/libfvd_decode.so``
is built, else with cv2; both readers are held here, so the tests pass with
and without the shim.  Pixels and WAV samples are compared bit for bit."""

import os
import threading

import cv2
import numpy as np
import pytest
import torch

from fvd_tpu.nodes import ingest as jingest
from fvd_tpu.providers import media as jmedia
from fvd_tpu.providers import native_decode
from fvd_tpu.state import State as JState
from fvd_tpu.utils import wav as jwav
from fvd_tpu_torch.nodes import ingest as tingest
from fvd_tpu_torch.providers import media as tmedia
from fvd_tpu_torch.runtime import io_pool
from fvd_tpu_torch.state import State as TState
from fvd_tpu_torch.utils import avi, png
from fvd_tpu_torch.utils import wav as twav


@pytest.fixture(autouse=True)
def fresh_cache():
    tmedia.clear_frame_cache()
    io_pool.clear_artifact_caches()
    yield
    tmedia.clear_frame_cache()


def _frames(t=12, h=36, w=50, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (t, h, w, 3), dtype=np.uint8)


def _cv2_read(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    meta = (cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    return np.stack(out), meta


def _jax_readers():
    readers = [("cv2", jmedia.VideoReader(prefer_native=False, use_cache=False))]
    if native_decode.available():
        readers.append(("libav", jmedia.VideoReader(prefer_native=True, use_cache=False)))
    return readers


# ---------------------------------------------------------------------------
# raw-RGBA AVI, both ways
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fps,shape", [(30.0, (12, 36, 50)), (10.0, (5, 240, 320)), (29.97, (4, 17, 23)),
                                       (12.5, (3, 8, 8))])
def test_port_avi_reads_bit_exact_in_cv2_and_jax(tmp_path, fps, shape):
    frames = _frames(*shape)
    path = str(tmp_path / "v.avi")
    tmedia.write_video(path, frames, fps)
    got, (cfps, count, w, h) = _cv2_read(path)
    assert np.array_equal(got, frames)
    assert (count, w, h) == (shape[0], shape[2], shape[1]) and cfps == pytest.approx(fps, abs=1e-9)
    port = tmedia.VideoReader(use_cache=False).probe(path)
    for _, reader in _jax_readers():
        meta = reader.probe(path)
        assert (meta.fps, meta.frame_count, meta.width, meta.height) == pytest.approx(
            (port.fps, port.frame_count, port.width, port.height), abs=1e-9)
        jf, jk = reader.sample(path, range(shape[0]))
        assert jk == list(range(shape[0])) and np.array_equal(jf, frames)


def test_cv2_rgba_avi_reads_bit_exact_in_port(tmp_path):
    frames = _frames(9, 30, 44)  # OpenCV's writer takes even sizes only
    path = str(tmp_path / "cv.avi")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"RGBA"), 25.0, (44, 30))
    for f in frames:
        wr.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    wr.release()
    assert avi.probe(path) == (25.0, 9, 44, 30)
    got, kept = tmedia.VideoReader(use_cache=False).sample(path, range(9))
    assert kept == list(range(9)) and np.array_equal(got, frames)


def test_port_writes_the_layout_cv2_writes(tmp_path):
    """Byte for byte the file OpenCV's libav writer gives for fourcc RGBA,
    but for the software name in the INFO list."""
    frames = _frames(4, 6, 10)
    ours, theirs = str(tmp_path / "ours.avi"), str(tmp_path / "theirs.avi")
    tmedia.write_video(ours, frames, 30.0)
    wr = cv2.VideoWriter(theirs, cv2.VideoWriter_fourcc(*"RGBA"), 30.0, (10, 6))
    for f in frames:
        wr.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    wr.release()
    a, b = open(ours, "rb").read(), open(theirs, "rb").read()
    assert len(a) == len(b)
    isft = b.index(b"ISFT") + 8
    assert a[:isft] == b[:isft] and a[isft + 14:] == b[isft + 14:]


def test_random_access_sample(tmp_path):
    frames = _frames(20, 10, 12)
    path = str(tmp_path / "v.avi")
    tmedia.write_video(path, frames, 10.0)
    got, kept = avi.read_frames(path, [17, 3, 3, 25, 0])
    assert kept == [0, 3, 17] and np.array_equal(got, frames[[0, 3, 17]])


def _as_opendml(path, tail, total=None):
    """Rewrite a raw AVI of the port's writer in the layout libavformat gives a
    file past 1 GiB: the odml header becomes LIST 'odml' with the total frame
    count, the stream header counts every frame, and the ``tail`` frames
    follow in a RIFF 'AVIX'."""
    import struct

    data = bytearray(open(path, "rb").read())
    n = struct.unpack_from("<I", data, data.index(b"strh") + 8 + 32)[0]
    total = n + len(tail) if total is None else total
    odml = data.index(b"JUNK" + struct.pack("<I", 260) + b"odml")
    data[odml:odml + 4] = b"LIST"
    struct.pack_into("<I", data, odml + 20, total)
    struct.pack_into("<I", data, data.index(b"strh") + 8 + 32, total)
    movi = b"".join(b"00dc" + struct.pack("<I", f.size + f.size // 3) + np.concatenate(
        [f, np.full(f.shape[:2] + (1,), 255, np.uint8)], 2).tobytes() for f in tail)
    data += b"RIFF" + struct.pack("<I", 16 + len(movi)) + b"AVIX" + b"LIST" + struct.pack(
        "<I", 4 + len(movi)) + b"movi" + movi
    open(path, "wb").write(bytes(data))


def test_opendml_frames_in_avix_are_read(tmp_path):
    """Past 1 GiB libavformat writes OpenDML: the frames after the first RIFF
    lie in RIFF 'AVIX' chunks, and the file's frame count covers them all
    (checked against OpenCV on a 1.1 GB file it wrote: 46 690 frames, 43 677
    of them in the first RIFF)."""
    frames = _frames(8, 10, 12)
    path = str(tmp_path / "v.avi")
    tmedia.write_video(path, frames[:5], 10.0)
    _as_opendml(path, frames[5:])
    assert avi.probe(path) == (10.0, 8, 12, 10)
    got, kept = avi.read_frames(path, [0, 4, 5, 7])
    assert kept == [0, 4, 5, 7] and np.array_equal(got, frames[[0, 4, 5, 7]])


@pytest.mark.parametrize("damage", ["cut_last_frame", "avix_lost", "odml_count", "garbage_riff"])
def test_avi_missing_frames_raises(tmp_path, damage):
    """A file that holds fewer frames than its headers count is refused, never
    read as a shorter video."""
    frames = _frames(6, 10, 12)
    path = str(tmp_path / "v.avi")
    tmedia.write_video(path, frames[:4], 10.0)
    if damage == "cut_last_frame":  # a download cut inside the last frame
        data = open(path, "rb").read()
        open(path, "wb").write(data[:data.rindex(b"idx1") - 100])
        expect = "stream header counts 4 frames, the file holds 3"
    elif damage == "avix_lost":
        _as_opendml(path, frames[4:])
        data = open(path, "rb").read()
        open(path, "wb").write(data[:data.index(b"AVIX") - 8])
        expect = "counts 6 frames, the file holds 4"
    elif damage == "odml_count":
        _as_opendml(path, frames[4:], total=7)
        expect = "counts 7 frames, the file holds 6"
    else:
        with open(path, "ab") as f:
            f.write(b"RIFF" + (4).to_bytes(4, "little") + b"WAVE")
        expect = "RIFF.*WAVE"
    with pytest.raises(avi.UnsupportedVideo, match=expect):
        tmedia.VideoReader(use_cache=False).probe(path)


@pytest.mark.parametrize("kind", ["mp4", "png_avi", "xvid_avi", "empty", "text"])
def test_other_containers_raise_naming_them(tmp_path, kind):
    path = str(tmp_path / f"v.{kind}")
    if kind == "mp4":
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (16, 16))
        for f in _frames(3, 16, 16):
            wr.write(f)
        wr.release()
        expect = "MP4"
    elif kind == "png_avi":
        avi.write_avi(path, _frames(3, 16, 16), 10.0, avi.FOURCC_PNG)
        expect = "png"
    elif kind == "xvid_avi":  # the codec tags of a raw file rewritten
        tmedia.write_video(path, _frames(3, 16, 16), 10.0)
        data = open(path, "rb").read().replace(b"RGBA", b"XVID")
        open(path, "wb").write(data)
        expect = "XVID"
    elif kind == "empty":
        open(path, "wb").close()
        expect = "empty"
    else:
        with open(path, "w") as f:
            f.write("not a video at all")
        expect = "unknown container"
    with pytest.raises(avi.UnsupportedVideo, match=expect):
        tmedia.VideoReader(use_cache=False).probe(path)
    assert tmedia.VideoReader().probe(str(tmp_path / "missing.avi")) is None


def test_writer_rejects_bad_frames(tmp_path):
    w = avi.AviWriter(str(tmp_path / "x.avi"), 10.0)
    w.write(_frames(1, 8, 8)[0])
    with pytest.raises(ValueError):
        w.write(_frames(1, 9, 8)[0])
    with pytest.raises(ValueError):
        w.write(np.zeros((8, 8, 3), np.float32))
    w.close()
    with pytest.raises(ValueError):
        avi.AviWriter(str(tmp_path / "y.avi"), 0.0)
    assert avi.fps_rational(29.97) == (2997, 100) and avi.fps_rational(1 / 3) == (333, 1000)


# ---------------------------------------------------------------------------
# PNG artifacts and the viz video
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(24, 31, 3), (1, 1, 3), (7, 5, 4)])
def test_png_reads_bit_exact_in_cv2(tmp_path, shape):
    img = np.random.RandomState(1).randint(0, 256, shape, dtype=np.uint8)
    data = png.encode_png(img)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    ref = cv2.cvtColor(back, cv2.COLOR_BGR2RGB if shape[2] == 3 else cv2.COLOR_BGRA2RGBA)
    assert np.array_equal(ref.reshape(shape), img)
    assert np.array_equal(png.decode_png(data), img)


def test_png_decoder_refuses_filtered_rows():
    ok, buf = cv2.imencode(".png", np.tile(np.arange(64, dtype=np.uint8)[:, None, None], (1, 64, 3)))
    with pytest.raises(ValueError, match="filters"):
        png.decode_png(buf.tobytes())


def test_viz_writer_is_png_avi_cv2_reads_losslessly(tmp_path):
    frames = _frames(6, 20, 28)
    path = str(tmp_path / "viz.avi")
    w = tmedia.IncrementalVideoWriter(path, 5.0, cache_scope=("video", "V3"))
    w.append(frames[:4])
    w.append(lambda: frames[4:], fingerprint=b"4:6")  # drawn when the writer closes
    w.close()
    got, (fps, count, _, _) = _cv2_read(path)
    assert np.array_equal(got, frames) and fps == 5.0 and count == 6
    with pytest.raises(avi.UnsupportedVideo, match="png"):
        avi.probe(path)  # the input reader takes raw RGBA only


def test_viz_cache_serves_repeated_content(tmp_path):
    frames = _frames(3, 10, 10)
    for name in ("a.avi", "b.avi"):
        w = tmedia.IncrementalVideoWriter(str(tmp_path / name), 5.0, cache_scope=("video", "V3"))
        w.append(lambda: frames, fingerprint=b"same")
        w.close_async().result(timeout=60)
    assert open(tmp_path / "a.avi", "rb").read() == open(tmp_path / "b.avi", "rb").read()
    assert np.array_equal(_cv2_read(str(tmp_path / "b.avi"))[0], frames)


def test_artifact_writer_png_and_cache(tmp_path):
    img = _frames(1, 12, 14)[0]
    w = io_pool.ArtifactWriter()
    w.save_png(str(tmp_path / "a.png"), img, key=("k", 1))
    w.drain()
    w.save_png(str(tmp_path / "b.png"), np.zeros_like(img), key=("k", 1))  # cache hit: a's bytes
    w.drain()
    assert np.array_equal(png.decode_png(open(tmp_path / "a.png", "rb").read()), img)
    assert open(tmp_path / "a.png", "rb").read() == open(tmp_path / "b.png", "rb").read()


# ---------------------------------------------------------------------------
# frame caches
# ---------------------------------------------------------------------------
@pytest.fixture
def video(tmp_path):
    path = str(tmp_path / "v.avi")
    frames = np.zeros((30, 48, 64, 3), np.uint8)
    for i in range(30):
        frames[i, :, :, 0] = i * 8
    tmedia.write_video(path, frames, 10.0)
    return path


def test_sample_matches_jax_reader_and_cache(video, monkeypatch):
    calls = []
    orig = tmedia.VideoReader._sample_uncached
    monkeypatch.setattr(tmedia.VideoReader, "_sample_uncached",
                        staticmethod(lambda p, ids: calls.append(list(ids)) or orig(p, ids)))
    reader = tmedia.VideoReader()
    f1, k1 = reader.sample(video, [12, 0, 6])
    f2, k2 = reader.sample(video, [0, 6, 12])
    assert k1 == k2 == [0, 6, 12] and calls == [[0, 6, 12]] and f2 is f1
    f3, k3 = reader.sample(video, [0, 3, 40])
    assert k3 == [0, 3] and calls[-1] == [3, 40]  # only the frames not cached are read
    for _, jreader in _jax_readers():
        jf, jk = jreader.sample(video, [0, 6, 12])
        assert jk == k1 and np.array_equal(jf, f1)
    assert tmedia.content_key(video) == jmedia.content_key(video)
    meta = reader.sample_at_fps(video, 5.0)
    assert meta[1] == list(range(0, 30, 2))


def test_streaming_sampler_chunks_equal_one_read(video):
    whole, ids = tmedia.VideoReader(use_cache=False).sample(video, range(0, 30, 2))
    chunks = list(tmedia.StreamingSampler(video, range(0, 30, 2), chunk_size=4))
    assert [len(k) for _, k in chunks] == [4, 4, 4, 3]
    assert sum((k for _, k in chunks), []) == ids
    assert np.array_equal(np.concatenate([f for f, _ in chunks]), whole)


def test_concurrent_readers_read_once(video, monkeypatch):
    calls = []
    orig = tmedia.VideoReader._sample_uncached
    monkeypatch.setattr(tmedia.VideoReader, "_sample_uncached",
                        staticmethod(lambda p, ids: calls.append(1) or orig(p, ids)))
    out = []
    threads = [threading.Thread(target=lambda: out.append(tmedia.VideoReader().sample(video, range(10))))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(out) == 8 and len(calls) == 1


def test_device_frames_uploaded_once_and_gathered(video):
    frames, ids = tmedia.VideoReader().sample(video, range(0, 30, 2))
    dev = tmedia.device_frames_for(video, ids, frames, "cpu")
    assert tmedia._device_frames.uploads == 1 and tmedia._device_frames.upload_bytes == frames.nbytes
    assert tmedia.device_frames_for(video, ids, device="cpu") is dev
    sub = tmedia.device_frames_for(video, [4, 10], frames[:2], "cpu")  # a subset: gathered
    assert tmedia._device_frames.uploads == 1
    assert torch.equal(sub, torch.from_numpy(frames[[2, 5]]))
    assert tmedia.device_frames_for(video, [1], device="cpu") is None  # not resident, nothing to upload
    # the content key, not the path, names an entry
    copy = os.path.join(os.path.dirname(video), "copy.avi")
    with open(video, "rb") as a, open(copy, "wb") as b:
        b.write(a.read())
    assert tmedia.device_frames_for(copy, ids, device="cpu") is dev


def test_cached_keyframe_images_from_cache_and_file(tmp_path, video):
    run = tmp_path / "run"
    (run / "keyframes").mkdir(parents=True)
    with open(video, "rb") as a, open(run / "video.mp4", "wb") as b:
        b.write(a.read())
    frames, _ = tmedia.VideoReader().sample(str(run / "video.mp4"), [10])
    on_disk = _frames(1, 48, 64)[0]
    with open(run / "keyframes" / "frame_000020.png", "wb") as f:
        f.write(png.encode_png(on_disk))
    got = tmedia.cached_keyframe_images([str(run / "keyframes" / "frame_000010.png"),
                                         str(run / "keyframes" / "frame_000020.png"),
                                         str(run / "keyframes" / "frame_000099.png")])
    assert np.array_equal(got[0], frames[0]) and np.array_equal(got[1], on_disk) and got[2] is None


# ---------------------------------------------------------------------------
# WAV and the IN node
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_bit_exact_both_ways(tmp_path, channels):
    x = np.random.RandomState(2).uniform(-1, 1, (4410, channels)).squeeze()
    for writer, reader in ((jwav, twav), (twav, jwav)):
        path = str(tmp_path / f"{writer.__name__}.wav")
        writer.write_wav(path, x, 44100)
        (a, sa), (b, sb) = reader.read_wav(path), writer.read_wav(path)
        assert sa == sb == 44100 and np.array_equal(a, b)
        assert np.array_equal(twav.to_mono(a), jwav.to_mono(b))


def test_ingest_matches_jax(tmp_cwd):
    os.makedirs("src")
    tmedia.write_video("src/clip.avi", _frames(20, 24, 32), 10.0)
    twav.write_wav("src/clip.wav", np.zeros(1600), 16000)
    j = jingest.run(JState(input_path="src/clip.avi"))
    t = tingest.run(TState(input_path="src/clip.avi"))
    assert t["data_dir"].startswith("processed/video_") and t["data_dir"] != j["data_dir"]
    for key in ("original_path", "duration", "fps", "size", "rotation"):
        assert t["metadata"][key] == j["metadata"][key], key
    assert "codec" not in t["metadata"]  # the port has no libav shim
    for name in ("video.mp4", "video.wav", "audio.wav", "IN_debug.json"):
        assert open(os.path.join(t["data_dir"], name), "rb").read() == open(
            os.path.join(j["data_dir"], name), "rb").read() or name == "IN_debug.json"


def test_ingest_errors(tmp_cwd):
    with pytest.raises(FileNotFoundError):
        tingest.run(TState(input_path="nope.avi"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tingest.run(TState(input_path="https://example.com/v.mp4"))
    wr = cv2.VideoWriter("v.mp4", cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (16, 16))
    wr.write(np.zeros((16, 16, 3), np.uint8))
    wr.release()
    with pytest.raises(avi.UnsupportedVideo, match="MP4"):
        tingest.run(TState(input_path="v.mp4"))


def test_ingest_run_dirs_never_collide(tmp_cwd, monkeypatch):
    import datetime

    class Frozen(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return datetime.datetime(2026, 1, 1)

    monkeypatch.setattr(tingest.datetime, "datetime", Frozen)
    dirs = {tingest._make_run_dir("processed") for _ in range(3)}
    assert len(dirs) == 3
