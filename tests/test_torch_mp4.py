"""The port's MP4 container (``fvd_tpu_torch/utils/mp4.py``) against the files
the JAX package writes through OpenCV's ``mp4v`` writer and reads through its
libav shim: the box walk, ``probe`` at common frame rates, and other codecs'
sample entries."""

import struct

import numpy as np
import pytest
import torch

from fvd_tpu.providers import native_decode as jnd
from fvd_tpu.providers.media import VideoReader as JReader
from fvd_tpu.providers.media import write_video as jax_write_video
from fvd_tpu_torch.providers import media as tmedia
from fvd_tpu_torch.providers import native_decode as tnd
from fvd_tpu_torch.utils import mp4
from fvd_tpu_torch.utils.avi import UnsupportedVideo


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers); the
    port's video decodes on ``device="cpu"`` (the plain versions)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    tmedia.clear_frame_cache()
    torch.set_num_threads(threads)


def _frames(n, h, w, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h + n, w + n, 3)).astype(np.float32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1) + np.roll(base, 1, (0, 1))) / 4
    return np.stack([base[i:i + h, i:i + w] for i in range(n)]).astype(np.uint8)


def _write(path, writer, frames, fps):
    if writer == "jax":
        jax_write_video(path, frames, fps)
    else:
        tnd.write_mp4v(path, frames, fps, device="cpu")


def _top_boxes(data):
    out, pos = [], 0
    while pos + 8 <= len(data):
        size, kind = struct.unpack_from(">I4s", data, pos)
        out.append(kind)
        pos += size
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_box_walk(tmp_path, writer):
    path = str(tmp_path / "v.mp4")
    _write(path, writer, _frames(14, 32, 48), 10.0)
    data = open(path, "rb").read()
    assert _top_boxes(data) == [b"ftyp", b"free", b"mdat", b"moov"]
    track = mp4.parse(path, data)
    assert track.fourcc == "mp4v" and (track.width, track.height) == (48, 32)
    assert track.frame_count == 14 and track.sync == [0, 12]
    assert track.timescale == 10240 and set(track.sample_deltas) == {1024}
    mdat = data.index(b"mdat") + 4
    assert track.offsets[0] == mdat
    for i in range(13):  # one chunk: the samples follow each other
        assert track.offsets[i + 1] == track.offsets[i] + track.sizes[i]
    for off in track.offsets:
        assert data[off:off + 3] == b"\x00\x00\x01" and data[off + 3] in (0xB3, 0xB6)
    assert b"\x00\x00\x01\x20" in track.config  # the VOL rides in esds
    assert track.rotation == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fps", [10.0, 25.0, 29.97, 30.0])
def test_probe_matches_jax(tmp_path, fps, writer):
    path = str(tmp_path / "v.mp4")
    _write(path, writer, _frames(13, 48, 64), fps)
    ours = tmedia.VideoReader(use_cache=False).probe(path)
    theirs = JReader(use_cache=False).probe(path)
    assert (ours.fps, ours.frame_count, ours.width, ours.height) == \
        (theirs.fps, theirs.frame_count, theirs.width, theirs.height)
    assert ours.fps == fps and ours.frame_count == 13
    if jnd.available():
        with tnd.NativeVideo(path) as v, jnd.NativeVideo(path) as j:
            p, q = v.probe(), j.probe()
        assert p[:4] == q[:4] and p[5] == q[5] is False
        assert p[4] == pytest.approx(q[4], abs=1.0 / fps)


@pytest.mark.parametrize("fourcc", ["avc1", "hvc1", "av01"])
def test_other_sample_entries_raise_naming_them(tmp_path, fourcc):
    path = str(tmp_path / "v.mp4")
    jax_write_video(path, _frames(3, 16, 16), 10.0)
    data = open(path, "rb").read()
    at = data.index(b"mp4v", data.index(b"stsd"))
    open(path, "wb").write(data[:at] + fourcc.encode() + data[at + 4:])
    with pytest.raises(UnsupportedVideo, match=fourcc):
        tmedia.VideoReader(use_cache=False).probe(path)
    with pytest.raises(UnsupportedVideo, match=fourcc):
        tmedia.VideoReader(use_cache=False).sample(path, [0], device="cpu")


@pytest.mark.parametrize("damage", ["no_moov", "cut"])
def test_damaged_files_raise(tmp_path, damage):
    path = str(tmp_path / "v.mp4")
    jax_write_video(path, _frames(6, 16, 16), 10.0)
    data = open(path, "rb").read()
    if damage == "no_moov":  # a recording stopped before the muxer wrote its index
        data, expect = data[:data.index(b"moov") - 4], "moov"
    else:  # cut inside the index
        data, expect = data[:-50], "runs past"
    open(path, "wb").write(data)
    with pytest.raises(UnsupportedVideo, match=expect):
        tmedia.VideoReader(use_cache=False).probe(path)
