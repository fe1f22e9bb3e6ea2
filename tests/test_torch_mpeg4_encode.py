"""The port's ``mp4v`` writer (``fvd_tpu_torch.providers.native_decode.write_mp4v``,
the plain versions of ``fvd_tpu_torch/ops/mpeg4.py`` on the CPU) read by the
JAX package's ``VideoReader`` through its libav shim and through OpenCV,
against the port's own decode of the same file; and its luma PSNR and size
against the JAX package's file of the same clip at the same ``vop_quant`` 3."""

import os

import numpy as np
import pytest
import torch

from fvd_tpu.providers import native_decode as jnd
from fvd_tpu.providers.media import VideoReader as JReader
from fvd_tpu.providers.media import write_video as jax_write_video
from fvd_tpu.synthetic import make_face_video as jax_make_face_video
from fvd_tpu_torch.ops import mpeg4 as tops
from fvd_tpu_torch.providers import media as tmedia
from fvd_tpu_torch.providers import native_decode as tnd
from fvd_tpu_torch.synthetic import make_face_video
from fvd_tpu_torch.utils import mp4
from test_torch_mpeg4_decode import MAX_BAR, MEAN_BAR, parsed_vops, texture_frames

W, H, FPS, SECONDS = 320, 240, 10.0, 4.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers); the
    port's video decodes on ``device="cpu"`` (the plain versions)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    tmedia.clear_frame_cache()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def face(tmp_path_factory):
    """The JAX package's face clip (its ``mp4v`` file) and the same drawn
    frames (the port's ``make_face_video`` with OpenCV's rasterisation draws
    the JAX package's pixels into a lossless AVI), encoded by the port."""
    d = tmp_path_factory.mktemp("face")
    jax_file = jax_make_face_video(str(d), "face", duration=SECONDS, fps=FPS)
    avi = make_face_video(str(d), "drawn", duration=SECONDS, fps=FPS, opencv=True)
    drawn, _ = tmedia.VideoReader(use_cache=False).sample(avi, range(int(SECONDS * FPS)))
    port_file = str(d / "port.mp4")
    tnd.write_mp4v(port_file, drawn, FPS, device="cpu")
    return {"jax": jax_file, "port": port_file, "drawn": drawn}


def _ours(path, n):
    frames, kept = tmedia.VideoReader(use_cache=False).sample(path, range(n), device="cpu")
    assert kept == list(range(n))
    return frames.astype(np.int64)


@pytest.mark.parametrize("reader", ["shim", "cv2"])
def test_jax_readers_read_the_port_file(face, reader):
    n = len(face["drawn"])
    jr = JReader(use_cache=False)
    if reader == "shim":
        if not jnd.available():
            pytest.skip("the JAX package's libav shim is not built")
        theirs, kept = jr._sample_uncached(face["port"], range(n))
    else:
        theirs, kept = jr._sample_cv2(face["port"], range(n))
    assert kept == list(range(n))
    d = np.abs(theirs.astype(np.int64) - _ours(face["port"], n))
    assert d.max() <= MAX_BAR and d.mean() <= MEAN_BAR
    meta = jr.probe(face["port"])
    assert (meta.fps, meta.frame_count, meta.width, meta.height) == (FPS, n, W, H)


def _luma_psnr(path, drawn):
    vops, geo = parsed_vops(path)
    frames, ref = [], None
    for v in vops:
        args = [torch.from_numpy(a) for a in (v.levels, v.qscale, v.intra, v.mv, v.coded)]
        ref = tops.reconstruct_vop(*args, None if v.kind == "I" else ref, v.rounding, geo)
        frames.append(ref)
    dec = torch.stack(frames)[:, :W * H].double()
    ref = torch.stack([tops.rgb_to_yuv420_plain(torch.from_numpy(f), geo) for f in drawn])[:, :W * H].double()
    return 10 * np.log10(255 ** 2 / ((dec - ref) ** 2).mean().item())


def test_luma_psnr_no_lower_than_the_jax_file(face):
    ours, theirs = _luma_psnr(face["port"], face["drawn"]), _luma_psnr(face["jax"], face["drawn"])
    assert ours >= theirs > 35.0
    # no motion search: the port's file is larger (about 2.5x here), and far below raw
    size, jax_size = os.path.getsize(face["port"]), os.path.getsize(face["jax"])
    print(f"luma PSNR port {ours:.2f} dB, JAX {theirs:.2f} dB; bytes port {size}, JAX {jax_size}, "
          f"raw {face['drawn'].nbytes}")
    assert jax_size < size < face["drawn"].nbytes / 50


def test_gops_and_rounding_as_libavcodec_writes_them(face):
    data = open(face["port"], "rb").read()
    track = mp4.parse(face["port"], data)
    assert track.sync == list(range(0, len(face["drawn"]), tnd.GOP))
    vops, _ = parsed_vops(face["port"], tnd.GOP)
    assert [x.kind for x in vops] == ["I"] + ["P"] * (tnd.GOP - 1)
    assert [x.rounding for x in vops[1:]] == [1, 0] * 5 + [1]
    assert {int(q) for x in vops for q in np.unique(x.qscale)} == {tnd.QUANT}
    p = vops[1]
    assert (p.mv == 0).all() and 0 < p.coded.sum() < len(p.coded)  # some not_coded macroblocks


@pytest.mark.parametrize("w,h", [(64, 48), (72, 40)])
def test_moving_texture_round_trip(tmp_path, w, h):
    """A texture in motion (every P-macroblock coded against the vector
    (0, 0)), at an aligned size and at one the macroblocks overhang: OpenCV
    reads the port's file as the port does."""
    frames = texture_frames(n=14, h=h, w=w)
    path = str(tmp_path / "t.mp4")
    tmedia.write_video(path, frames, 25.0, container="mp4", device="cpu")
    ours = _ours(path, 14)
    cv, kept = JReader(use_cache=False)._sample_cv2(path, range(14))
    assert kept == list(range(14))
    d = np.abs(cv.astype(np.int64) - ours)
    assert d.max() <= MAX_BAR and d.mean() <= MEAN_BAR
    # a faithful encode, not just a consistent one: as close to the frames as
    # the JAX package's file of them (4:2:0 costs this noisy texture most)
    jax_path = str(tmp_path / "j.mp4")
    jax_write_video(jax_path, frames, 25.0)
    theirs, _ = JReader(use_cache=False)._sample_cv2(jax_path, range(14))
    assert np.abs(ours - frames).mean() <= np.abs(theirs.astype(np.int64) - frames).mean() + 0.1


def test_static_frames_code_nothing_after_the_i_vop(tmp_path):
    frames = np.repeat(texture_frames(n=1), 12, axis=0)
    path = str(tmp_path / "s.mp4")
    tnd.write_mp4v(path, frames, 10.0, device="cpu")
    vops, _ = parsed_vops(path, 12)
    track = mp4.parse(path, open(path, "rb").read())
    assert all(not x.coded.any() for x in vops[1:])
    assert max(track.sizes[1:]) <= 16  # the VOP header and one not_coded bit a macroblock


def test_write_video_container_switch(tmp_path):
    frames = texture_frames(n=3)
    with pytest.raises(ValueError, match="container"):
        tmedia.write_video(str(tmp_path / "x.mkv"), frames, 10.0, container="mkv")
    tmedia.write_video(str(tmp_path / "x.avi"), frames, 10.0)
    assert open(str(tmp_path / "x.avi"), "rb").read(4) == b"RIFF"


def test_make_face_video_writes_mp4v(tmp_path):
    """``make_face_video(container="mp4")`` encodes the frames it draws, as
    ``write_mp4v`` does the same frames from the lossless AVI, with the wav
    beside it."""
    kw = dict(duration=1.0, fps=10.0, width=64, height=48, seed=5)
    avi = make_face_video(str(tmp_path), "drawn", **kw)
    path = make_face_video(str(tmp_path), "face", container="mp4", device="cpu", **kw)
    assert path == str(tmp_path / "face.mp4") and os.path.exists(str(tmp_path / "face.wav"))
    drawn, _ = tmedia.VideoReader(use_cache=False).sample(avi, range(10))
    ref = str(tmp_path / "ref.mp4")
    tnd.write_mp4v(ref, drawn, 10.0, device="cpu")
    assert open(path, "rb").read() == open(ref, "rb").read()
