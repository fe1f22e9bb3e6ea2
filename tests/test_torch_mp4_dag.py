"""IN's metadata and the lip-sync path of the DAG on a JAX-written ``mp4v``
file, through both packages: the JAX package reads it through libav, the port
through its own decoder (the plain versions on ``device="cpu"``), which gives
the same frames.  The lip-sync path and its bars are
``tests/test_torch_video_dag.py``'s, at float32, on a 4 s clip (one C1
window)."""

import os
import struct

import numpy as np
import pytest
import torch

import fvd_tpu.config as jconfig
import fvd_tpu.state as jstate
import fvd_tpu_torch.config as tconfig
import fvd_tpu_torch.state as tstate
from fvd_tpu.nodes import ingest as jin
from fvd_tpu.providers import native_decode as jnd
from fvd_tpu.synthetic import make_face_video as jax_make_face_video
from fvd_tpu_torch.nodes import ingest as tin
from fvd_tpu_torch.providers import media as tmedia
from test_torch_video_dag import CONF_TOL, LANDMARK_TOL_PX, LIP_TOL, PROB_TOL, _config, _faces, _run_jax, _run_torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread; the port's DAG (and so its video decoding) runs
    on ``device="cpu"``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    tmedia.clear_frame_cache()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    return jax_make_face_video(str(d), "face", duration=4.0, fps=10.0, sr=44100)


def _rotated(src, dst, degrees):
    """``src`` with its ``tkhd`` display matrix set to rotate by ``degrees``."""
    data = bytearray(open(src, "rb").read())
    at = data.index(b"tkhd") + 4 + 40  # version 0: the matrix after 40 bytes
    c, s = {90: (0, 1), 180: (-1, 0), 270: (0, -1)}[degrees]
    struct.pack_into(">9i", data, at, c << 16, s << 16, 0, -s << 16, c << 16, 0, 0, 0, 1 << 30)
    open(dst, "wb").write(bytes(data))
    return dst


@pytest.mark.parametrize("degrees", [0, 90, 270])
def test_ingest_metadata_matches_jax(clip, tmp_path, degrees):
    if not jnd.available():
        pytest.skip("the JAX package reads codec and rotation through its libav shim")
    src = clip if degrees == 0 else _rotated(clip, str(tmp_path / "rot.mp4"), degrees)
    j = jin.run(jstate.State(input_path=src), _config(jconfig, tmp_path / "j"))["metadata"]
    t = tin.run(tstate.State(input_path=src), _config(tconfig, tmp_path / "t"))["metadata"]
    for key in ("duration", "fps", "size", "rotation", "codec"):
        assert t[key] == j[key], key
    assert t["codec"] == "mpeg4" and t["rotation"] == degrees


@pytest.fixture(scope="module")
def runs(clip, tmp_path_factory):
    return {"jax": _run_jax(clip, tmp_path_factory.mktemp("jax"), True),
            "torch": _run_torch(clip, tmp_path_factory.mktemp("torch"), torch.float32)}


def test_lip_sync_path_on_mp4_matches_jax(runs):
    j, t = runs["jax"], runs["torch"]
    for key in ("duration", "fps", "size", "rotation", "video_fps", "total_frames"):
        assert t.metadata[key] == j.metadata[key], key
    fj, ft = _faces(j), _faces(t)
    assert [len(f) for f in ft] == [len(f) for f in fj] and len(ft) == 4
    assert sum(len(f) > 0 for f in ft) >= 3
    for a, b in zip(fj, ft):
        for (bj, cj), (bt, ct) in zip(a, b):
            assert abs(ct - cj) <= CONF_TOL
            assert all(abs(bt[k] - bj[k]) <= 1 for k in "xywh")  # int() of boxes within 0.05 px
    mj, mt = j.mouth_landmarks, t.mouth_landmarks
    assert [m["frame_id"] for m in mt] == [m["frame_id"] for m in mj] == list(range(0, 40, 2))
    assert [bool(m["landmarks"]) for m in mt] == [bool(m["landmarks"]) for m in mj]
    for a, b in zip(mj, mt):
        if a["landmarks"]:
            np.testing.assert_allclose(b["landmarks"], a["landmarks"], atol=LANDMARK_TOL_PX, rtol=0)
    assert abs(t.lip_sync_score - j.lip_sync_score) <= LIP_TOL
    assert abs(t.fake_probability - j.fake_probability) <= PROB_TOL
    assert os.path.basename(t.data_dir).startswith("video_")
