"""Chunked long-video processing in the port: the tests of
``tests/test_chunked_streaming.py`` (resumable OneEuro smoothing, the
streaming sampler, V3 and V4 chunked against one chunk), then the port's V3
and V4 against the JAX package's at a small ``stream_chunk_frames``, so the
multi-chunk path (uncached sampling, one shared landmark+pose forward per
chunk, carried tracker and filter state) runs on both sides.

The JAX package reads the port's raw-RGBA AVI through OpenCV and is set to
f32 by passing ``compute_dtype=jnp.float32`` to ``detect_batch_jit`` and
``landmarks_pose_from_frames``, in this file only."""

import dataclasses
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fvd_tpu.config as jconfig
import fvd_tpu.providers as jprov
import fvd_tpu.state as jstate
import fvd_tpu_torch.config as tconfig
import fvd_tpu_torch.state as tstate
from fvd_tpu.models import face_ssd as jssd
from fvd_tpu.models import landmarks_fan as jlmk
from fvd_tpu.nodes import v3_landmarks as jv3
from fvd_tpu.nodes import v4_dynamics as jv4
from fvd_tpu.ops.filters import one_euro_scan as jax_one_euro_scan
from fvd_tpu_torch.nodes import v3_landmarks, v4_dynamics
from fvd_tpu_torch.ops.filters import one_euro_init_carry, one_euro_scan, one_euro_scan_chunk
from fvd_tpu_torch.providers import Providers
from fvd_tpu_torch.providers import media as tmedia
from fvd_tpu_torch.providers.media import StreamingSampler, write_video
from fvd_tpu_torch.synthetic import SyntheticLandmarks, make_face_video, make_synthetic_video
from test_torch_full_dag import CKPT, EAR_TOL, POSE_TOL_DEG, _torch_landmarks

#: chunked against whole, both the port's float32 scan
SCAN_TOL = 1e-5
#: V3 and V4 at small chunks against one chunk (the JAX test's bar)
CHUNK_TOL = 1e-4
#: mouth landmarks of the two packages in f32 (``tests/test_torch_video_dag.py``)
LANDMARK_TOL_PX = 0.05


def test_one_euro_chunked_matches_whole_track():
    rng = np.random.RandomState(0)
    T = 60
    times = np.cumsum(0.2 + 0.05 * rng.rand(T))
    values = np.cumsum(rng.randn(T, 68, 2), axis=0)
    valid = rng.rand(T) > 0.2

    whole = one_euro_scan(times, values, valid, min_cutoff=0.5, beta=0.1)
    carry = one_euro_init_carry((68, 2))
    outs = []
    for s in range(0, T, 17):  # uneven chunk boundary
        out, carry = one_euro_scan_chunk(carry, times[s:s + 17], values[s:s + 17], valid[s:s + 17],
                                         min_cutoff=0.5, beta=0.1)
        outs.append(out)
    chunked = np.concatenate(outs)
    np.testing.assert_allclose(np.nan_to_num(chunked), np.nan_to_num(whole), rtol=SCAN_TOL, atol=SCAN_TOL)
    ref = np.asarray(jax_one_euro_scan(times, values, valid, min_cutoff=0.5, beta=0.1))
    np.testing.assert_allclose(np.nan_to_num(chunked), np.nan_to_num(ref), rtol=SCAN_TOL, atol=SCAN_TOL)


def test_streaming_sampler_chunks(tmp_path):
    path = str(tmp_path / "v.mp4")
    frames = np.zeros((40, 48, 64, 3), np.uint8)
    for i in range(40):
        frames[i, :, :, 0] = i * 6
    write_video(path, frames, 10.0)

    ids = list(range(0, 40, 2))  # 20 sampled
    chunks = list(StreamingSampler(path, ids, chunk_size=7))
    assert [i for _, kept in chunks for i in kept] == ids
    assert [len(k) for _, k in chunks] == [7, 7, 6]
    for fr, kept in chunks:  # each chunk holds its own ids' pixels (lossless)
        np.testing.assert_array_equal(fr, frames[kept])
    # one chunk goes through the shared frame cache
    (one, kept), = StreamingSampler(path, ids, chunk_size=20)
    np.testing.assert_array_equal(one, frames[ids])
    tmedia.clear_frame_cache()


def _chunked_cfg(config_mod, chunk):
    base = config_mod.default_config()
    return dataclasses.replace(base, landmarks=dataclasses.replace(base.landmarks, stream_chunk_frames=chunk))


@pytest.fixture(scope="module")
def synthetic_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("chunked")
    video = make_synthetic_video(str(root), name="video", duration=4.0, fps=10.0, width=160, height=120)
    assert os.path.basename(video) == "video.mp4"
    return str(root)


@pytest.mark.parametrize("node_mod,keys", [
    (v3_landmarks, ("mouth_landmarks",)),
    (v4_dynamics, ("blink_data", "head_pose_data")),
])
def test_chunked_node_matches_unchunked(synthetic_dir, node_mod, keys):
    """Processing in small chunks gives the tracks of one big batch (carried
    tracker and filter state)."""
    def run_with(chunk):
        providers = Providers(landmarks=SyntheticLandmarks(fps=10.0, gate_hz=1.0))
        return node_mod.run(tstate.State(data_dir=synthetic_dir), config=_chunked_cfg(tconfig, chunk),
                            providers=providers)

    big = run_with(1000)     # one chunk (20 sampled frames)
    small = run_with(6)      # 4 chunks with an uneven tail
    tmedia.clear_frame_cache()
    for key in keys:
        a, b = big[key], small[key]
        assert len(a) == len(b) > 0
        for ea, eb in zip(a, b):
            assert ea.keys() == eb.keys()
            for field in ea:
                va, vb = ea[field], eb[field]
                if isinstance(va, (int, float)):
                    assert va == pytest.approx(vb, abs=CHUNK_TOL), (key, field)
                elif isinstance(va, dict):
                    for k2 in va:
                        assert va[k2] == pytest.approx(vb[k2], abs=CHUNK_TOL)
                else:
                    np.testing.assert_allclose(np.asarray(va, float), np.asarray(vb, float), atol=CHUNK_TOL)


def test_multi_chunk_v3_v4_match_jax_on_the_shipped_checkpoints(tmp_path):
    """A 4 s clip at 10 fps, 320x240: 20 samples in chunks of 7, 7 and 6.
    The port's V3 then V4 against the JAX package's, both in f32 with the
    shipped face_ssd, landmarks and pose checkpoints: the same samples, the
    mouth landmarks, EARs and angles within the full DAG's bars, and one
    shared landmark+pose forward per chunk."""
    clip = make_face_video(str(tmp_path / "clip"), "clip", duration=4.0, fps=10.0)
    dirs = {}
    for side in ("torch", "jax"):
        dirs[side] = str(tmp_path / side)
        os.makedirs(dirs[side])
        shutil.copy(clip, os.path.join(dirs[side], "video.mp4"))

    det, lmk = _torch_landmarks()
    tcfg, prov = _chunked_cfg(tconfig, 7), Providers(face_detector=det, landmarks=lmk)
    tmedia.clear_frame_cache()
    state = tstate.State(data_dir=dirs["torch"])
    t = {**v3_landmarks.run(state, tcfg, prov), **v4_dynamics.run(state, tcfg, prov)}
    forwards = tmedia._landmark_share.forwards
    tmedia.clear_frame_cache()

    jdet = jssd.SSDFaceDetector(params=jssd.load_params(os.path.join(CKPT, "face_ssd.npz"), 32), width=32)
    zeros = jnp.zeros((1, 128, 128, 3))  # jitted inits: eager flax init compiles op by op
    lmk_tpl = jax.jit(jlmk.LandmarkHourglass(width=32).init)(jax.random.PRNGKey(1), zeros)
    pose_tpl = jax.jit(jlmk.PoseHead(width=32).init)(jax.random.PRNGKey(2), zeros)
    jlm = jlmk.FANLandmarks(jdet, landmark_params=jlmk.load_params(os.path.join(CKPT, "landmarks.npz"), lmk_tpl),
                            pose_params=jlmk.load_params(os.path.join(CKPT, "pose.npz"), pose_tpl),
                            width=32, pose_width=32)
    jcfg, jprovs = _chunked_cfg(jconfig, 7), jprov.Providers(face_detector=jdet, landmarks=jlm)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssd, "detect_batch_jit", functools.partial(jssd.detect_batch_jit, compute_dtype=jnp.float32))
        mp.setattr(jlmk, "landmarks_pose_from_frames",
                   functools.partial(jlmk.landmarks_pose_from_frames, compute_dtype=jnp.float32))
        jst = jstate.State(data_dir=dirs["jax"])
        j = {**jv3.run(jst, jcfg, jprovs), **jv4.run(jst, jcfg, jprovs)}

    assert forwards == 3  # one per chunk, shared by V3 and V4
    tm, jm = t["mouth_landmarks"], j["mouth_landmarks"]
    assert [(m["frame_id"], m["timestamp"], len(m["landmarks"])) for m in tm] == \
        [(m["frame_id"], m["timestamp"], len(m["landmarks"])) for m in jm]
    assert len(tm) == 20 and sum(1 for m in tm if m["landmarks"]) >= 16
    for a, b in zip(tm, jm):
        if a["landmarks"]:
            np.testing.assert_allclose(a["landmarks"], b["landmarks"], atol=LANDMARK_TOL_PX, rtol=0)
    tb, jb = t["blink_data"], j["blink_data"]
    assert [(b["frame_id"], b["timestamp"]) for b in tb] == [(b["frame_id"], b["timestamp"]) for b in jb]
    np.testing.assert_allclose([b["ear"] for b in tb], [b["ear"] for b in jb], atol=EAR_TOL, rtol=0)
    tp, jpose = t["head_pose_data"], j["head_pose_data"]
    assert [p["frame_id"] for p in tp] == [p["frame_id"] for p in jpose] and len(tp) >= 16
    np.testing.assert_allclose([[p["pose"][k] for k in ("pitch", "yaw", "roll")] for p in tp],
                               [[p["pose"][k] for k in ("pitch", "yaw", "roll")] for p in jpose],
                               atol=POSE_TOL_DEG, rtol=0)
