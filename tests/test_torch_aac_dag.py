"""The lip-sync path of the DAG on an ``mp4v`` clip whose sound is its own
AAC-LC track, with no sibling ``.wav``: IN extracts the audio in both
packages (the JAX package through its libav shim, the port through its
decoder, the plain versions on ``device="cpu"``), then A1 -> A3,
V1 -> V3, C1 and LR, held to ``tests/test_torch_mp4_dag.py``'s bars at
float32.  The clip is the JAX package's ``make_face_video`` (6 s at 10 fps,
44.1 kHz speech), its video samples copied and its wav coded by the plain
AAC encoder."""

import functools
import os
import types
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvd_tpu.config as jconfig
import fvd_tpu.runtime as jrt
import fvd_tpu.state as jstate
import fvd_tpu_torch.config as tconfig
import fvd_tpu_torch.runtime as trt
import fvd_tpu_torch.state as tstate
from fvd_tpu.models import face_ssd as jssd
from fvd_tpu.models import landmarks_fan as jlmk
from fvd_tpu.nodes import (a1_standardize as ja1, a3_onsets as ja3, c1_lipsync as jc1, ingest as jin,
                           lr_fusion as jlr, v1_faces as jv1, v3_landmarks as jv3)
from fvd_tpu.synthetic import make_face_video as jax_make_face_video
from fvd_tpu_torch.nodes import (a1_standardize as ta1, a3_onsets as ta3, c1_lipsync as tc1,
                                 ingest as tin, lr_fusion as tlr, v1_faces as tv1, v3_landmarks as tv3)
from fvd_tpu_torch.providers import media as tmedia
from fvd_tpu_torch.utils import aac_writer, mp4
from fvd_tpu_torch.utils.wav import read_wav
from test_torch_video_dag import (LANDMARK_TOL_PX, LIP_TOL, PROB_TOL, _config, _dag, _faces, _jax_providers,
                                  _torch_providers)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    tmedia.clear_frame_cache()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The JAX package's 6 s clip as ``mp4v`` plus AAC, no sibling wav."""
    src_dir = tmp_path_factory.mktemp("src")
    src = jax_make_face_video(str(src_dir), "face", duration=6.0, fps=10.0, sr=44100)
    speech, sr = read_wav(os.path.join(str(src_dir), "face.wav"))
    asc, units = aac_writer.encode_signal(speech, sr)
    data = open(src, "rb").read()
    track = mp4.parse(src, data)
    out = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    sync = set(track.sync or range(track.frame_count))
    with mp4.Mp4Writer(out, track.width, track.height, track.fps, track.config) as w:
        for i, (o, s) in enumerate(zip(track.offsets, track.sizes)):
            w.write(data[o:o + s], sync=i in sync)
        w.add_audio(asc, sr, 1, units, 1024)
    assert not os.path.exists(out[:-4] + ".wav")
    return out


def _run_jax(clip, root):
    cfg = _config(jconfig, root)
    mods = (jin, ja1, ja3, jv1, jv3, jc1, jlr)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssd, "detect_batch_jit", functools.partial(jssd.detect_batch_jit, compute_dtype=jnp.float32))
        mp.setattr(jlmk, "landmarks_pose_from_frames",
                   functools.partial(jlmk.landmarks_pose_from_frames, compute_dtype=jnp.float32))
        return jrt.Scheduler(_dag(jrt, cfg, _jax_providers(), mods)).invoke(jstate.State(input_path=clip))


def _run_torch(clip, root):
    cfg = _config(tconfig, root)
    ingest = types.SimpleNamespace(run=functools.partial(tin.run, device="cpu"))
    mods = (ingest, ta1, ta3, tv1, tv3, tc1, tlr)
    dag = _dag(trt, cfg, _torch_providers(torch.float32), mods, device="cpu")
    return trt.Scheduler(dag).invoke(tstate.State(input_path=clip))


@pytest.fixture(scope="module")
def runs(clip, tmp_path_factory):
    return {"jax": _run_jax(clip, tmp_path_factory.mktemp("jax")),
            "torch": _run_torch(clip, tmp_path_factory.mktemp("torch"))}


def _pcm(path):
    with wave.open(path) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int64)


def test_in_extracts_the_aac_track_in_both_packages(runs):
    j, t = runs["jax"], runs["torch"]
    a = _pcm(os.path.join(t.data_dir, "audio.wav"))
    b = _pcm(os.path.join(j.data_dir, "audio.wav"))
    assert len(a) == len(b) >= 6 * 44100 and np.abs(a - b).max() <= 1
    assert not os.path.exists(os.path.join(t.data_dir, "video.wav"))
    for key in ("duration", "fps", "size", "rotation", "audio_sample_rate", "audio_channels", "video_fps",
                "total_frames"):
        assert t.metadata[key] == j.metadata[key], key
    np.testing.assert_allclose(t.audio_envelope, j.audio_envelope, atol=1e-4, rtol=0)


def test_lip_sync_path_on_aac_clip_matches_jax(runs):
    j, t = runs["jax"], runs["torch"]
    fj, ft = _faces(j), _faces(t)
    assert [len(f) for f in ft] == [len(f) for f in fj] and sum(len(f) > 0 for f in ft) >= 5
    mj, mt = j.mouth_landmarks, t.mouth_landmarks
    assert [m["frame_id"] for m in mt] == [m["frame_id"] for m in mj]
    for a, b in zip(mj, mt):
        if a["landmarks"]:
            np.testing.assert_allclose(b["landmarks"], a["landmarks"], atol=LANDMARK_TOL_PX, rtol=0)
    assert abs(t.lip_sync_score - j.lip_sync_score) <= LIP_TOL
    assert abs(t.fake_probability - j.fake_probability) <= PROB_TOL
