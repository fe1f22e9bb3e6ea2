"""The lip-sync path of the DAG from a video file, through both packages:
IN -> A1 -> A3, IN -> V1 -> V3, {A3, V3} -> C1 -> LR on each package's
``Scheduler``, the port on ``device="cpu"``, at the shipped checkpoints'
width 32.

The clip is the JAX package's ``make_face_video`` (6 s at 10 fps, 320x240,
a 44.1 kHz wav, so A1 resamples): long enough for C1's 5 s windows.  Its mp4
is decoded once and the frames rewritten with the port's ``write_video``, so
both packages read identical pixels from one raw-RGBA AVI.

f32 on both sides: the JAX package is set to f32 by passing
``compute_dtype=jnp.float32`` to ``detect_batch_jit`` and to
``landmarks_pose_from_frames`` (the program its V3 takes), in this file
only.  Then
the bf16 defaults on both sides, held to the stage bars of
``tests/test_torch_bf16.py``."""

import dataclasses
import functools
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
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
from fvd_tpu.providers import Providers as JProviders
from fvd_tpu.providers.media import VideoReader as JReader
from fvd_tpu.synthetic import make_face_video as jax_make_face_video
from fvd_tpu_torch import _kernels
from fvd_tpu_torch.models import face_ssd as tssd
from fvd_tpu_torch.models import landmarks_fan as tlmk
from fvd_tpu_torch.nodes import (a1_standardize as ta1, a3_onsets as ta3, c1_lipsync as tc1,
                                 ingest as tin, lr_fusion as tlr, v1_faces as tv1, v3_landmarks as tv3)
from fvd_tpu_torch.providers import Providers as TProviders
from fvd_tpu_torch.providers import coalesce as tco
from fvd_tpu_torch.providers import media as tmedia
from fvd_tpu_torch.providers.media import write_video
from test_torch_bf16 import LANDMARK_TOL, TOP_BOX_TOL, TOP_SCORE_TOL

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
W, H = 320, 240
#: f32 on both sides; conv sums in different orders move a box corner by
#: ~1e-4 px, the landmarks by ~1e-3 px of a ~100 px crop, the MAR series by
#: ~1e-5, and z-normalisation over C1's windows magnifies that
LIP_TOL, PROB_TOL = 1e-4, 1e-5
BOX_TOL_PX, CONF_TOL, LANDMARK_TOL_PX = 0.05, 1e-4, 0.05


def _jax_providers():
    det = jssd.SSDFaceDetector(params=jssd.load_params(os.path.join(CKPT, "face_ssd.npz"), 32), width=32)
    init = jax.jit(jlmk.LandmarkHourglass(width=32).init)(jax.random.PRNGKey(1), jnp.zeros((1, 128, 128, 3)))
    lmk = jlmk.FANLandmarks(det, landmark_params=jlmk.load_params(os.path.join(CKPT, "landmarks.npz"), init),
                            width=32)
    return JProviders(face_detector=det, landmarks=lmk)


def _torch_providers(dtype):
    det = tssd.SSDFaceDetector(checkpoint=os.path.join(CKPT, "face_ssd.npz"), compute_dtype=dtype, device="cpu")
    lmk = tlmk.FANLandmarks(det, checkpoint=os.path.join(CKPT, "landmarks.npz"), compute_dtype=dtype,
                            device="cpu")
    return TProviders(face_detector=det, landmarks=lmk)


def _dag(runtime, cfg, prov, mods, **dev):
    ingest, a1, a3, v1, v3, c1, lr = mods
    part = functools.partial
    dag = runtime.DAG()
    dag.add_node("IN", part(ingest.run, config=cfg), host_only=True)
    dag.add_node("A1", part(a1.run, config=cfg, **dev), deps=["IN"])
    dag.add_node("V1", part(v1.run, config=cfg, providers=prov, **dev), deps=["IN"])
    dag.add_node("A3", part(a3.run, config=cfg, **dev), deps=["A1"])
    dag.add_node("V3", part(v3.run, config=cfg, providers=prov, **dev), deps=["V1"])
    dag.add_node("C1", part(c1.run, config=cfg, **dev), deps=["A3", "V3"])
    dag.add_node("LR", part(lr.run, config=cfg), deps=["C1"])
    return dag


def _config(config_mod, root):
    cfg = config_mod.default_config()
    return cfg.replace(ingest=dataclasses.replace(cfg.ingest, processed_dir=str(root / "processed")),
                       fusion=dataclasses.replace(cfg.fusion, weights_path=str(root / "lr_weights.json"),
                                                  features_dir=str(root / "features")))


def _run_jax(clip, root, f32):
    cfg = _config(jconfig, root)
    mods = (jin, ja1, ja3, jv1, jv3, jc1, jlr)
    with pytest.MonkeyPatch.context() as mp:
        if f32:
            mp.setattr(jssd, "detect_batch_jit", functools.partial(jssd.detect_batch_jit,
                                                                   compute_dtype=jnp.float32))
            mp.setattr(jlmk, "landmarks_pose_from_frames",
                       functools.partial(jlmk.landmarks_pose_from_frames, compute_dtype=jnp.float32))
        return jrt.Scheduler(_dag(jrt, cfg, _jax_providers(), mods)).invoke(jstate.State(input_path=clip))


def _run_torch(clip, root, dtype):
    cfg = _config(tconfig, root)
    mods = (tin, ta1, ta3, tv1, tv3, tc1, tlr)
    dag = _dag(trt, cfg, _torch_providers(dtype), mods, device="cpu")
    return trt.Scheduler(dag).invoke(tstate.State(input_path=clip))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The JAX package's clip, rewritten as the port's raw-RGBA AVI."""
    d = tmp_path_factory.mktemp("clip")
    mp4 = jax_make_face_video(str(d), "face", duration=6.0, fps=10.0, sr=44100)
    meta = JReader(use_cache=False).probe(mp4)
    frames, kept = JReader(use_cache=False).sample(mp4, range(meta.frame_count))
    assert kept == list(range(60)) and frames.shape == (60, H, W, 3)
    path = str(d / "clip.avi")
    write_video(path, frames, meta.fps)
    shutil.copy(str(d / "face.wav"), str(d / "clip.wav"))
    return path


@pytest.fixture(scope="module")
def runs(clip, tmp_path_factory):
    out = {}
    for name, run, arg in (("jax_f32", _run_jax, True), ("torch_f32", _run_torch, torch.float32),
                           ("jax_bf16", _run_jax, False), ("torch_bf16", _run_torch, torch.bfloat16)):
        out[name] = run(clip, tmp_path_factory.mktemp(name), arg)
    tmedia.clear_frame_cache()
    return out


def _faces(final):
    return [[(f["bbox"], f["confidence"]) for f in d["faces"]] for d in final.face_detections]


def test_metadata_and_audio_match(runs):
    j, t = runs["jax_f32"], runs["torch_f32"]
    for key in ("duration", "fps", "size", "rotation", "audio_sample_rate", "audio_channels",
                "onset_detection_method", "video_fps", "total_frames", "face_detection_model"):
        assert t.metadata[key] == j.metadata[key], key
    assert t.metadata["landmark_model"] == j.metadata["landmark_model"]
    assert t.audio_onsets == j.audio_onsets and t.onset_count == j.onset_count > 0
    np.testing.assert_allclose(t.audio_envelope, j.audio_envelope, atol=1e-5, rtol=0)
    assert len(t.audio_envelope) == 60


def test_v1_faces_match_f32(runs):
    j, t = _faces(runs["jax_f32"]), _faces(runs["torch_f32"])
    assert [len(f) for f in t] == [len(f) for f in j] and len(t) == 6
    assert sum(len(f) > 0 for f in t) >= 5  # a face in almost every keyframe
    for fj, ft in zip(j, t):
        for (bj, cj), (bt, ct) in zip(fj, ft):
            assert abs(ct - cj) <= CONF_TOL
            assert all(abs(bt[k] - bj[k]) <= 1 for k in "xywh")  # int() of boxes within 0.05 px
    assert all(d["keyframe_path"].endswith(".png") and os.path.exists(d["keyframe_path"])
               for d in runs["torch_f32"].face_detections)


def test_v3_mouth_landmarks_match_f32(runs):
    j, t = runs["jax_f32"].mouth_landmarks, runs["torch_f32"].mouth_landmarks
    assert [m["frame_id"] for m in t] == [m["frame_id"] for m in j] == list(range(0, 60, 2))
    assert [bool(m["landmarks"]) for m in t] == [bool(m["landmarks"]) for m in j]
    assert sum(bool(m["landmarks"]) for m in t) >= 24
    for mj, mt in zip(j, t):
        if mj["landmarks"]:
            np.testing.assert_allclose(mt["landmarks"], mj["landmarks"], atol=LANDMARK_TOL_PX, rtol=0)


def test_slice_matches_jax_f32(runs):
    j, t = runs["jax_f32"], runs["torch_f32"]
    assert abs(t.lip_sync_score - j.lip_sync_score) <= LIP_TOL
    assert abs(t.fake_probability - j.fake_probability) <= PROB_TOL
    assert t.lip_sync_score > 0.5  # the clip's mouth follows its audio


def test_slice_bf16_defaults_match_jax_bf16(runs):
    """bf16 on both sides, held stage by stage to ``test_torch_bf16``'s bars:
    keyframe boxes within TOP_BOX_TOL of the frame (plus the int()
    truncation), scores within TOP_SCORE_TOL, mouth landmarks within
    LANDMARK_TOL of the ~110 px face box; then end to end (see
    ``BF16_LIP_TOL``)."""
    j, t = runs["jax_bf16"], runs["torch_bf16"]
    fj, ft = _faces(j), _faces(t)
    assert [len(f) for f in ft] == [len(f) for f in fj]
    for a, b in zip(fj, ft):
        for (bj, cj), (bt, ct) in zip(a, b):
            assert abs(ct - cj) <= TOP_SCORE_TOL
            assert all(abs(bt[k] - bj[k]) <= TOP_BOX_TOL * W + 1 for k in "xywh")
    valid = [bool(m["landmarks"]) for m in j.mouth_landmarks]
    assert [bool(m["landmarks"]) for m in t.mouth_landmarks] == valid
    for mj, mt in zip(j.mouth_landmarks, t.mouth_landmarks):
        if mj["landmarks"]:
            np.testing.assert_allclose(mt["landmarks"], mj["landmarks"], atol=LANDMARK_TOL * 110, rtol=0)
    assert abs(t.lip_sync_score - j.lip_sync_score) <= BF16_LIP_TOL
    assert abs(t.fake_probability - j.fake_probability) <= BF16_PROB_TOL


#: bf16 end to end on this clip, whose MAR series follows a real gated mouth:
#: the two packages gave |d lip| 1.0e-3 and |d probability| 1.1e-4 on the CPU,
#: about each package's own bf16-vs-f32 gap (JAX 1.0e-3, the port 3.7e-5).  The
#: bar is ten times that; the probability sees lip only, through
#: |w[lip_sync]| = 0.46 and a sigmoid slope of at most 1/4.
BF16_LIP_TOL = 1e-2
BF16_PROB_TOL = 0.25 * 0.46 * BF16_LIP_TOL


def test_no_kernel_launch_on_the_cpu(runs):
    assert _kernels.LAUNCHES["lipsync_score"] == 0


@pytest.fixture(scope="module")
def keyframes(clip):
    frames, kept = tmedia.VideoReader(use_cache=False).sample(clip, range(0, 60, 10))
    assert kept == list(range(0, 60, 10))
    return frames


def test_detector_float_boxes_match_f32(keyframes):
    """V1's provider alone: float pixel boxes and confidences of every slot
    with a score above 0, before any int() truncation."""
    jdet = _jax_providers().face_detector
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssd, "detect_batch_jit", functools.partial(jssd.detect_batch_jit,
                                                               compute_dtype=jnp.float32))
        ref = jdet.detect_batch(keyframes)
    got = _torch_providers(torch.float32).face_detector.detect_batch(keyframes)
    assert [len(d) for d in got] == [len(d) for d in ref] and all(len(d) > 0 for d in got)
    for dj, dt in zip(ref, got):
        for a, b in zip(dj, dt):
            assert abs(a.confidence - b.confidence) <= CONF_TOL
            assert max(abs(a.x1 - b.x1), abs(a.y1 - b.y1), abs(a.x2 - b.x2), abs(a.y2 - b.y2)) <= BOX_TOL_PX


def test_landmarks_only_program_matches_jax_fused_program(clip):
    """The JAX package's V3 takes ``landmarks_pose_from_frames`` (landmarks +
    V4's poses in one program) and drops the poses; the port's V3 takes the
    landmarks-only program.  On the same integer boxes their landmarks agree."""
    # V3's own grid and box count, so the JAX programs compiled for the DAG serve
    frames, ids = tmedia.VideoReader(use_cache=False).sample(clip, range(0, 60, 2))
    rng = np.random.RandomState(0)
    x1, y1 = rng.randint(80, 120, len(ids)), rng.randint(30, 60, len(ids))
    boxes = np.stack([x1, y1, x1 + rng.randint(90, 130, len(ids)), y1 + rng.randint(110, 160, len(ids))], 1)
    owners = np.arange(len(ids))
    jprov = _jax_providers().landmarks
    jb, jo, n = jlmk._marshal_boxes(boxes.tolist(), owners)
    coords, _ = jlmk.landmarks_pose_from_frames(
        jprov.landmark_params, jprov.pose_params, jnp.asarray(frames), jb, jo, float(W), float(H), 0.1,
        width=32, pose_width=32, compute_dtype=jnp.float32)
    tprov = _torch_providers(torch.float32).landmarks
    tb, to, tn = tlmk._marshal_boxes(boxes.tolist(), owners, "cpu")
    assert tn == n and np.array_equal(tb.numpy(), np.asarray(jb)) and np.array_equal(to.numpy(), np.asarray(jo))
    got = tlmk.landmarks_from_frames(tprov.landmark_model, torch.from_numpy(frames), tb, to,
                                     compute_dtype=torch.float32)[:n].numpy()
    extent = (boxes[:, 2:] - boxes[:, :2]).astype(np.float32)[:, None, :]
    np.testing.assert_allclose(got * extent, np.asarray(coords)[:n] * extent, atol=LANDMARK_TOL_PX, rtol=0)


def test_chunked_streaming_equals_one_chunk(clip, runs, tmp_path):
    """Chunks of 8 samples: V1 streams its keyframes without the union upload
    and V3 uploads and smooths chunk by chunk, carrying the filter state; the
    result equals the one-chunk run."""
    cfg = _config(tconfig, tmp_path)
    cfg = cfg.replace(landmarks=dataclasses.replace(cfg.landmarks, stream_chunk_frames=8))
    dag = _dag(trt, cfg, _torch_providers(torch.float32), (tin, ta1, ta3, tv1, tv3, tc1, tlr), device="cpu")
    tmedia.clear_frame_cache()
    final = trt.Scheduler(dag).invoke(tstate.State(input_path=clip))
    assert tmedia._device_frames.uploads == 4  # V3's four chunks; V1 reads host frames
    ref = runs["torch_f32"]
    assert _faces(final) == _faces(ref)
    assert [m["landmarks"] for m in final.mouth_landmarks] == [m["landmarks"] for m in ref.mouth_landmarks]
    assert final.lip_sync_score == ref.lip_sync_score


def test_videos_at_once_under_the_coalescer_match_one_at_a_time(clip, runs, tmp_path, monkeypatch):
    """Two videos of one length at once, each ``invoke`` on its own thread
    under the program coalescer: A1, A3 and C1 run as coalesced groups, and each video's result equals its run alone.  The
    window is fixed at 500 ms so the two videos' first calls meet however
    loaded the machine is."""
    from fvd_tpu_torch.synthetic import make_face_video

    broken = make_face_video(str(tmp_path / "clips"), "broken", duration=6.0, fps=10.0, sr=44100,
                             mouth_gate_hz=0.37)
    dag = _dag(trt, _config(tconfig, tmp_path), _torch_providers(torch.float32),
               (tin, ta1, ta3, tv1, tv3, tc1, tlr), device="cpu")
    alone = trt.Scheduler(dag).invoke(tstate.State(input_path=broken))
    tracer = trt.set_tracer(trt.Tracer())
    monkeypatch.setenv("FVD_TPU_NO_ADAPTIVE_WINDOW", "1")
    deactivate = tco._activate_program_coalescer(max_wait_ms=500.0)
    try:
        with ThreadPoolExecutor(2) as pool:
            finals = list(pool.map(lambda p: trt.Scheduler(dag).invoke(tstate.State(input_path=p)),
                                   [clip, broken]))
    finally:
        deactivate()
        trt.set_tracer(None)
    sizes = {k: [sp.meta["n"] for sp in tracer.spans if sp.name == k]
             for k in ("coalesce/a1_resample", "coalesce/a3_frontend", "coalesce/c1_lipsync")}
    assert all(sum(v) == 2 for v in sizes.values()), sizes
    assert max(sizes["coalesce/a1_resample"]) == 2  # one group of both videos
    for final, ref in zip(finals, (runs["torch_f32"], alone)):
        assert abs(final.lip_sync_score - ref.lip_sync_score) <= 1e-6
        assert final.audio_envelope == ref.audio_envelope
        assert [m["landmarks"] for m in final.mouth_landmarks] == [m["landmarks"] for m in ref.mouth_landmarks]
    assert finals[0].lip_sync_score > finals[1].lip_sync_score + 0.3  # in sync vs a dubbed mouth
