"""The 16-node DAG of ``graph.build_graph`` through both packages on one clip:
the port on ``device="cpu"``, both in float32, both with the shipped
``face_ssd.npz``, ``landmarks.npz`` and ``pose.npz`` at width 32 and the same
scripted bundle (ScriptedASR, ScriptedLLM, StaticSearch, NullOCR, StubClip,
the hashing text encoder).

The clip is the port's ``make_face_video`` (6 s at 10 fps, 320x240, a 44.1 kHz
wav so A1 resamples), a raw-RGBA AVI that the JAX package reads through
OpenCV.  The JAX package is set to f32 by passing ``compute_dtype=jnp.float32``
to ``detect_batch_jit`` and ``landmarks_pose_from_frames``, in this file only.
E1 stamps claims with a uuid and a time, and E2 scores on a thread pool in
completion order, so evidence is compared less those and sorted."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvd_tpu.config as jconfig
import fvd_tpu.providers as jprov
import fvd_tpu.runtime as jrt
import fvd_tpu.state as jstate
import fvd_tpu_torch.config as tconfig
import fvd_tpu_torch.providers as tprov
import fvd_tpu_torch.runtime as trt
import fvd_tpu_torch.state as tstate
from fvd_tpu import graph as jgraph
from fvd_tpu.models import face_ssd as jssd
from fvd_tpu.models import landmarks_fan as jlmk
from fvd_tpu.providers.search import make_result as jmake_result
from fvd_tpu_torch import _kernels
from fvd_tpu_torch import graph as tgraph
from fvd_tpu_torch.models import face_ssd as tssd
from fvd_tpu_torch.models import landmarks_fan as tlmk
from fvd_tpu_torch.ops.fusion import FEATURE_ORDER
from fvd_tpu_torch.providers import media as tmedia
from fvd_tpu_torch.providers.search import make_result as tmake_result
from fvd_tpu_torch.synthetic import make_face_video

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
#: the seven-node slice's bars (``tests/test_torch_video_dag.py``), held by every LR feature
FEATURE_TOL, PROB_TOL = 1e-4, 1e-5
#: head-pose jerk, a mean of |d angle| / dt over 5 fps samples of the pose
#: head's output, takes pose noise directly: |d angle| of POSE_TOL_DEG moves
#: it by up to 2 * POSE_TOL_DEG / 0.2 s / 100 = 5e-4 of the normalised
#: feature.  Measured on this clip (``python tests/test_torch_full_dag.py``
#: prints the gaps): angles within 2.8e-4 degree, the feature within 2.3e-8,
#: so it is held to the other features' bar
JERK_TOL = FEATURE_TOL
#: the pose head on the same crops (``tests/test_torch_pose.py``)
POSE_TOL_DEG = 5e-3
#: EAR at ~160 px coordinates after the OneEuro scan (measured 1.8e-6;
#: ``tests/test_torch_pose.py`` explains the ulp scale)
EAR_TOL = 1e-5

TRANSCRIPT = "the moon landing happened in 1969 and water boils at 100 degrees"
SEGMENTS = [{"start": 0.0, "end": 2.5, "text": "the moon landing happened in 1969"},
            {"start": 3.2, "end": 5.6, "text": "water boils at 100 degrees"}]
CLAIMS = ["the moon landing happened in 1969", "water boils at 100 degrees"]


def _bundle(pkg, make_result, landmarks, detector):
    """The scripted providers, from one package's classes."""
    search = {"moon landing": [make_result("https://www.nasa.gov/apollo11", "Apollo 11",
                                           "the moon landing happened in july 1969"),
                               make_result("https://en.wikipedia.org/wiki/Apollo_11", "Apollo 11 - Wikipedia",
                                           "apollo 11 was the first moon landing"),
                               make_result("http://moon-hoax.example.com/fake", "it was staged", "hoax")],
              "water boils": [make_result("https://www.bbc.com/science/boiling", "Boiling point",
                                          "water boils at 100 degrees at sea level"),
                              make_result("https://chem.mit.edu/water", "Phase changes", "boiling water")]}
    llm = {"Extract verifiable factual claims": {"claims": list(CLAIMS)},
           "forensic image analyst": {"fake_probability": 0.3, "reasoning": "scripted"}}
    return pkg.Providers(llm=pkg.ScriptedLLM(responses=llm), search=pkg.StaticSearch(search),
                         clip=pkg.StubClip(scripted={"moon": 0.3, "water": 0.1}),
                         asr=pkg.ScriptedASR(TRANSCRIPT, [dict(s) for s in SEGMENTS]),
                         ocr=pkg.NullOCR(), face_detector=detector, landmarks=landmarks)


def _config(config_mod, root):
    cfg = config_mod.default_config()
    return cfg.replace(ingest=dataclasses.replace(cfg.ingest, processed_dir=str(root / "processed")),
                       fusion=dataclasses.replace(cfg.fusion, weights_path=str(root / "lr_weights.json"),
                                                  features_dir=str(root / "features")),
                       evidence=dataclasses.replace(cfg.evidence, rate_limit_s=0.0))


def _stream(runtime, state_mod, dag, clip):
    events = list(runtime.Scheduler(dag).stream(state_mod.State(input_path=clip)))
    assert events[-1].node == "__end__" and events[-1].status == "done", events[-1].error
    return events[-1].delta["__final_state__"], [(e.node, e.status) for e in events[:-1]]


def _run_jax(clip, root):
    det = jssd.SSDFaceDetector(params=jssd.load_params(os.path.join(CKPT, "face_ssd.npz"), 32), width=32)
    zeros = jnp.zeros((1, 128, 128, 3))  # jitted inits: eager flax init compiles op by op
    lmk_tpl = jax.jit(jlmk.LandmarkHourglass(width=32).init)(jax.random.PRNGKey(1), zeros)
    pose_tpl = jax.jit(jlmk.PoseHead(width=32).init)(jax.random.PRNGKey(2), zeros)
    lmk = jlmk.FANLandmarks(det, landmark_params=jlmk.load_params(os.path.join(CKPT, "landmarks.npz"), lmk_tpl),
                            pose_params=jlmk.load_params(os.path.join(CKPT, "pose.npz"), pose_tpl),
                            width=32, pose_width=32)
    dag = jgraph.build_graph(_config(jconfig, root), _bundle(jprov, jmake_result, lmk, det))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssd, "detect_batch_jit", functools.partial(jssd.detect_batch_jit, compute_dtype=jnp.float32))
        mp.setattr(jlmk, "landmarks_pose_from_frames",
                   functools.partial(jlmk.landmarks_pose_from_frames, compute_dtype=jnp.float32))
        return _stream(jrt, jstate, dag, clip)


def _torch_landmarks():
    det = tssd.SSDFaceDetector(checkpoint=os.path.join(CKPT, "face_ssd.npz"), compute_dtype=torch.float32,
                               device="cpu")
    lmk = tlmk.FANLandmarks(det, checkpoint=os.path.join(CKPT, "landmarks.npz"),
                            pose_checkpoint=os.path.join(CKPT, "pose.npz"), compute_dtype=torch.float32,
                            device="cpu")
    return det, lmk


def _run_torch(clip, root):
    det, lmk = _torch_landmarks()
    dag = tgraph.build_graph(_config(tconfig, root), _bundle(tprov, tmake_result, lmk, det), device="cpu")
    return _stream(trt, tstate, dag, clip)


def both_runs(mktemp):
    """The port's and the JAX package's 16 nodes on one clip; ``mktemp(name)``
    gives a fresh directory (a ``pathlib.Path``)."""
    clip = make_face_video(str(mktemp("clip")), "clip", duration=6.0, fps=10.0, sr=44100)
    tmedia.clear_frame_cache()
    _kernels.reset_launches()
    tracer = trt.set_tracer(trt.Tracer())
    try:
        torch_run = _run_torch(clip, mktemp("torch"))
    finally:
        trt.set_tracer(None)
    out = {"torch": torch_run, "jax": _run_jax(clip, mktemp("jax")),
           "forwards": tmedia._landmark_share.forwards, "tracer": tracer}
    tmedia.clear_frame_cache()
    return out


def gaps(runs):
    """|port - JAX| per LR feature, the probability, the EARs and the angles."""
    t, j = runs["torch"][0], runs["jax"][0]
    out = {k: abs(t.features[k] - j.features[k]) for k in FEATURE_ORDER}
    out["fake_probability"] = abs(t.fake_probability - j.fake_probability)
    out["ear"] = max(abs(a["ear"] - b["ear"]) for a, b in zip(t.blink_data, j.blink_data))
    out["pose_deg"] = max(abs(a["pose"][k] - b["pose"][k]) for a, b in zip(t.head_pose_data, j.head_pose_data)
                          for k in ("pitch", "yaw", "roll"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return both_runs(tmp_path_factory.mktemp)


def test_sixteen_nodes_done_in_dependency_order(runs):
    dag = tgraph.build_graph(providers=tprov.Providers(), device="cpu")
    assert sorted(dag.nodes) == sorted(tgraph.NODE_ORDER) == sorted(jgraph.NODE_ORDER)
    assert tgraph.NODE_ORDER == jgraph.NODE_ORDER
    jdag = jgraph.build_graph(providers=jprov.Providers())
    assert sorted(dag.edges()) == sorted(jdag.edges())
    for pkg in ("torch", "jax"):
        events = runs[pkg][1]
        done = [n for n, s in events if s == "done"]
        assert sorted(done) == sorted(tgraph.NODE_ORDER) and not [n for n, s in events if s == "error"]
        at = {n: i for i, n in enumerate(done)}
        for dep, node in dag.edges():
            assert at[dep] < at[node], (pkg, dep, node)


def test_lr_features_and_probability_match_jax(runs):
    t, j = runs["torch"][0], runs["jax"][0]
    assert list(t.features) == list(FEATURE_ORDER) == list(j.features)
    for k in FEATURE_ORDER:
        tol = JERK_TOL if k == "headpose_jerk" else FEATURE_TOL
        assert abs(t.features[k] - j.features[k]) <= tol, (k, t.features[k], j.features[k])
    assert abs(t.fake_probability - j.fake_probability) <= PROB_TOL
    # every feature comes from its node: none of the eight new ones is left at 0
    assert all(t.features[k] != 0.0 for k in FEATURE_ORDER), t.features
    assert t.lip_sync_score > 0.5


def test_blinks_and_head_pose_match_jax(runs):
    t, j = runs["torch"][0], runs["jax"][0]
    assert [(b["frame_id"], b["timestamp"]) for b in t.blink_data] == \
        [(b["frame_id"], b["timestamp"]) for b in j.blink_data]
    assert len(t.blink_data) >= 24  # of 30 samples at 5 fps
    np.testing.assert_allclose([b["ear"] for b in t.blink_data], [b["ear"] for b in j.blink_data],
                               atol=EAR_TOL, rtol=0)
    assert [p["frame_id"] for p in t.head_pose_data] == [p["frame_id"] for p in j.head_pose_data]
    angles = [[p["pose"][k] for k in ("pitch", "yaw", "roll")] for p in t.head_pose_data]
    ref = [[p["pose"][k] for k in ("pitch", "yaw", "roll")] for p in j.head_pose_data]
    np.testing.assert_allclose(angles, ref, atol=POSE_TOL_DEG, rtol=0)
    assert t.metadata["pose_model"] == j.metadata["pose_model"]
    assert t.headpose_viz_path.endswith("headpose_viz.avi") and os.path.exists(t.headpose_viz_path)


def _evidence(final):
    drop = {"claim_id", "retrieval_timestamp"}
    return sorted(({k: v for k, v in e.items() if k not in drop} for e in final.evidence),
                  key=lambda e: (e["claim_text"], e["url"]))


def test_claims_evidence_and_gestures_match_jax(runs):
    t, j = runs["torch"][0], runs["jax"][0]
    assert [c["claim_text"] for c in t.claims] == CLAIMS == [c["claim_text"] for c in j.claims]
    for ct, cj in zip(t.claims, j.claims):
        assert {k: v for k, v in ct.items() if k != "id"} == {k: v for k, v in cj.items() if k != "id"}
    et, ej = _evidence(t), _evidence(j)
    assert [e["url"] for e in et] == [e["url"] for e in ej] and len(et) == 5
    assert et == ej
    assert [(g["frame_id"], g["status"]) for g in t.gesture_check] == \
        [(g["frame_id"], g["status"]) for g in j.gesture_check]
    assert {g["status"] for g in t.gesture_check} == {"Consistent", "Inconsistent"}
    assert t.transcript == j.transcript == TRANSCRIPT and t.word_count == j.word_count
    assert t.texture_ela_score == j.texture_ela_score == 0.3
    assert len(t.texture_ela_details) == 3


def test_artifacts_are_png(runs):
    t = runs["torch"][0]
    ela_dir = os.path.join(t.data_dir, "ela_analysis")
    assert sorted(os.listdir(ela_dir)) == ["ela_0.png", "ela_1.png", "ela_2.png",
                                           "fft_0.png", "fft_1.png", "fft_2.png"]


def test_one_shared_landmark_forward_per_chunk_and_no_launch_on_the_cpu(runs):
    """V3 and V4 meet in the landmark share: one forward for the clip's one
    chunk, and V4 runs no pose forward of its own."""
    assert runs["forwards"] == 1
    tracer = runs["tracer"]
    counts = tracer.counts()
    assert counts.get("v3/landmark_fwd") == counts.get("v4/landmark_fwd") == 1
    assert _kernels.LAUNCHES["lipsync_score"] == 0


if __name__ == "__main__":  # print the gaps the bars above come from
    import pathlib
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        print(gaps(both_runs(lambda name: pathlib.Path(tempfile.mkdtemp(prefix=name, dir=tmp)))))
