"""The 16-node DAG with the production bundle's models through both packages
on one clip: each package's ``production_providers`` on a checkpoint
directory of links to the shipped npz files (no ``hf/``, as on the card's
machine), so A2 runs the formant ASR, V2 the v2 OCR off the device frames,
C2 the CLIP and E1 the text encoder; the LLM and search are
``tests/test_torch_full_dag.py``'s scripted ones, so C3-E3 have claims.

Both packages in float32 (the JAX package through the same test-local
``compute_dtype=jnp.float32`` as ``tests/test_torch_full_dag.py``; its v2 OCR
detector computes in bf16 on both sides).  The clip carries tone-coded
speech, so the transcript has segments for C2 to match."""

import dataclasses
import functools
import os

import jax.numpy as jnp
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
from fvd_tpu.providers import factory as jfactory
from fvd_tpu.providers.search import make_result as jmake_result
from fvd_tpu_torch import _kernels
from fvd_tpu_torch import graph as tgraph
from fvd_tpu_torch.ops.fusion import FEATURE_ORDER
from fvd_tpu_torch.providers import factory as tfactory
from fvd_tpu_torch.providers import media as tmedia
from fvd_tpu_torch.providers.search import make_result as tmake_result
from fvd_tpu_torch.synthetic import make_face_video
from test_torch_full_dag import CKPT, CLAIMS, _bundle, _config, _evidence, _stream

#: every LR feature and the probability, float32 on both sides (measured on
#: this clip: lip 1.2e-7, headpose_jerk 2.3e-8, the other seven 0)
FEATURE_TOL, PROB_TOL = 1e-5, 1e-6
SPEECH = "the moon landing happened and water boils"
LINKED = ("face_ssd.npz", "landmarks.npz", "pose.npz", "pose.json", "ocr_det.npz", "ocr_det.json",
          "ocr_rec.npz", "clip.npz", "clip.json", "text_encoder.npz", "text_encoder.json", "asr.npz",
          "asr.json", "asr_formant.npz", "asr_formant.json")


def _zoo(pkg, bundle, make_result):
    """``bundle`` with the scripted LLM and search of the full-DAG test."""
    scripted = _bundle(pkg, make_result, None, None)
    return dataclasses.replace(bundle, llm=scripted.llm, search=scripted.search)


def _run_jax(ckpt, clip, root):
    prov = _zoo(jprov, jfactory.production_providers(ckpt, use_llm=False, use_search=False), jmake_result)
    dag = jgraph.build_graph(_config(jconfig, root), prov)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssd, "detect_batch_jit", functools.partial(jssd.detect_batch_jit, compute_dtype=jnp.float32))
        mp.setattr(jlmk, "landmarks_pose_from_frames",
                   functools.partial(jlmk.landmarks_pose_from_frames, compute_dtype=jnp.float32))
        return _stream(jrt, jstate, dag, clip)


def _run_torch(ckpt, clip, root):
    prov = _zoo(tprov, tfactory.production_providers(ckpt, device="cpu", compute_dtype=torch.float32),
                tmake_result)
    dag = tgraph.build_graph(_config(tconfig, root), prov, device="cpu")
    return _stream(trt, tstate, dag, clip)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    for n in LINKED:
        os.symlink(os.path.join(CKPT, n), ckpt / n)
    clip = make_face_video(str(tmp_path_factory.mktemp("clip")), "clip", duration=6.0, fps=10.0, sr=44100,
                           speech_text=SPEECH)
    tmedia.clear_frame_cache()
    _kernels.reset_launches()
    torch_run = _run_torch(str(ckpt), clip, tmp_path_factory.mktemp("torch"))
    out = {"torch": torch_run, "uploads": tmedia._device_frames.uploads,
           "jax": _run_jax(str(ckpt), clip, tmp_path_factory.mktemp("jax"))}
    tmedia.clear_frame_cache()
    return out


def test_zoo_nodes_all_done(runs):
    for pkg in ("torch", "jax"):
        events = runs[pkg][1]
        assert sorted(n for n, s in events if s == "done") == sorted(tgraph.NODE_ORDER), pkg


def test_lr_features_and_probability_match_jax(runs):
    t, j = runs["torch"][0], runs["jax"][0]
    for k in FEATURE_ORDER:
        assert abs(t.features[k] - j.features[k]) <= FEATURE_TOL, (k, t.features[k], j.features[k])
    assert abs(t.fake_probability - j.fake_probability) <= PROB_TOL
    assert t.features["speech_rate"] != 0.0  # A2 read words


def test_transcript_ocr_gestures_and_claims_match_jax(runs):
    t, j = runs["torch"][0], runs["jax"][0]
    assert t.metadata["transcription_model"] == j.metadata["transcription_model"] == "fvd_tpu_asr"
    assert t.transcript == j.transcript != "" and t.segments == j.segments
    assert t.metadata["ocr_model"] == j.metadata["ocr_model"] == "fvd_tpu_ocr"
    assert [[d["text"] for d in r["detections"]] for r in t.ocr_results] == \
        [[d["text"] for d in r["detections"]] for r in j.ocr_results]
    assert [(g["frame_id"], g["status"]) for g in t.gesture_check] == \
        [(g["frame_id"], g["status"]) for g in j.gesture_check] != []
    for gt, gj in zip(t.gesture_check, j.gesture_check):
        assert abs(gt["score"] - gj["score"]) <= FEATURE_TOL
    assert [c["claim_text"] for c in t.claims] == CLAIMS == [c["claim_text"] for c in j.claims]
    et, ej = _evidence(t), _evidence(j)
    assert [e["url"] for e in et] == [e["url"] for e in ej]
    for a, b in zip(et, ej):
        assert abs(a["relevance_score"] - b["relevance_score"]) <= FEATURE_TOL
    # E1 ranks by the text encoder: the same order per claim (E2 hands the
    # items on in completion order, so the ranking is read off the scores)

    def ranking(final):
        return sorted((e["claim_text"], -e["relevance_score"], e["url"]) for e in final.evidence)

    assert [(c, u) for c, _, u in ranking(t)] == [(c, u) for c, _, u in ranking(j)]


def test_one_frame_upload_and_no_launch_on_the_cpu(runs):
    """V1 uploads the frames once; V3, V4 and V2 gather from them."""
    assert runs["uploads"] == 1
    assert _kernels.LAUNCHES["lipsync_score"] == 0


if __name__ == "__main__":
    import pathlib
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        r = runs.__wrapped__(type("F", (), {"mktemp": staticmethod(
            lambda name: pathlib.Path(tempfile.mkdtemp(prefix=name, dir=tmp)))}))
        t, j = r["torch"][0], r["jax"][0]
        print({k: abs(t.features[k] - j.features[k]) for k in FEATURE_ORDER}, t.features)
        print(t.transcript, t.segments, [(g["status"], g["score"]) for g in t.gesture_check],
              [(g["status"], g["score"]) for g in j.gesture_check], t.ocr_results, j.ocr_results)
