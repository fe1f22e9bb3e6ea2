"""The 16-node DAG with ``checkpoints/hf`` on both sides: each package's
``production_providers`` on a checkpoint directory of links to the shipped
npz files and ``hf/``, so A2 runs Whisper base, C2 the CLIP ViT-B/32 and E1
MiniLM in both, with ``tests/test_torch_full_dag.py``'s scripted LLM and
search (C3-E3 have claims).  The clip's audio is formant speech, Whisper's
domain, so A2 has a transcript and C2 segments to match (the port's copy of
``fvd_tpu/models/synthetic_speech.py``, ``make_face_video(speech="formant")``).

Float32 on both sides (the JAX vision models through the test-local
``compute_dtype=jnp.float32`` of ``tests/test_torch_zoo_dag.py``).  The JAX
package's HF models load through ``from_pretrained(..., _do_init=False)``
(``tests/test_torch_hf_models.py``): its factory's precedence runs as it is.
Bars: every LR feature 1e-5, the probability 1e-6, C2 scores 1e-5;
transcripts, segments, claims, evidence ranking and C2 statuses equal."""

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
from test_torch_full_dag import CKPT, CLAIMS, _config, _evidence, _stream
from test_torch_hf_models import jax_from_local_without_init
from test_torch_zoo_dag import LINKED, _zoo

pytest.importorskip("transformers")

FEATURE_TOL, PROB_TOL = 1e-5, 1e-6
SPEECH = "the moon landing happened and water boils"
HF_KINDS = ("HFTextEncoder", "HFClip", "HFWhisperASR")


def _run_jax(bundle, clip, root):
    dag = jgraph.build_graph(_config(jconfig, root), bundle)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssd, "detect_batch_jit", functools.partial(jssd.detect_batch_jit, compute_dtype=jnp.float32))
        mp.setattr(jlmk, "landmarks_pose_from_frames",
                   functools.partial(jlmk.landmarks_pose_from_frames, compute_dtype=jnp.float32))
        return _stream(jrt, jstate, dag, clip)


def _run_torch(bundle, clip, root):
    return _stream(trt, tstate, tgraph.build_graph(_config(tconfig, root), bundle, device="cpu"), clip)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    for n in LINKED:
        os.symlink(os.path.join(CKPT, n), ckpt / n)
    os.symlink(os.path.join(CKPT, "hf"), ckpt / "hf")
    clip = make_face_video(str(tmp_path_factory.mktemp("clip")), "clip", duration=6.0, fps=10.0, sr=16000,
                           speech_text=SPEECH, speech="formant")
    tmedia.clear_frame_cache()
    _kernels.reset_launches()
    tbundle = _zoo(tprov, tfactory.production_providers(str(ckpt), device="cpu", compute_dtype=torch.float32),
                   tmake_result)
    torch_run = _run_torch(tbundle, clip, tmp_path_factory.mktemp("torch"))
    with pytest.MonkeyPatch.context() as mp:
        jax_from_local_without_init(mp)
        jbundle = _zoo(jprov, jfactory.production_providers(str(ckpt), use_llm=False, use_search=False),
                       jmake_result)
    out = {"torch": torch_run, "uploads": tmedia._device_frames.uploads,
           "jax": _run_jax(jbundle, clip, tmp_path_factory.mktemp("jax")),
           "kinds": {pkg: tuple(type(getattr(b, seam)).__name__ for seam in ("text_encoder", "clip", "asr"))
                     for pkg, b in (("torch", tbundle), ("jax", jbundle))}}
    tmedia.clear_frame_cache()
    return out


def test_both_factories_pick_the_hf_models(runs):
    assert runs["kinds"]["torch"] == runs["kinds"]["jax"] == HF_KINDS


def test_hf_nodes_all_done(runs):
    for pkg in ("torch", "jax"):
        events = runs[pkg][1]
        assert sorted(n for n, s in events if s == "done") == sorted(tgraph.NODE_ORDER), pkg


def test_lr_features_and_probability_match_jax(runs):
    t, j = runs["torch"][0], runs["jax"][0]
    for k in FEATURE_ORDER:
        assert abs(t.features[k] - j.features[k]) <= FEATURE_TOL, (k, t.features[k], j.features[k])
    assert abs(t.fake_probability - j.fake_probability) <= PROB_TOL
    assert t.features["speech_rate"] != 0.0  # A2 read words


def test_transcript_gestures_claims_and_evidence_match_jax(runs):
    t, j = runs["torch"][0], runs["jax"][0]
    assert t.metadata["transcription_model"] == j.metadata["transcription_model"] == "hf_whisper_flax"
    assert t.transcript == j.transcript != "" and t.segments == j.segments
    assert [(g["frame_id"], g["status"]) for g in t.gesture_check] == \
        [(g["frame_id"], g["status"]) for g in j.gesture_check] != []
    for gt, gj in zip(t.gesture_check, j.gesture_check):
        assert abs(gt["score"] - gj["score"]) <= FEATURE_TOL
    assert [c["claim_text"] for c in t.claims] == CLAIMS == [c["claim_text"] for c in j.claims]
    et, ej = _evidence(t), _evidence(j)
    assert [e["url"] for e in et] == [e["url"] for e in ej]
    for a, b in zip(et, ej):
        assert abs(a["relevance_score"] - b["relevance_score"]) <= FEATURE_TOL

    def ranking(final):
        return sorted((e["claim_text"], -e["relevance_score"], e["url"]) for e in final.evidence)

    assert [(c, u) for c, _, u in ranking(t)] == [(c, u) for c, _, u in ranking(j)]


def test_one_frame_upload_and_no_launch_on_the_cpu(runs):
    assert runs["uploads"] == 1
    assert _kernels.LAUNCHES["lipsync_score"] == 0
