"""One clip with tone-coded speech through the 16 nodes of both packages'
``production_providers(recorded_services=True)``: the production models on
the npz view of ``checkpoints/`` (the links of ``tests/test_torch_zoo_dag.py``,
no ``hf/``), the recorded LLM and search of ``providers/recorded.py``, both in
float32 (the JAX package through the test-local ``compute_dtype=jnp.float32``
of ``tests/test_torch_full_dag.py``), at the zoo bundle's bars.  This is the
bundle ``batch.run_pipeline_many`` scores with in the card's ``batch`` phase;
it sits in a file of its own because the JAX package's compiles take most of
a minute."""

import os

import jax.numpy as jnp
import pytest
import torch

from fvd_tpu_torch.ops import fusion as tfusion

#: the zoo bundle's bars (tests/test_torch_zoo_dag.py), float32 on both sides
ZOO_FEATURE_TOL, ZOO_PROB_TOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def recorded_runs(tmp_path_factory):
    """One clip with tone-coded speech through the 16 nodes of each package's
    ``production_providers(recorded_services=True)`` on the npz view of
    ``checkpoints/`` (the ``zoo`` fixture's links), both in float32."""
    import functools

    import fvd_tpu.config as jconfig
    import fvd_tpu.runtime as jrt
    import fvd_tpu.state as jstate
    import fvd_tpu_torch.config as tconfig
    import fvd_tpu_torch.runtime as trt
    import fvd_tpu_torch.state as tstate
    from fvd_tpu import graph as jgraph
    from fvd_tpu.models import face_ssd as jssd
    from fvd_tpu.models import landmarks_fan as jlmk
    from fvd_tpu.providers import factory as jfactory
    from fvd_tpu_torch import graph as tgraph
    from fvd_tpu_torch.providers import factory as tfactory
    from fvd_tpu_torch.providers import media as tmedia
    from fvd_tpu_torch.synthetic import make_face_video
    from test_torch_full_dag import CKPT, _config, _stream
    from test_torch_zoo_dag import LINKED, SPEECH

    ckpt = tmp_path_factory.mktemp("ckpt")
    for n in LINKED:
        os.symlink(os.path.join(CKPT, n), ckpt / n)
    clip = make_face_video(str(tmp_path_factory.mktemp("clip")), "clip", duration=6.0, fps=10.0, sr=44100,
                           speech_text=SPEECH)
    tmedia.clear_frame_cache()
    tprov_ = tfactory.production_providers(str(ckpt), device="cpu", compute_dtype=torch.float32,
                                           recorded_services=True)
    t = _stream(trt, tstate, tgraph.build_graph(_config(tconfig, tmp_path_factory.mktemp("torch")), tprov_,
                                                device="cpu"), clip)
    tmedia.clear_frame_cache()
    jprov_ = jfactory.production_providers(str(ckpt), use_llm=False, use_search=False, recorded_services=True)
    jdag = jgraph.build_graph(_config(jconfig, tmp_path_factory.mktemp("jax")), jprov_)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssd, "detect_batch_jit", functools.partial(jssd.detect_batch_jit, compute_dtype=jnp.float32))
        mp.setattr(jlmk, "landmarks_pose_from_frames",
                   functools.partial(jlmk.landmarks_pose_from_frames, compute_dtype=jnp.float32))
        j = _stream(jrt, jstate, jdag, clip)
    return {"torch": t, "jax": j, "providers": tprov_}


def test_recorded_bundle_runs_all_nodes(recorded_runs):
    from fvd_tpu_torch import graph as tgraph
    from fvd_tpu_torch.providers.recorded import RecordedLLM, RecordedSearch

    prov = recorded_runs["providers"]
    assert isinstance(prov.llm, RecordedLLM) and isinstance(prov.search, RecordedSearch)
    for pkg in ("torch", "jax"):
        events = recorded_runs[pkg][1]
        assert sorted(n for n, s in events if s == "done") == sorted(tgraph.NODE_ORDER), pkg


def test_recorded_bundle_features_match_jax(recorded_runs):
    t, j = recorded_runs["torch"][0], recorded_runs["jax"][0]
    for k in tfusion.FEATURE_ORDER:
        assert abs(t.features[k] - j.features[k]) <= ZOO_FEATURE_TOL, (k, t.features[k], j.features[k])
    assert abs(t.fake_probability - j.fake_probability) <= ZOO_PROB_TOL


def test_recorded_llm_reads_the_same_bytes(recorded_runs):
    """V5's recorded scores read the crops' JPEG bytes and C2's statuses hash
    the keyframes': equal to the last digit."""
    t, j = recorded_runs["torch"][0], recorded_runs["jax"][0]
    assert [d["fake_probability"] for d in t.texture_ela_details] == \
        [d["fake_probability"] for d in j.texture_ela_details] != []
    assert t.texture_ela_score == j.texture_ela_score
    assert [(g["frame_id"], g["status"], g["source"]) for g in t.gesture_check] == \
        [(g["frame_id"], g["status"], g["source"]) for g in j.gesture_check] != []


def test_recorded_claims_and_evidence_match_jax(recorded_runs):
    t, j = recorded_runs["torch"][0], recorded_runs["jax"][0]
    assert t.transcript == j.transcript != ""
    assert [c["claim_text"] for c in t.claims] == [c["claim_text"] for c in j.claims] != []
    assert [c["verdict"] for c in t.claims] == [c["verdict"] for c in j.claims]

    def ranking(final):
        return [(c, u) for c, _, u in sorted((e["claim_text"], -e["relevance_score"], e["url"])
                                             for e in final.evidence)]

    assert ranking(t) == ranking(j) != []
