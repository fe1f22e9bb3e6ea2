"""The recorded LLM and search of the port (``providers/recorded.py``) against
the JAX package's, mirroring ``tests/test_recorded_providers.py``: the same
responses to the same prompts, images and queries, and V5 and C2 through
both packages with the recorded LLM on the same face crops and keyframes,
where the texture scores and the gesture statuses must be equal.

The recorded LLM reads the bytes V5 and C2 send: V5's score is the mean
|Laplacian| of the decoded crop and C2's fallback status a hash of the
keyframe's bytes, so both packages must send OpenCV's JPEG bytes."""

import dataclasses
import os

import numpy as np
import pytest

import fvd_tpu.providers as jprov
import fvd_tpu_torch.providers as tprov
from fvd_tpu.config import EvidenceConfig as JEvidenceConfig
from fvd_tpu.config import default_config as jdefault_config
from fvd_tpu.nodes import c2_gesture as jc2
from fvd_tpu.nodes import c3_claims as jc3
from fvd_tpu.nodes import e1_evidence as je1
from fvd_tpu.nodes import e2_reliability as je2
from fvd_tpu.nodes import e3_scorer as je3
from fvd_tpu.nodes import v5_forensics as jv5
from fvd_tpu.providers.recorded import RecordedLLM as JRecordedLLM
from fvd_tpu.providers.recorded import RecordedSearch as JRecordedSearch
from fvd_tpu.state import State as JState
from fvd_tpu.state import merge_states as jmerge
from fvd_tpu_torch.config import default_config as tdefault_config
from fvd_tpu_torch.nodes import c2_gesture as tc2
from fvd_tpu_torch.nodes import c3_claims as tc3
from fvd_tpu_torch.nodes import e1_evidence as te1
from fvd_tpu_torch.nodes import e2_reliability as te2
from fvd_tpu_torch.nodes import e3_scorer as te3
from fvd_tpu_torch.nodes import v5_forensics as tv5
from fvd_tpu_torch.providers.recorded import RecordedLLM, RecordedSearch
from fvd_tpu_torch.state import State as TState
from fvd_tpu_torch.state import merge_states as tmerge
from fvd_tpu_torch.synthetic import draw_face
from fvd_tpu_torch.utils.jpeg import encode_jpeg
from fvd_tpu_torch.utils.png import encode_png


def _c3_prompt(transcript, ocr=""):
    return (
        "You are a fact-checking assistant. Extract verifiable factual "
        "claims from the following text sources.\n\n"
        f"TRANSCRIPT:\n{transcript}\n\n"
        f"ON-SCREEN TEXT (OCR):\n{ocr}\n\n"
        "Instructions:\n1. Identify specific, factual claims"
    )


PROMPTS = [
    _c3_prompt("the mayor said the city will cut taxes"),
    _c3_prompt("the mayor said the city will cut taxes. the river rose two feet overnight in the valley",
               "BREAKING NEWS TONIGHT\nok"),
    _c3_prompt(" ".join(f"word{i}" for i in range(40))),
    "evaluating source reliability.\n- Domain: reuters.com\n",
    "evaluating source reliability.\n- Domain: someblog.biz\n",
    "evaluating source reliability.\n- Domain: census.gov\n",
    "write a poem",
]
QUERIES = ["the river level rose two feet fact check", "proof that the river level rose two feet",
           "is it true that the museum opened a wing", "the museum opened a wing hoax", "evidence for x"]


def _frame(seed, height=120, width=160, aperture=0.5):
    """A frame with the port's synthetic face, and the face's crop box."""
    rng = np.random.RandomState(seed)
    frame = (rng.rand(height, width, 3) * 60 + rng.rand(3) * 120).astype(np.uint8)
    fh = 0.62 * height
    fw = fh / 1.25
    skin = np.array([rng.randint(160, 230), rng.randint(120, 190), rng.randint(100, 170)])
    draw_face(frame, width / 2, height / 2, fw, fh, skin, aperture=aperture)
    x1, y1 = int(width / 2 - fw / 2), int(height / 2 - fh / 2)
    return frame, (x1, y1, int(fw), int(fh))


def _crops():
    out = []
    for seed in range(3):
        frame, (x, y, w, h) = _frame(seed, aperture=0.2 + 0.3 * seed)
        out.append(np.ascontiguousarray(frame[y: y + h, x: x + w]))
    return out


@pytest.mark.parametrize("prompt", PROMPTS)
def test_chat_json_matches_jax(prompt):
    assert RecordedLLM().chat_json("", prompt) == JRecordedLLM().chat_json("", prompt)


def test_vision_json_matches_jax_on_jpeg_crops():
    llm, jllm = RecordedLLM(), JRecordedLLM()
    system = "You are a forensic image analyst. Return keys 'fake_probability' and 'reasoning'."
    for crop in _crops():
        images = [encode_jpeg(crop)]
        out = llm.vision_json(system, "Analyze this face.", images)
        assert out == jllm.vision_json(system, "Analyze this face.", images)
        assert 0.02 <= out["fake_probability"] <= 0.98
        consistent = "Return JSON with 'consistent' (bool) and 'reason'."
        assert llm.vision_json("", consistent, images) == jllm.vision_json("", consistent, images)
    # undecodable bytes: the hash fallback, and no contract at all
    for images in ([b"crop-bytes"], []):
        assert llm.vision_json(system, "Analyze.", images) == jllm.vision_json(system, "Analyze.", images)
    assert llm.vision_json("", "describe", [b"x"]) is None is jllm.vision_json("", "describe", [b"x"])


def test_recorded_llm_contract_mirrors_jax_tests():
    llm = RecordedLLM()
    out = llm.chat_json("", _c3_prompt("the mayor said the city will cut taxes"))
    assert out["claims"] and "mayor" in out["claims"][0]
    r = llm.chat_json("", "evaluating source reliability.\n- Domain: reuters.com\n")
    assert 0.9 <= r["score"] <= 1.0
    v = llm.vision_json("return fake_probability", "Analyze.", [b"crop-bytes"])
    assert set(v) == {"fake_probability", "reasoning"} and 0.0 <= v["fake_probability"] <= 1.0
    c = llm.vision_json("", "Return JSON with 'consistent' (bool) and 'reason'.", [b"img"])
    assert isinstance(c["consistent"], bool)


@pytest.mark.parametrize("query", QUERIES)
def test_search_matches_jax(query):
    s, js = RecordedSearch(), JRecordedSearch()
    assert s.search(query) == js.search(query)
    assert s.search(query, max_results=2) == js.search(query, max_results=2)
    assert s.calls == js.calls == 2


def test_search_claim_scoped_urls():
    s = RecordedSearch()
    claim = "the river level rose two feet"
    a, b = s.search(f"{claim} fact check"), s.search(f"proof that {claim}")
    for r in a:
        assert {"url", "title", "snippet", "source", "date", "relevance_score"} <= set(r)
    assert {r["url"] for r in a} & {r["url"] for r in b}
    assert {r["url"] for r in a} != {r["url"] for r in s.search("the museum opened a wing fact check")}


def _face_detections(crops):
    return [{"frame_id": 10 * i, "faces": [{"confidence": 0.9 - 0.1 * i,
                                            "bbox": {"x": 5, "y": 5, "w": c.shape[1], "h": c.shape[0]},
                                            "crop": c}]}
            for i, c in enumerate(crops)]


def test_v5_texture_scores_match_jax():
    crops = _crops()
    t = tv5.run(TState(face_detections=_face_detections(crops)), tdefault_config(),
                tprov.Providers(llm=RecordedLLM()), device="cpu")
    j = jv5.run(JState(face_detections=_face_detections(crops)), jdefault_config(),
                jprov.Providers(llm=JRecordedLLM()))
    assert [d["fake_probability"] for d in t["texture_ela_details"]] == \
        [d["fake_probability"] for d in j["texture_ela_details"]]
    assert len(t["texture_ela_details"]) == 3
    assert t["texture_ela_score"] == j["texture_ela_score"]


def test_c2_statuses_match_jax(tmp_path):
    """Every keyframe's CLIP score sits in the ambiguous band, so every status
    comes from the recorded LLM's hash of the keyframe's bytes."""
    kdir = tmp_path / "run" / "keyframes"
    os.makedirs(kdir)
    keyframes, segments = [], []
    for i in range(12):
        frame, _ = _frame(i)
        path = str(kdir / f"frame_{30 * i}.png")
        with open(path, "wb") as f:
            f.write(encode_png(frame))
        keyframes.append(path)
        segments.append({"start": float(i), "end": i + 0.9, "text": f"narration {i}"})
    state = dict(keyframes=keyframes, segments=segments, metadata={"video_fps": 30.0})
    t = tc2.run(TState(**state), tdefault_config(),
                tprov.Providers(llm=RecordedLLM(), clip=tprov.StubClip(default=0.2)))
    j = jc2.run(JState(**state), jdefault_config(),
                jprov.Providers(llm=JRecordedLLM(), clip=jprov.StubClip(default=0.2)))
    got = [(g["frame_id"], g["status"], g["source"]) for g in t["gesture_check"]]
    assert got == [(g["frame_id"], g["status"], g["source"]) for g in j["gesture_check"]]
    assert len(got) == 12 and {s for _, _, s in got} == {"llm_fallback"}
    assert {s for _, s, _ in got} == {"Consistent", "Inconsistent"}  # the hash splits them
    assert t["gesture_check"] == j["gesture_check"]


def test_claim_chain_matches_jax():
    """C3 -> E1 -> E2 -> E3 with the recorded services in both packages: the
    same claims, evidence URLs, reliability scores and verdicts."""
    runs = []
    for nodes, state_cls, merge, prov, cfg in (
            ((tc3, te1, te2, te3), TState, tmerge, tprov, tdefault_config()),
            ((jc3, je1, je2, je3), JState, jmerge, jprov,
             dataclasses.replace(jdefault_config(), evidence=JEvidenceConfig(rate_limit_s=0.0, max_workers=2)))):
        if state_cls is TState:
            cfg = cfg.replace(evidence=dataclasses.replace(cfg.evidence, rate_limit_s=0.0, max_workers=2))
        if prov is tprov:
            providers = prov.Providers(llm=RecordedLLM(), search=RecordedSearch())
        else:
            providers = prov.Providers(llm=JRecordedLLM(), search=JRecordedSearch())
        state = state_cls(transcript="the state added nine thousand jobs in july")
        for node in nodes[:3]:
            state = merge(state, node.run(state, cfg, providers))
        state = merge(state, nodes[3].run(state, cfg))
        runs.append(state)
    t, j = runs
    assert [c["claim_text"] for c in t.claims] == [c["claim_text"] for c in j.claims] != []
    assert [(c["verdict"], c["evidence_count"]) for c in t.claims] == \
        [(c["verdict"], c["evidence_count"]) for c in j.claims]
    for a, b in zip(t.claims, j.claims):
        assert a["evidence_score"] == pytest.approx(b["evidence_score"], abs=1e-6)
    key = lambda e: (e["claim_text"], e["url"])  # noqa: E731
    et, ej = sorted(t.evidence, key=key), sorted(j.evidence, key=key)
    assert [key(e) for e in et] == [key(e) for e in ej] and et
    for a, b in zip(et, ej):
        assert a["reliability_score"] == pytest.approx(b["reliability_score"], abs=1e-6)
