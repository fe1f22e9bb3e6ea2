"""The port's host nodes and V4: mirrors ``tests/test_evidence_nodes.py``
(E1/E2/E3), ``tests/test_cross_modal_nodes.py`` (A2/V2/C2/C3) and the V4 cases
of ``tests/test_v3_v4_nodes.py`` on ``fvd_tpu_torch``, and holds the nodes
whose output the JAX package fixes (prompts, EnergyVAD segments, V4 on a
scripted provider) against it on the same inputs."""

import dataclasses
import http.server
import os
import threading

import numpy as np
import pytest

import fvd_tpu.providers as jprov
from fvd_tpu.nodes import (c2_gesture as jc2, c3_claims as jc3, e2_reliability as je2,
                           v4_dynamics as jv4)
from fvd_tpu.providers.asr import EnergyVAD as JEnergyVAD
from fvd_tpu.providers.vision import ScriptedLandmarks as JScriptedLandmarks
from fvd_tpu.state import State as JState
from fvd_tpu_torch.config import EvidenceConfig, default_config
from fvd_tpu_torch.nodes import (a2_asr, c2_gesture, c3_claims, e1_evidence, e2_reliability, e3_scorer,
                                 v2_ocr, v4_dynamics)
from fvd_tpu_torch.providers import (Providers, ScriptedASR, ScriptedLLM, ScriptedOCR, StaticSearch,
                                     StubClip)
from fvd_tpu_torch.providers.asr import EnergyVAD
from fvd_tpu_torch.providers.media import clear_frame_cache, write_video
from fvd_tpu_torch.providers.search import ChainSearch, FailingSearch, make_result
from fvd_tpu_torch.providers.vision import ScriptedLandmarks
from fvd_tpu_torch.runtime.io_pool import flush_artifacts
from fvd_tpu_torch.state import State
from fvd_tpu_torch.utils.png import encode_png
from fvd_tpu_torch.utils.wav import write_wav

FAST_CFG = dataclasses.replace(default_config(), evidence=EvidenceConfig(rate_limit_s=0.0, max_workers=2))
TRUSTED = {"high_trust": ["trusted.com"], "medium_trust": ["semi-trusted.com"]}


# ---------------------------------------------------------------------------
# E2 golden arithmetic (reference tests/test_e2_reliability.py:29-44)
# ---------------------------------------------------------------------------
def test_get_domain():
    assert e2_reliability.get_domain("https://www.example.com/page") == "example.com"
    assert e2_reliability.get_domain("http://sub.domain.org") == "sub.domain.org"
    assert e2_reliability.get_domain("invalid-url") == ""


@pytest.mark.parametrize("url,expected", [
    ("https://unknown.com", 0.6),           # base 0.5 + https 0.1
    ("https://usa.gov", 1.0),               # 0.5+0.4+0.1 capped
    ("https://www.trusted.com/news", 0.9),  # 0.5+0.3+0.1
    ("http://semi-trusted.com", 0.6),       # 0.5+0.1 (no https)
])
def test_heuristic_golden_values(url, expected):
    result = e2_reliability.heuristic_reliability(url, TRUSTED, consensus_count=0)
    assert result["score"] == pytest.approx(expected)
    assert result == je2.heuristic_reliability(url, TRUSTED, consensus_count=0)


def test_heuristic_consensus_boost_edu_and_subdomain_trust():
    assert e2_reliability.heuristic_reliability("https://unknown.com", TRUSTED, 3)["score"] == pytest.approx(0.7)
    assert e2_reliability.heuristic_reliability("https://mit.edu", TRUSTED, 0)["score"] == pytest.approx(0.9)
    assert e2_reliability.heuristic_reliability("https://news.trusted.com", TRUSTED, 0)["score"] == \
        pytest.approx(0.9)


def test_trusted_sources_load_as_the_jax_package_loads_them():
    assert e2_reliability.load_trusted_sources("assets") == je2.load_trusted_sources("assets")
    assert e2_reliability.load_trusted_sources("assets")["high_trust"]


def _serve(handler):
    srv = http.server.HTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


class _About(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        if self.path == "/about":
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")
        else:
            self.send_error(404)

    def log_message(self, *args):
        pass


class _NoAbout(_About):
    def do_GET(self):
        self.send_error(404)


def test_e2_about_page_probe_enabled():
    """The +0.1 about-page bonus with the probe enabled, against a local
    http.server (the probe is off by default)."""
    assert default_config().evidence.enable_about_page_probe is False
    srv, base = _serve(_About)
    try:
        cfg = dataclasses.replace(FAST_CFG, evidence=dataclasses.replace(FAST_CFG.evidence,
                                                                         enable_about_page_probe=True))
        assert e2_reliability.check_about_page(base + "/article") is True
        r = e2_reliability.heuristic_reliability(base + "/article", TRUSTED, 0, config=cfg, probe_about=True)
        assert r["score"] == pytest.approx(0.6)
        assert any("About page" in d for d in r["details"])
        delta = e2_reliability.run(State(evidence=[{"url": base + "/article", "claim_text": "c", "snippet": ""}]),
                                   cfg, Providers())
        assert delta["evidence"][0]["reliability_score"] == pytest.approx(0.6)
    finally:
        srv.shutdown()
        srv.server_close()


def test_e2_about_page_probe_missing_page():
    srv, base = _serve(_NoAbout)
    try:
        assert e2_reliability.check_about_page(base + "/x") is False
        assert e2_reliability.heuristic_reliability(base + "/x", TRUSTED, 0, probe_about=True)["score"] == \
            pytest.approx(0.5)
    finally:
        srv.shutdown()
        srv.server_close()


def test_e2_llm_primary_path_and_prompt_equal_jax():
    llm = ScriptedLLM(default={"score": 0.85, "reason": "reputable"})
    state = State(evidence=[{"url": "https://x.com", "claim_text": "c", "snippet": "s"}])
    delta = e2_reliability.run(state, FAST_CFG, Providers(llm=llm))
    assert delta["evidence"][0]["reliability_score"] == pytest.approx(0.85)
    assert "LLM" in delta["evidence"][0]["reliability_details"][0]
    jllm = jprov.ScriptedLLM(default={"score": 0.85, "reason": "reputable"})
    je2.run(JState(evidence=[{"url": "https://x.com", "claim_text": "c", "snippet": "s"}]),
            FAST_CFG, jprov.Providers(llm=jllm))
    assert llm.calls == jllm.calls


def test_e2_llm_failure_falls_back_to_heuristic():
    llm = ScriptedLLM(default={"nonsense": True})
    state = State(evidence=[{"url": "https://unknown.com", "claim_text": "c", "snippet": ""}])
    assert e2_reliability.run(state, FAST_CFG, Providers(llm=llm))["evidence"][0]["reliability_score"] == \
        pytest.approx(0.6)


def test_e2_llm_score_clamped():
    llm = ScriptedLLM(default={"score": 1.7, "reason": "overenthusiastic"})
    state = State(evidence=[{"url": "https://x.com", "claim_text": "c"}])
    assert e2_reliability.run(state, FAST_CFG, Providers(llm=llm))["evidence"][0]["reliability_score"] == 1.0


def test_e2_no_evidence_noop_and_missing_url_scores_zero():
    assert e2_reliability.run(State(), FAST_CFG, Providers()) == {}
    delta = e2_reliability.run(State(evidence=[{"claim_text": "c"}]), FAST_CFG, Providers())
    assert delta["evidence"][0]["reliability_score"] == 0.0


# ---------------------------------------------------------------------------
# E3 verdict bands + aggregation (reference tests/test_e3_scorer.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("score,verdict", [(0.71, "Highly Likely"), (0.7, "Likely"), (0.41, "Likely"),
                                           (0.4, "Possible"), (0.21, "Possible"), (0.2, "Unverified"),
                                           (0.0, "Unverified")])
def test_verdict_bands(score, verdict):
    assert e3_scorer.get_verdict(score) == verdict


def test_e3_averages_matched_evidence():
    state = State(claims=[{"id": "c1", "claim_text": "the sky is blue"}],
                  evidence=[{"claim_id": "c1", "claim_text": "the sky is blue", "reliability_score": 0.8},
                            {"claim_id": "c1", "claim_text": "the sky is blue", "reliability_score": 0.6}])
    claim = e3_scorer.run(state)["claims"][0]
    assert claim["evidence_score"] == pytest.approx(0.7)
    assert claim["verdict"] == "Likely"
    assert claim["evidence_count"] == 2


def test_e3_loose_match_fallback_and_string_claims():
    state = State(claims=[{"claim_text": "sky is blue"}],
                  evidence=[{"claim_text": "scientists say the SKY IS BLUE today", "reliability_score": 0.9}])
    assert e3_scorer.run(state)["claims"][0]["evidence_score"] == pytest.approx(0.9)
    state = State(claims=[{"claim_text": "completely unrelated"}],
                  evidence=[{"claim_text": "other", "reliability_score": 0.8}])
    claim = e3_scorer.run(state)["claims"][0]
    assert claim["evidence_score"] == pytest.approx(0.4) and claim["evidence_count"] == 1
    claim = e3_scorer.run(State(claims=["a plain string claim"], evidence=[]))["claims"][0]
    assert claim["text"] == "a plain string claim" and claim["verdict"] == "Unverified"
    assert e3_scorer.run(State(evidence=[{"reliability_score": 1.0}])) == {}


# ---------------------------------------------------------------------------
# E1 query construction / dedup / ranking / fallback chain
# ---------------------------------------------------------------------------
def test_construct_queries():
    claim = {"id": "x", "claim_text": "cats rule", "who": None, "what": None, "when": None, "where": None}
    queries = e1_evidence.construct_queries(claim)
    assert len(queries) == 7
    assert {"cats rule fact check", "cats rule debunked", "proof that cats rule"} <= set(queries)
    claim = dict(claim, claim_text="c", who="elon", what="crypto scam")
    queries = e1_evidence.construct_queries(claim)
    assert "elon crypto scam controversy" in queries and len(queries) == 8


def test_e1_dedup_and_rank():
    results = [make_result("https://a.com", "moon landing happened", "apollo 11 moon landing"),
               make_result("https://a.com", "dup", "dup"),
               make_result("https://b.com", "cooking pasta", "boil water for pasta")]
    deduped = e1_evidence.deduplicate(results)
    assert len(deduped) == 2
    ranked = e1_evidence.rank_results(deduped, "moon landing", Providers())
    assert ranked[0]["url"] == "https://a.com"
    assert ranked[0]["relevance_score"] > ranked[1]["relevance_score"]


def test_e1_end_to_end_flattening():
    search = StaticSearch({"fact check": [make_result("https://bbc.com/x", "t", "s")]})
    delta = e1_evidence.run(State(claims=["the earth is round"]), FAST_CFG, Providers(search=search))
    assert delta["claims"][0]["id"]
    item = delta["evidence"][0]
    assert item["claim_id"] == delta["claims"][0]["id"]
    assert item["claim_text"] == "the earth is round"
    assert len(item["query_variants"]) == 7
    assert "retrieval_timestamp" in item


def test_e1_fallback_chain_noop_and_ids():
    good = StaticSearch({}, default=[make_result("https://c.com", "t", "s")])
    failing = FailingSearch()
    assert ChainSearch([failing, FailingSearch(), good]).search("anything")[0]["url"] == "https://c.com"
    assert failing.calls == 1
    assert e1_evidence.run(State(), FAST_CFG, Providers()) == {}
    assert e1_evidence.run(State(claims=[{"id": "keep-me", "claim_text": "x"}]), FAST_CFG,
                           Providers())["claims"][0]["id"] == "keep-me"


# ---------------------------------------------------------------------------
# C2 (reference tests/test_c2_gesture_check.py)
# ---------------------------------------------------------------------------
def _keyframe(tmp_path, frame_id=30):
    path = str(tmp_path / f"frame_{frame_id:06d}.png")
    with open(path, "wb") as f:
        f.write(encode_png(np.full((48, 64, 3), 128, np.uint8)))
    return path


SEGMENTS = [{"start": 0.0, "end": 2.0, "text": "hello world"}]


@pytest.mark.parametrize("score,status,source", [(0.3, "Consistent", "clip_local"),
                                                 (0.1, "Inconsistent", "clip_local"),
                                                 (0.2, "Ambiguous (No API Key)", "clip_local")])
def test_c2_thresholds(tmp_path, score, status, source):
    state = State(keyframes=[_keyframe(tmp_path)], segments=SEGMENTS, metadata={"video_fps": 30.0})
    check = c2_gesture.run(state, providers=Providers(clip=StubClip(default=score)))["gesture_check"][0]
    assert (check["status"], check["source"]) == (status, source)
    assert check["timestamp"] == pytest.approx(1.0)  # frame 30 at 30 fps


def test_c2_ambiguous_triggers_llm_fallback_with_png_and_jax_prompt(tmp_path):
    state = State(keyframes=[_keyframe(tmp_path)], segments=SEGMENTS, metadata={"video_fps": 30.0})
    images = []

    class Vision(ScriptedLLM):
        def vision_json(self, system, prompt, imgs):
            images.extend(imgs)
            return super().vision_json(system, prompt, imgs)

    llm = Vision(default={"consistent": True, "reason": "matches"})
    check = c2_gesture.run(state, providers=Providers(clip=StubClip(default=0.2), llm=llm))["gesture_check"][0]
    assert check["status"] == "Consistent" and check["source"] == "llm_fallback"
    # the keyframe goes to the LLM as the JPEG bytes OpenCV gives the JAX package
    # (the test's name predates the port's JPEG encoder: the keyframe file stays PNG)
    jimages = []

    class JVision(jprov.ScriptedLLM):
        def vision_json(self, system, prompt, imgs):
            jimages.extend(imgs)
            return super().vision_json(system, prompt, imgs)

    jllm = JVision(default={"consistent": True, "reason": "matches"})
    jstate = JState(keyframes=[_keyframe(tmp_path)], segments=SEGMENTS, metadata={"video_fps": 30.0})
    jc2.run(jstate, providers=jprov.Providers(clip=jprov.StubClip(default=0.2), llm=jllm))
    assert len(images) == 1 and images[0][:4] == b"\xff\xd8\xff\xe0" and images == jimages
    assert llm.calls == jllm.calls


def test_c2_skips_without_match_keyframes_or_clip(tmp_path):
    state = State(keyframes=[_keyframe(tmp_path)], segments=[{"start": 10.0, "end": 12.0, "text": "far away"}],
                  metadata={"video_fps": 30.0})
    assert c2_gesture.run(state, providers=Providers())["gesture_check"] == []
    assert c2_gesture.run(State(), providers=Providers()) == {}
    state = State(keyframes=[_keyframe(tmp_path)], segments=SEGMENTS)
    assert c2_gesture.run(state, providers=Providers(clip=None)) == {}


def test_find_closest_segment_and_parse_frame_id():
    segs = [{"start": 0.0, "end": 1.0, "text": "a"}, {"start": 6.0, "end": 7.0, "text": "b"}]
    assert c2_gesture.find_closest_segment(0.5, segs)["text"] == "a"
    assert c2_gesture.find_closest_segment(4.5, segs)["text"] == "b"
    assert c2_gesture.find_closest_segment(3.5, segs) is None
    assert c2_gesture.parse_frame_id("/x/frame_000123.png") == 123
    assert c2_gesture.parse_frame_id("/x/keyframe_7.png") == 7
    assert c2_gesture.parse_frame_id("/x/noid.png") == -1


# ---------------------------------------------------------------------------
# C3 (reference tests/test_c3_openai_primary.py, test_c3_openai_fallback.py)
# ---------------------------------------------------------------------------
def test_c3_primary_extraction_and_prompt_equal_jax():
    llm = ScriptedLLM(default={"claims": ["water boils at 100C", "the sky is green", 7]})
    ocr = [{"keyframe_path": "x", "detections": [{"text": "BREAKING"}]}]
    delta = c3_claims.run(State(transcript="some transcript", ocr_results=ocr), providers=Providers(llm=llm))
    assert len(delta["claims"]) == 2
    claim = delta["claims"][0]
    assert claim["claim_text"] == claim["text"] == "water boils at 100C"
    assert claim["confidence"] == 0.95
    assert "BREAKING" in llm.calls[0]["prompt"]
    jllm = jprov.ScriptedLLM(default={"claims": []})
    jc3.run(JState(transcript="some transcript", ocr_results=ocr), providers=jprov.Providers(llm=jllm))
    assert llm.calls == jllm.calls


def test_c3_truncates_and_fails_empty():
    llm = ScriptedLLM(default={"claims": []})
    c3_claims.run(State(transcript="x" * 10000), providers=Providers(llm=llm))
    assert "x" * 4000 in llm.calls[0]["prompt"] and "x" * 4001 not in llm.calls[0]["prompt"]
    assert c3_claims.run(State(transcript="t"), providers=Providers())["claims"] == []
    assert c3_claims.run(State(transcript="t"), providers=Providers(llm=ScriptedLLM(default=None)))["claims"] == []
    assert c3_claims.run(State(transcript="t"),
                         providers=Providers(llm=ScriptedLLM(default={"claims": "x"})))["claims"] == []


# ---------------------------------------------------------------------------
# V2 (reference tests/test_v2_ocr_overlays.py)
# ---------------------------------------------------------------------------
def test_v2_collects_detections(tmp_path):
    kf = _keyframe(tmp_path)
    ocr = ScriptedOCR([{"text": "HELLO WORLD", "confidence": 0.93, "bbox": [[1, 2], [50, 2], [50, 12], [1, 12]]}])
    delta = v2_ocr.run(State(keyframes=[kf]), providers=Providers(ocr=ocr))
    assert delta["ocr_results"][0]["keyframe_path"] == kf
    det = delta["ocr_results"][0]["detections"][0]
    assert det["text"] == "HELLO WORLD" and det["bbox"][0] == [1, 2]
    assert delta["metadata"]["ocr_model"] == "scripted"


def test_v2_omits_empty_missing_and_noop(tmp_path):
    assert v2_ocr.run(State(keyframes=[_keyframe(tmp_path)]), providers=Providers())["ocr_results"] == []
    assert v2_ocr.run(State(keyframes=[str(tmp_path / "missing.png")]), providers=Providers())["ocr_results"] == []
    assert v2_ocr.run(State(), providers=Providers()) == {}


# ---------------------------------------------------------------------------
# A2 (reference tests/test_a2_vad_asr.py)
# ---------------------------------------------------------------------------
def _audio_dir(tmp_path):
    d = tmp_path / "run"
    d.mkdir()
    write_wav(str(d / "audio_16k.wav"), np.zeros(16000, np.float32), 16000)
    return str(d)


def test_a2_transcribes(tmp_path):
    asr = ScriptedASR("hello brave new world", [{"start": 0, "end": 1, "text": "hello"}])
    delta = a2_asr.run(State(data_dir=_audio_dir(tmp_path)), providers=Providers(asr=asr))
    assert delta["transcript"] == "hello brave new world"
    assert delta["word_count"] == 4 and len(delta["segments"]) == 1
    assert delta["metadata"]["transcription_model"] == "scripted"


def test_a2_noops(tmp_path):
    assert a2_asr.run(State(data_dir=str(tmp_path)), providers=Providers()) == {}
    assert a2_asr.run(State(data_dir=_audio_dir(tmp_path)), providers=Providers()) == {}


def test_energy_vad_segments_equal_jax(tmp_path):
    sr = 16000
    t = np.arange(sr * 3) / sr
    gate = ((t >= 0.5) & (t < 1.0)) | ((t >= 2.0) & (t < 2.5))
    sig = (0.5 * np.sin(2 * np.pi * 300 * t) * gate).astype(np.float32)
    path = str(tmp_path / "audio_16k.wav")
    write_wav(path, sig, sr)
    segs = EnergyVAD(device="cpu").transcribe(path)["segments"]
    assert len(segs) == 2
    assert segs[0]["start"] == pytest.approx(0.5, abs=0.15)
    assert segs[1]["start"] == pytest.approx(2.0, abs=0.15)
    assert segs == JEnergyVAD().transcribe(path)["segments"]
    # A1's in-memory signal gives the same segments as the file
    import torch

    assert EnergyVAD(device="cpu").transcribe("", audio=torch.from_numpy(sig))["segments"] == segs


# ---------------------------------------------------------------------------
# V4 on a scripted provider (reference tests/test_v4_blink_headpose.py style)
# ---------------------------------------------------------------------------
def _face_landmarks(i, frame):
    """A 68-point face drifting right, with eyes that close on every fifth
    frame (EAR ~0.33 open, ~0.08 closed)."""
    cx, cy = 70.0 + 1.5 * i, 60.0
    ang = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    pts = np.stack([cx + 30 * np.cos(ang), cy + 36 * np.sin(ang)], axis=1)
    h = 0.5 if i % 5 == 4 else 2.0
    eye = np.array([[-6, 0], [-2, -h], [2, -h], [6, 0], [2, h], [-2, h]], np.float64)
    pts[36:42] = [cx - 12, cy - 8] + eye
    pts[42:48] = [cx + 12, cy - 8] + eye
    return [pts]


POSES = np.stack([np.linspace(-5, 5, 10), np.linspace(0, 20, 10), np.zeros(10)], axis=1)


@pytest.fixture
def run_dir(tmp_path):
    frames = np.random.RandomState(0).randint(0, 255, (20, 120, 160, 3)).astype(np.uint8)
    write_video(str(tmp_path / "video.mp4"), frames, 10.0)
    clear_frame_cache()
    return str(tmp_path)


def test_v4_blink_and_pose_tracks_match_jax(run_dir):
    delta = v4_dynamics.run(State(data_dir=run_dir),
                            providers=Providers(landmarks=ScriptedLandmarks(_face_landmarks, POSES)))
    flush_artifacts(run_dir)
    blink, pose = delta["blink_data"], delta["head_pose_data"]
    assert len(blink) == 10 and len(pose) == 10  # 2 s at 10 fps sampled at 5 fps
    for b in blink:
        assert set(b) == {"frame_id", "timestamp", "ear"} and 0.0 < b["ear"] < 1.0
    assert all(set(p["pose"]) == {"pitch", "yaw", "roll"} for p in pose)
    assert max(p["pose"]["yaw"] for p in pose) <= 20.5  # OneEuro 0.1/0.1 keeps it near the ramp
    assert delta["headpose_viz_path"].endswith("headpose_viz.avi") and os.path.exists(delta["headpose_viz_path"])
    assert delta["metadata"]["blink_model"] == "EAR_smoothed"
    assert delta["metadata"]["pose_model"] == "scripted_pose_smoothed"

    ref = jv4.run(JState(data_dir=run_dir),
                  providers=jprov.Providers(landmarks=JScriptedLandmarks(_face_landmarks, POSES)))
    assert [(b["frame_id"], b["timestamp"]) for b in blink] == \
        [(b["frame_id"], b["timestamp"]) for b in ref["blink_data"]]
    np.testing.assert_allclose([b["ear"] for b in blink], [b["ear"] for b in ref["blink_data"]], atol=1e-6)
    assert [p["frame_id"] for p in pose] == [p["frame_id"] for p in ref["head_pose_data"]]
    for p, q in zip(pose, ref["head_pose_data"]):
        for k in ("pitch", "yaw", "roll"):
            assert p["pose"][k] == pytest.approx(q["pose"][k], abs=1e-4)


def test_v4_viz_frames_carry_box_and_ear_label(run_dir):
    """The PNG-in-AVI viz, read back with OpenCV: each frame has the tracked
    box in yellow and the "EAR: 0.xx" label in red."""
    import cv2

    from fvd_tpu_torch.providers.media import VideoReader

    delta = v4_dynamics.run(State(data_dir=run_dir),
                            providers=Providers(landmarks=ScriptedLandmarks(_face_landmarks, POSES)))
    flush_artifacts(run_dir)
    cap = cv2.VideoCapture(delta["headpose_viz_path"])
    viz = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        viz.append(bgr[..., ::-1])
    cap.release()
    viz = np.stack(viz)
    src, _ = VideoReader(use_cache=False).sample(os.path.join(run_dir, "video.mp4"), range(0, 20, 2))
    assert viz.shape == src.shape == (10, 120, 160, 3)
    label = viz[:, 16:30, 10:110]
    assert ((label == [255, 0, 0]).all(-1).sum(axis=(1, 2)) > 40).all()  # "EAR: 0.xx" in red
    assert ((viz == [255, 255, 0]).all(-1) & ~(src == [255, 255, 0]).all(-1)).any(axis=(1, 2)).all()


def test_v4_noops(run_dir, tmp_path_factory):
    assert v4_dynamics.run(State(data_dir=run_dir), providers=Providers()) == {}
    empty = str(tmp_path_factory.mktemp("empty"))
    assert v4_dynamics.run(State(data_dir=empty),
                           providers=Providers(landmarks=ScriptedLandmarks(_face_landmarks))) == {}
