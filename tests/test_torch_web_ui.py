"""The port's web frontend (``fvd_tpu_torch/ui/web.py``) on the CPU: the six
tests of ``tests/test_web_ui.py`` (the page, ``/graph``, the 400 for a
missing path, a full run, the artifact route and its 403, progressive mode)
through ``serve_web(port=0, block=False, device="cpu")`` on
``synthetic.hermetic_providers`` with a scripted ASR, LLM and search, so that
claims reach the result as in the JAX test."""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import fvd_tpu.providers as jprov
from fvd_tpu.ui.web import RunManager as JRunManager
from fvd_tpu_torch.config import default_config
from fvd_tpu_torch.graph import NODE_ORDER
from fvd_tpu_torch.providers import ScriptedASR, ScriptedLLM, StaticSearch, media
from fvd_tpu_torch.providers.search import make_result
from fvd_tpu_torch.synthetic import hermetic_providers, make_synthetic_video
from fvd_tpu_torch.ui.web import RunManager, serve_web

#: seconds a run of the 16 nodes (or the progressive analyzer) on the 6 s
#: clip may take on the CPU before a test gives up polling
RUN_TIMEOUT_S = 120


def _providers():
    asr = ScriptedASR(
        text="the moon landing happened in nineteen sixty nine and it was real",
        segments=[{"start": 0.0, "end": 2.0, "text": "the moon landing happened"},
                  {"start": 2.5, "end": 4.5, "text": "in nineteen sixty nine"},
                  {"start": 5.0, "end": 6.0, "text": "and it was real"}])
    llm = ScriptedLLM(responses={
        "fact-checking assistant": {"claims": ["the moon landing happened in 1969"]},
        "forensic image analyst": {"fake_probability": 0.3, "reasoning": "low ELA noise"},
        "source reliability": {"score": 0.85, "reason": "reputable outlet"},
    }, default=None)
    search = StaticSearch({"moon landing": [
        make_result("https://bbc.com/a", "Moon landing fact check", "the moon landing happened in 1969"),
        make_result("https://nasa.gov/apollo", "Apollo 11", "moon landing 1969")]})
    return dataclasses.replace(hermetic_providers(device="cpu"), asr=asr, llm=llm, search=search)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("web")
    mp = pytest.MonkeyPatch()
    mp.chdir(tmp)  # IN writes processed/, LR features/ and lr_weights.json here
    video = make_synthetic_video(str(tmp / "media"), name="clip", duration=6.0, fps=10.0, width=160, height=120)
    cfg = default_config()
    cfg = cfg.replace(evidence=dataclasses.replace(cfg.evidence, rate_limit_s=0.0, max_workers=2))
    srv, manager = serve_web(port=0, config=cfg, providers=_providers(), block=False, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", video, manager
    srv.shutdown()
    srv.server_close()
    mp.undo()
    media.clear_frame_cache()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(url):
    req = urllib.request.Request(url, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, json.loads(r.read())


def _wait(base, until):
    deadline = time.time() + RUN_TIMEOUT_S
    snap = None
    while time.time() < deadline:
        snap = json.loads(_get(base + "/status")[2])
        if until(snap):
            break
        time.sleep(0.3)
    return snap


def _idle(snap):
    return not snap["running"]


def test_index_serves_page(server):
    base, _, _ = server
    status, ctype, body = _get(base + "/")
    assert status == 200 and ctype.startswith("text/html")
    assert b"Fake Video Detection Engine" in body and b"PyTorch/CUDA" in body
    assert b"<video" not in body  # the viz is PNG-in-AVI: linked, not embedded


def test_graph_layout_equals_jax(server):
    base, _, _ = server
    _, _, body = _get(base + "/graph")
    layout = json.loads(body)
    assert set(layout["nodes"]) == set(NODE_ORDER)
    assert ["IN", "A1"] in [list(e) for e in layout["edges"]]
    ref = json.loads(json.dumps(JRunManager(providers=jprov.Providers()).graph_layout()))
    assert layout == ref


def test_analyze_requires_path(server):
    base, _, _ = server
    req = urllib.request.Request(base + "/analyze", method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=10)
    assert exc.value.code == 400


def test_full_run_through_server(server):
    base, video, _ = server
    _wait(base, _idle)
    _, resp = _post(base + f"/analyze?path={urllib.request.quote(video)}")
    assert resp["started"]
    _, resp2 = _post(base + f"/analyze?path={urllib.request.quote(video)}")
    assert resp2 == {"started": False}  # one run at a time

    snap = _wait(base, lambda s: s["result"] or s["error"])
    assert snap["error"] is None, snap["error"]
    result = snap["result"]
    assert result["verdict"] == ("FAKE" if result["fake_probability"] > 0.5 else "REAL")
    assert 0.0 < result["fake_probability"] < 1.0
    assert set(result["features"]) >= {"lip_sync", "texture", "speech_rate"}
    assert result["claims"] and result["claims"][0]["text"] == "the moon landing happened in 1969"
    assert all(snap["statuses"][n] == "done" for n in NODE_ORDER), snap["statuses"]
    assert result["viz"]["landmarks"].endswith("landmarks_viz.avi")


def test_artifact_endpoint_serves_and_restricts(server):
    base, video, _ = server
    _wait(base, _idle)
    _post(base + f"/analyze?path={urllib.request.quote(video)}")
    result = _wait(base, lambda s: s["result"] and not s["running"])["result"]
    assert result is not None

    # a keyframe inside data_dir serves, as the PNG the port writes
    frames = result["frames"]
    assert frames and frames[0]["keyframe"].endswith(".png")
    status, ctype, body = _get(base + "/artifact?path=" + urllib.request.quote(frames[0]["keyframe"]))
    assert status == 200 and ctype == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    # the viz serves as an AVI once its deferred encode has landed
    status, ctype, body = _get(base + "/artifact?path=" + urllib.request.quote(result["viz"]["landmarks"]))
    assert status == 200 and ctype == "video/x-msvideo" and body[:4] == b"RIFF" and body[8:12] == b"AVI "

    assert "audio_envelope" in result["signals"]
    assert "mar" in result["signals"]
    assert len(result["signals"]["mar"]) <= 200

    # traversal outside data_dir is forbidden
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(base + "/artifact?path=/etc/passwd", timeout=10)
    assert exc.value.code == 403


def test_progressive_mode_through_server(server):
    base, video, _ = server
    _wait(base, _idle)
    _, resp = _post(base + f"/analyze?path={urllib.request.quote(video)}&stream=true&chunk=2.0")
    assert resp["started"]
    snap = _wait(base, lambda s: not s["running"] and (s["result"] or s["error"]))
    assert snap["error"] is None, snap["error"]
    # 6 s video, 2 s chunks -> 3 progressive updates with rising coverage
    assert len(snap["progressive"]) == 3
    fractions = [u["fraction"] for u in snap["progressive"]]
    assert fractions == sorted(fractions) and fractions[-1] == 1.0
    assert all(0.0 <= u["p"] <= 1.0 for u in snap["progressive"])
    assert snap["result"]["verdict"] in ("FAKE", "REAL")
    assert snap["result"]["fake_probability"] == snap["progressive"][-1]["p"]


def test_run_manager_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        RunManager(providers=_providers())
