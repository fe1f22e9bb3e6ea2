"""``python -m fvd_tpu_torch.cli`` on the CPU: the contract of
``fvd_tpu/cli.py`` (the last line printed is ``Fake probability: <p>``; a
label of 0 or 1 trains LR online; a URL or another container exits 1 with
IN's message) on a clip made with numpy, with the production bundle of
``providers/factory.py`` on the shipped checkpoints."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fvd_tpu_torch.providers as tprov
from fvd_tpu_torch import cli
from fvd_tpu_torch.providers import factory, media
from fvd_tpu_torch.synthetic import make_face_video

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: the variables that would give the production bundle a networked LLM or
#: search backend, or a cache directory
SERVICE_ENV = ("OPENAI_API_KEY", "OPENAI_BASE_URL", "SERPER_API_KEY", "GOOGLE_API_KEY", "GOOGLE_CX",
               "FVD_SEARCH_CACHE_DIR")


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A scratch cwd (the nodes write ``processed/``, ``features/`` and
    ``lr_weights.json`` there), no key for a networked service, and the
    process-wide provider bundle restored after the CLI installs its own."""
    monkeypatch.chdir(tmp_path)
    for k in SERVICE_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tprov, "_default", tprov.Providers())
    monkeypatch.setattr(tprov, "_default_is_custom", False)
    yield tmp_path
    media.clear_frame_cache()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return make_face_video(str(tmp_path_factory.mktemp("cli_clip")), "clip", duration=6.0, fps=10.0, sr=44100)


def _last_line(out):
    return out.strip().splitlines()[-1]


def test_cli_prints_fake_probability_and_trains_with_a_label(workdir, clip, capsys):
    assert cli.main([clip, "--cpu"]) == 0
    out = capsys.readouterr().out
    line = _last_line(out)
    assert line.startswith("Fake probability: ")
    p = float(line.split(": ")[1])
    assert 0.0 <= p <= 1.0
    assert "providers: LLM NullLLM, search ChainSearch(SerperSearch, GoogleCSESearch, DuckDuckGoSearch)" in out
    # checkpoints/hf is there: its models run
    assert "providers: text encoder HFTextEncoder, CLIP HFClip, ASR HFWhisperASR" in out
    assert tprov.get_providers().landmarks.device == torch.device("cpu")
    assert tprov.get_providers().asr.model_name == "hf_whisper_flax"
    assert not os.path.exists("lr_weights.json")  # no label, no update

    assert cli.main([clip, "1", "--cpu"]) == 0
    assert _last_line(capsys.readouterr().out) == line  # the bundle is kept; same weights, same clip
    assert os.path.exists("lr_weights.json")
    assert cli.main([clip, "--cpu"]) == 0
    p2 = float(_last_line(capsys.readouterr().out).split(": ")[1])
    assert p2 > p  # one SGD step towards label 1


@pytest.mark.parametrize("args,message", [(["x", "2"], "Label must be 0 or 1"),
                                          (["https://example.com/v.mp4"], "URL ingest is not ported"),
                                          (["{bad}"], "UnsupportedVideo")])
def test_cli_bad_input_exits_1(workdir, clip, capsys, args, message):
    if args[0] == "{bad}":
        with open("notavi.mp4", "wb") as f:
            f.write(b"\x00\x00\x00\x18ftypmp42" + bytes(64))
        args = ["notavi.mp4"]
    assert cli.main(args + ["--cpu"]) == 1
    assert message in capsys.readouterr().out


def test_cli_without_a_card_and_without_cpu_raises(workdir, clip):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([clip])


def test_production_bundle_on_the_shipped_checkpoints(monkeypatch):
    """Without keys: no LLM, and a search chain whose keyed backends send
    nothing and whose DuckDuckGo is refused (pointed at a closed loopback
    port: nothing here may reach an outside host), so it returns []."""
    import socket

    from fvd_tpu_torch.providers import search as tsearch

    for k in SERVICE_ENV:
        monkeypatch.delenv(k, raising=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setattr(tsearch.DuckDuckGoSearch, "ENDPOINT", f"http://127.0.0.1:{port}/html/")
    monkeypatch.setenv("NO_PROXY", "127.0.0.1")
    prov = factory.production_providers(os.path.join(ROOT, "checkpoints"), device="cpu")
    assert prov.llm.available is False
    assert tsearch.describe(prov.search) == "ChainSearch(SerperSearch, GoogleCSESearch, DuckDuckGoSearch)"
    assert prov.search.search("anything") == []
    # checkpoints/hf before the npz models: Whisper base, CLIP ViT-B/32, MiniLM-L6
    assert prov.clip.device == torch.device("cpu") and prov.clip.cal_scale != 1.0 and prov.clip.image_size == 224
    assert prov.asr.model_name == "hf_whisper_flax" and prov.asr.device == torch.device("cpu")
    assert prov.asr.model.config["d_model"] == 512 and prov.asr.max_new_tokens == 320
    assert prov.ocr.model_name == "fvd_tpu_ocr" and prov.ocr.det_arch == "v2"
    assert prov.text_encoder.model.embeddings.word_embeddings.weight.shape == (30522, 384)
    assert len(prov.text_encoder.model.encoder.layer) == 6
    assert prov.landmarks.pose_model.width == 32
    assert prov.landmarks.compute_dtype == torch.bfloat16
    assert factory.default_checkpoint_dir().endswith("checkpoints")


def test_module_entry_point_runs(tmp_path, clip):
    """``python -m fvd_tpu_torch.cli`` in a subprocess, from another cwd."""
    env = {k: v for k, v in os.environ.items() if k not in SERVICE_ENV}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-m", "fvd_tpu_torch.cli", clip, "--cpu"], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert np.isfinite(float(_last_line(proc.stdout).split("Fake probability: ")[1]))


def _hermetic(workdir):
    """Install the hermetic bundle, so the CLI's ``bootstrap_production``
    keeps it instead of loading the production bundle."""
    from fvd_tpu_torch.synthetic import hermetic_providers

    tprov.set_providers(hermetic_providers(device="cpu"))


def test_cli_stream_prints_one_line_per_update(workdir, clip, capsys):
    """``--stream`` on the production bundle: 6 s at 5 fps is 30 samples, two
    5 s chunks; a label is noted and ignored."""
    import re

    assert cli.main([clip, "1", "--stream", "--cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "Note: --stream is scoring-only; the label is ignored" in "\n".join(lines)
    updates = [ln for ln in lines if ln.startswith("[")]
    assert len(updates) == 2
    for ln in updates:
        assert re.fullmatch(r"\[ +\d+\.\ds +\d+\.\d%\] lip_sync=-?\d\.\d{3} p=\d\.\d{4}", ln), ln
    assert updates[-1].startswith("[   6.0s 100.0%]")
    p = float(lines[-1].split("Fake probability: ")[1])
    assert f"p={p:.4f}" in updates[-1]
    assert not os.path.exists("lr_weights.json")  # scoring only


def test_cli_stream_refuses_a_url(workdir, capsys):
    _hermetic(workdir)
    assert cli.main(["https://example.com/v.mp4", "--stream", "--cpu"]) == 1
    assert "--stream analyzes a local file as it is read" in capsys.readouterr().out


def test_cli_frontend_term_reads_a_path_from_stdin(workdir, clip, capsys, monkeypatch):
    import io

    _hermetic(workdir)
    monkeypatch.setattr(sys, "stdin", io.StringIO(clip + "\n"))
    assert cli.main(["--frontend-term", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "Enter a video path or URL:" in out and "=== Result ===" in out
    verdict = [ln for ln in out.splitlines() if ln.startswith("Verdict: ")]
    assert len(verdict) == 1 and verdict[0].split()[1] in ("FAKE", "REAL")


def test_cli_frontend_serves_the_web_ui_on_the_port(workdir, clip, monkeypatch):
    from fvd_tpu_torch.ui import web

    seen = {}
    monkeypatch.setattr(web, "serve_web", lambda **kw: seen.update(kw))
    _hermetic(workdir)
    assert cli.main([clip, "--frontend", "--port", "0", "--cpu"]) == 0
    assert seen == {"port": 0, "prefill_url": clip, "device": "cpu"}


def test_cli_needs_an_input_path_without_a_frontend(workdir, capsys):
    _hermetic(workdir)
    with pytest.raises(SystemExit) as exc:
        cli.main(["--cpu"])
    assert exc.value.code == 2
    assert "input_path is required when not using --frontend mode" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--stream", "--frontend", "--frontend-term"])
def test_cli_modes_without_a_card_and_without_cpu_raise(workdir, clip, flag, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _hermetic(workdir)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([clip, flag])
