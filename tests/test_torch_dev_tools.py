"""The port's diagnostic tools on the CPU: ``render_dag_svg``, ``repro_node``
and ``profile_pipeline`` (``fvd_tpu_torch/tools/``).

* ``render_svg()`` equals the JAX package's ``tools/render_dag_svg.py``
  byte for byte, and ``docs/dag.svg``; ``main --out`` writes it.
* ``repro_node`` re-runs C1 and LR against the run directory of a
  ``--debug`` run of the 16 nodes (the hermetic bundle with the recorded
  LLM and search, on a synthetic clip): C1 from the state fields it reads gives the run's
  ``lip_sync_score``; LR, given the run's state without C2's and V5's
  outputs, recovers those from their debug files and gives the run's
  features and probability.
* ``profile_pipeline --cpu`` on a 2 s hermetic clip prints a row for each
  of the 16 nodes, and with ``--trace`` writes a Chrome trace holding each
  node's span."""

import json
import os

import pytest
import torch

from fvd_tpu_torch.graph import NODE_ORDER
from fvd_tpu_torch.tools import profile_pipeline, render_dag_svg, repro_node

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_render_svg_matches_jax_and_docs(tmp_path, capsys):
    jax_tool = pytest.importorskip("tools.render_dag_svg")
    svg = render_dag_svg.render_svg()
    assert svg == jax_tool.render_svg()
    with open(os.path.join(ROOT, "docs", "dag.svg")) as f:
        assert svg == f.read()
    out = tmp_path / "dag.svg"
    assert render_dag_svg.main(["--out", str(out)]) == 0
    assert out.read_text() == svg and capsys.readouterr().out == f"wrote {out}\n"


@pytest.fixture(scope="module")
def debug_run(tmp_path_factory):
    """A ``--debug`` run of the 16 nodes on a 2 s synthetic clip with the
    hermetic bundle and the recorded LLM and search (V5 scores the crops),
    in its own working directory -> (final state, dir)."""
    import dataclasses

    from fvd_tpu_torch.config import default_config
    from fvd_tpu_torch.graph import build_graph
    from fvd_tpu_torch.providers.recorded import RecordedLLM, RecordedSearch
    from fvd_tpu_torch.runtime.scheduler import Scheduler
    from fvd_tpu_torch.state import State
    from fvd_tpu_torch.synthetic import hermetic_providers, make_synthetic_video

    root = tmp_path_factory.mktemp("run")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        clip = make_synthetic_video("media", duration=2.0, fps=10.0)
        providers = dataclasses.replace(hermetic_providers(fps=10.0, device="cpu"), llm=RecordedLLM(),
                                        search=RecordedSearch())
        dag = build_graph(default_config().replace(debug=True), providers, device="cpu")
        final = Scheduler(dag).invoke(State(input_path=clip, debug=True))
    finally:
        os.chdir(cwd)
    return final, root


def _state_json(final, path, keys):
    from fvd_tpu_torch.runtime.debug import _jsonable

    with open(path, "w") as f:
        json.dump({k: _jsonable(getattr(final, k)) for k in keys}, f)
    return str(path)


#: the state fields C1 reads
C1_KEYS = ("face_detections", "mouth_landmarks", "metadata", "audio_envelope")
#: the fields LR reads, less C2's ``gesture_check`` and V5's
#: ``texture_ela_score``, which it recovers from their debug files
LR_KEYS = ("input_path", "metadata", "segments", "word_count", "lip_sync_score", "blink_data", "head_pose_data",
           "claims", "evidence")


def test_repro_c1_gives_the_runs_score(debug_run, tmp_path, monkeypatch, capsys):
    final, root = debug_run
    monkeypatch.chdir(root)
    assert final.lip_sync_score != 0.0 and os.path.exists(os.path.join(final.data_dir, "C1_debug.json"))
    extra = _state_json(final, tmp_path / "c1.json", C1_KEYS)
    delta = repro_node.main(["C1", "--data-dir", final.data_dir, "--state-json", extra, "--cpu"])
    assert delta["lip_sync_score"] == final.lip_sync_score
    assert "=== C1 delta ===" in capsys.readouterr().out


def test_repro_lr_recovers_from_the_debug_files(debug_run, tmp_path, monkeypatch, capsys):
    final, root = debug_run
    monkeypatch.chdir(root)
    for node in ("C2", "V5"):
        assert os.path.exists(os.path.join(final.data_dir, f"{node}_debug.json"))
    extra = _state_json(final, tmp_path / "lr.json", LR_KEYS)
    delta = repro_node.main(["LR", "--data-dir", final.data_dir, "--state-json", extra, "--debug"])
    assert final.texture_ela_score > 0.0
    assert delta["features"] == final.features
    assert delta["fake_probability"] == final.fake_probability
    out = capsys.readouterr().out
    assert "=== LR delta ===" in out and "fake_probability: " in out


def test_profile_pipeline_prints_every_node(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    res = profile_pipeline.main(["--cpu", "--duration", "2", "--fps", "10", "--trace", "trace"])
    out = capsys.readouterr().out
    rows = {line.split()[0] for line in out.splitlines() if line.startswith("node/")}
    assert rows == {f"node/{n}" for n in NODE_ORDER}
    assert out.startswith("backend: cpu") and "total wall: " in out
    assert 0.0 <= res["fake_probability"] <= 1.0
    assert res["trace"] == str(tmp_path / "trace" / "trace.json")
    # the run's files went to a temporary directory, and the tool came back
    assert os.getcwd() == str(tmp_path) and sorted(os.listdir(tmp_path)) == ["trace"]
    with open(res["trace"]) as f:
        spans = {e["name"] for e in json.load(f)["traceEvents"] if str(e.get("name", "")).startswith("node/")}
    assert spans == rows
