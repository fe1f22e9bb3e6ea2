"""``python -m fvd_tpu_torch.tools.ab_bench`` against the JAX package's
``tools/ab_bench.py``: the arm order (A/B/A/B, or B first), the switches set
on B passes and removed on A passes and after the run, the warm-up of both
arms and the JSON line's keys.  The corpus, the bundle, the warm-up run and
``run_pipeline_many`` are stubbed: each pass records the switches it saw and
sleeps a little longer on B passes."""

import json
import os
import sys

import pytest
import torch

from fvd_tpu_torch.tools import ab_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ["lever", "a_best", "b_best", "a_med", "b_med", "speedup_best", "speedup_med", "passes"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def stubbed(monkeypatch):
    """The tool with its corpus, bundle, warm-up and passes stubbed; the
    record of what each call saw."""
    seen = {"corpus": [], "warm": [], "passes": [], "closed": 0, "cwd": []}
    monkeypatch.delenv("FVD_TPU_FUSED_DETLM", raising=False)
    monkeypatch.delenv("FVD_TPU_NO_STACK_MEMO", raising=False)

    def corpus(n, duration, ckpt_dir):
        seen["corpus"].append((n, duration, os.path.basename(ckpt_dir)))
        seen["cwd"].append(os.getcwd())
        return [f"media/clip{i}.avi" for i in range(n)]

    def bundle(ckpt_dir, device):
        def close():
            seen["closed"] += 1
        return "providers", "config", close

    def levers_now():
        return (os.environ.get("FVD_TPU_FUSED_DETLM"), os.environ.get("FVD_TPU_NO_STACK_MEMO"))

    def warm(providers, config, video, device):
        seen["warm"].append(levers_now())
        return 0.5

    def run_many(videos, config, providers, concurrency, device):
        import time

        seen["passes"].append((levers_now(), len(videos), concurrency, device.type))
        time.sleep(0.15 if levers_now()[0] else 0.05)
        return [0.5] * len(videos)

    monkeypatch.setattr(ab_bench, "_corpus", corpus)
    monkeypatch.setattr(ab_bench, "_bundle", bundle)
    monkeypatch.setattr(ab_bench, "_warm", warm)
    monkeypatch.setattr(ab_bench, "run_pipeline_many", run_many)
    return seen


def _json_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    return json.loads(out[0])


@pytest.mark.parametrize("b_first", [False, True])
def test_arms_alternate_and_levers_toggle(stubbed, capsys, b_first):
    cwd = os.getcwd()
    argv = ["FVD_TPU_FUSED_DETLM=1", "FVD_TPU_NO_STACK_MEMO=1", "--passes", "4", "--n-videos", "2",
            "--duration", "10", "--concurrency", "2", "--cpu"] + (["--b-first"] if b_first else [])
    assert ab_bench.main(argv) == 0
    out = _json_line(capsys)
    on, off = ("1", "1"), (None, None)
    assert stubbed["warm"] == [off, on]  # both arms warmed, A first
    arms = ["B", "A", "B", "A"] if b_first else ["A", "B", "A", "B"]
    assert [p[0] for p in stubbed["passes"]] == [on if a == "B" else off for a in arms]
    assert {p[1:] for p in stubbed["passes"]} == {(2, 2, "cpu")}
    assert stubbed["corpus"] == [(2, 10.0, "checkpoints")] and stubbed["closed"] == 1
    # a temporary working directory, left at the end; the switches removed
    assert stubbed["cwd"][0] != cwd and os.getcwd() == cwd and not os.path.exists(stubbed["cwd"][0])
    assert os.environ.get("FVD_TPU_FUSED_DETLM") is None and os.environ.get("FVD_TPU_NO_STACK_MEMO") is None
    assert list(out) == KEYS
    assert out["lever"] == "FVD_TPU_FUSED_DETLM=1 FVD_TPU_NO_STACK_MEMO=1"
    assert [a for a, _ in out["passes"]] == arms
    a = sorted(e for arm, e in out["passes"] if arm == "A")
    b = sorted(e for arm, e in out["passes"] if arm == "B")
    assert out["a_best"] == a[0] and out["b_best"] == b[0] and out["a_best"] < out["b_best"]
    assert out["speedup_best"] == pytest.approx(out["a_best"] / out["b_best"], rel=0.15)
    assert 0 < out["speedup_med"] < 1


def test_lever_must_be_an_assignment(stubbed):
    with pytest.raises(SystemExit):
        ab_bench.main(["FVD_TPU_FUSED_DETLM", "--cpu"])
    assert stubbed["passes"] == []


def test_flags_are_the_jax_tools():
    """The port's parser takes the JAX tool's flags with the same defaults."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import ab_bench as jax_tool  # noqa: F401 (the JAX tool's module, by its bare name)
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    import inspect

    src = inspect.getsource(jax_tool.main)
    for flag in ("--passes", "--n-videos", "--duration", "--concurrency", "--cpu", "--b-first"):
        assert f'"{flag}"' in src and f'"{flag}"' in inspect.getsource(ab_bench.main)
    for default in ("default=8", "default=30.0"):
        assert default in src and default in inspect.getsource(ab_bench.main)
