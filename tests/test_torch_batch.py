"""The port's batch harness (``fvd_tpu_torch/batch.py``) against the JAX
package's, mirroring ``tests/test_batch_harness.py``: labels, the video scan,
the feature-cache fast path with and without training, retry until correct,
the device replay of the corpus, the results table, ``main`` on the fast path
and at ``--concurrency 2``, and ``run_pipeline_many`` with
``synthetic.hermetic_providers`` against one-at-a-time runs and against the
JAX package's on the same clips.

Clips are the port's ``make_synthetic_video`` (3 s at 10 fps, 96x72), raw-RGBA
AVI files named ``*.mp4`` that the JAX package reads through OpenCV.  Both
packages' hermetic landmarks count their pose calls across videos, so
overlapped runs see another order of calls than one-at-a-time runs: those are
held to the JAX package's own bar for them (``tests/test_coalesce.py``,
``abs=2e-3``), one-at-a-time runs of the two packages to 1e-5."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvd_tpu_torch.providers as tprov
from fvd_tpu import batch as jbatch
from fvd_tpu.config import EvidenceConfig as JEvidenceConfig
from fvd_tpu.config import default_config as jdefault_config
from fvd_tpu.ops import fusion as jfusion
from fvd_tpu.synthetic import hermetic_providers as jhermetic
from fvd_tpu_torch import batch as tbatch
from fvd_tpu_torch.config import default_config as tdefault_config
from fvd_tpu_torch.nodes.lr_fusion import load_weights, save_weights
from fvd_tpu_torch.ops import fusion as tfusion
from fvd_tpu_torch.synthetic import hermetic_providers, make_synthetic_video

#: overlapped against one at a time (the JAX package's bar, tests/test_coalesce.py)
OVERLAP_TOL = 2e-3
#: the two packages one video at a time (the probability bar of tests/test_torch_full_dag.py)
PROB_TOL = 1e-5
#: the corpus replay, float32 on both sides
TRAIN_TOL = 1e-6

FEATS = {
    "speech_rate": 0.5, "pause_ratio": 0.1, "lip_sync": 0.6,
    "gesture_score": 1.0, "blink_rate": 0.4, "headpose_jerk": 0.1,
    "texture": 0.3, "claim_reliability": 0.7, "evidence_reliability": 0.8,
}
WEIGHTS = {"bias": 0.2, "lip_sync": -0.4, "texture": 0.8}


def _seed_cache(features_dir, name, feats):
    os.makedirs(features_dir, exist_ok=True)
    with open(os.path.join(features_dir, f"{name}.json"), "w") as f:
        json.dump(feats, f)


def _configs(root=None):
    """(port, JAX) configs with no E1 rate limit, writing under ``root``."""
    t, j = tdefault_config(), jdefault_config()
    t = t.replace(evidence=dataclasses.replace(t.evidence, rate_limit_s=0.0, max_workers=2))
    j = dataclasses.replace(j, evidence=JEvidenceConfig(rate_limit_s=0.0, max_workers=2))
    if root is not None:
        out = []
        for cfg, replace in ((t, t.replace), (j, lambda **kw: dataclasses.replace(j, **kw))):
            sub = os.path.join(root, "torch" if cfg is t else "jax")
            out.append(replace(fusion=dataclasses.replace(
                cfg.fusion, weights_path=os.path.join(sub, "lr_weights.json"),
                features_dir=os.path.join(sub, "features")), ingest=dataclasses.replace(
                cfg.ingest, processed_dir=os.path.join(sub, "processed"))))
            os.makedirs(sub, exist_ok=True)
        return tuple(out)
    return t, j


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    return [make_synthetic_video(str(root), name=f"c{i}", duration=3.0, fps=10.0, width=96, height=72,
                                 gate_hz=1.0 + 0.3 * i) for i in range(3)]


@pytest.mark.parametrize("name", ["Tom Cruise Deepfake.mp4", "totally FAKE video.mp4", "AI generated.mp4",
                                  "synthesia-demo.mp4", "bbc_news.mp4", "videos/paint.mp4", "real_a.mp4"])
def test_get_label_matches_jax(name):
    assert tbatch.get_label(name) == jbatch.get_label(name)
    assert tbatch.LABEL_KEYWORDS == jbatch.LABEL_KEYWORDS


def test_get_videos_sorted_by_duration(tmp_cwd):
    for name, seconds in (("long", 2.5), ("short", 1.0), ("mid", 1.5)):
        make_synthetic_video("videos", name=name, duration=seconds, fps=10.0, width=64, height=48)
    got = tbatch.get_videos("videos")
    assert [os.path.basename(p) for p in got] == ["short.mp4", "mid.mp4", "long.mp4"]
    assert got == jbatch.get_videos("videos")
    assert tbatch.get_videos("nowhere") == []


@pytest.mark.parametrize("train", [False, True])
def test_run_local_lr_fast_path_matches_jax(tmp_path, train):
    tcfg, jcfg = _configs(str(tmp_path))
    for cfg in (tcfg, jcfg):
        _seed_cache(cfg.fusion.features_dir, "fake_x.mp4", FEATS)
        save_weights(cfg.fusion.weights_path, WEIGHTS)
    p = tbatch.run_local_lr("videos/fake_x.mp4", 1, train, tcfg)
    assert p == jbatch.run_local_lr("videos/fake_x.mp4", 1, train, jcfg)
    assert p == pytest.approx(tfusion.predict_host(FEATS, WEIGHTS))
    w = load_weights(tcfg.fusion.weights_path)
    assert w == load_weights(jcfg.fusion.weights_path)
    if train:
        assert w["bias"] == pytest.approx(WEIGHTS["bias"] - 0.005 * (p - 1.0))
    else:
        assert w == WEIGHTS


def test_run_local_lr_missing_or_broken_cache_returns_none(tmp_path):
    tcfg, jcfg = _configs(str(tmp_path))
    assert tbatch.run_local_lr("videos/nope.mp4", None, False, tcfg) is None
    for cfg in (tcfg, jcfg):
        os.makedirs(cfg.fusion.features_dir, exist_ok=True)
        with open(os.path.join(cfg.fusion.features_dir, "bad.mp4.json"), "w") as f:
            f.write("{broken")
    assert tbatch.run_local_lr("bad.mp4", None, False, tcfg) is None is \
        jbatch.run_local_lr("bad.mp4", None, False, jcfg)


def test_evaluate_video_retries_until_correct_as_jax(tmp_path):
    tcfg, jcfg = _configs(str(tmp_path))
    for cfg in (tcfg, jcfg):
        _seed_cache(cfg.fusion.features_dir, "deepfake_y.mp4", FEATS)
        save_weights(cfg.fusion.weights_path, {"bias": -1.0})  # starts on the wrong side
    prob, attempts = tbatch.evaluate_video("videos/deepfake_y.mp4", True, 100, tcfg)
    assert (prob, attempts) == jbatch.evaluate_video("videos/deepfake_y.mp4", True, 100, jcfg)
    assert prob > 0.5 and attempts > 1
    assert load_weights(tcfg.fusion.weights_path) == load_weights(jcfg.fusion.weights_path)
    # without --train one attempt, no update
    assert tbatch.evaluate_video("videos/deepfake_y.mp4", False, 100, tcfg)[1] == 1


def test_train_device_matches_jax_and_host_replay(tmp_path):
    tcfg, jcfg = _configs(str(tmp_path))
    names = ["real_a.mp4", "deepfake_b.mp4", "real_c.mp4", "fake_d.mp4", "e.mp4"]
    rng = np.random.RandomState(0)
    all_feats = {n: {k: float(v) for k, v in zip(tfusion.FEATURE_ORDER, rng.rand(9))} for n in names}
    for cfg in (tcfg, jcfg):
        for n in names:
            _seed_cache(cfg.fusion.features_dir, n, all_feats[n])
        save_weights(cfg.fusion.weights_path, {"bias": 0.3, "texture": -0.8})
    msg = tbatch.train_device(tcfg, device="cpu")
    assert msg == jbatch.train_device(jcfg)  # the same updates per video
    assert msg.startswith("device-trained on 5 cached videos, iters=[")
    w_dev, w_jax = load_weights(tcfg.fusion.weights_path), load_weights(jcfg.fusion.weights_path)
    for k in ("bias",) + tfusion.FEATURE_ORDER:
        assert abs(w_dev[k] - w_jax[k]) <= TRAIN_TOL, k
    # the reference's sequential replay in float64, file order
    w_host = {"bias": 0.3, "texture": -0.8}
    for n in sorted(names):
        label = tbatch.get_label(n)
        for _ in range(100):
            p = tfusion.predict_host(all_feats[n], w_host)
            if (p > 0.5) == bool(label):
                break
            w_host, _ = tfusion.sgd_update_host(all_feats[n], w_host, label)
    for k in ("bias",) + tfusion.FEATURE_ORDER:
        assert w_dev[k] == pytest.approx(w_host.get(k, 0.0), abs=1e-5)
    assert tbatch.train_device(dataclasses.replace(tcfg, fusion=dataclasses.replace(
        tcfg.fusion, features_dir=str(tmp_path / "empty"))), device="cpu") is None


def test_train_until_correct_device_path_matches_jax():
    """``ops/fusion.train_until_correct`` on tensors, as ``train_device``
    calls it: equal updates per video, weights within 1e-6."""
    rng = np.random.RandomState(4)
    feats = rng.rand(12, 9).astype(np.float32)
    labels = (np.arange(12) % 3 == 0).astype(np.float32)
    w, b = (rng.randn(9) * 0.3).astype(np.float32), np.float32(0.4)
    tw, tb, ti = tfusion.train_until_correct(*(torch.from_numpy(np.asarray(x)) for x in (feats, labels, w, b)))
    jw, jb, ji = jfusion.train_until_correct(*(jnp.asarray(x) for x in (feats, labels, w, b)))
    assert ti.tolist() == np.asarray(ji).tolist() and sum(ti.tolist()) > 0
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=TRAIN_TOL)
    assert abs(float(tb) - float(jb)) <= TRAIN_TOL


@pytest.mark.parametrize("rows", [
    [("a.mp4", 0, 0.3), ("fake_b.mp4", 1, 0.7), ("c.mp4", 0, None)],
    [("x" * 70 + ".mp4", 1, 0.2), ("ai.mp4", 1, 0.5), ("ok.mp4", 0, 0.50000001)],
    [("e.mp4", 0, None)],
    [],
])
def test_format_results_equals_jax(rows):
    table = tbatch.format_results(rows)
    assert table == jbatch.format_results(rows)
    if rows and rows[0][2] == 0.3:
        assert "Total Accuracy: 100.00% (2/2)" in table and "ERROR" in table
        assert "| REAL  | CORRECT" in table and "| FAKE  | CORRECT" in table


@pytest.fixture
def installed(monkeypatch):
    """Install a bundle as the process default for ``main`` (whose
    ``bootstrap_production`` keeps an installed one)."""
    def install(bundle):
        monkeypatch.setattr(tprov, "_default", bundle)
        monkeypatch.setattr(tprov, "_default_is_custom", True)
    return install


def test_main_fast_path_with_training(tmp_cwd, installed):
    cfg = tdefault_config()
    make_synthetic_video("videos", name="real_clip", duration=1.0, fps=10.0, width=64, height=48)
    make_synthetic_video("videos", name="fake_clip", duration=1.5, fps=10.0, width=64, height=48)
    _seed_cache(cfg.fusion.features_dir, "real_clip.mp4", {**FEATS, "texture": 0.0})
    _seed_cache(cfg.fusion.features_dir, "fake_clip.mp4", {**FEATS, "texture": 0.9})
    save_weights(cfg.fusion.weights_path, {"bias": 0.0})
    installed(hermetic_providers(fps=10.0, device="cpu"))
    assert tbatch.main(["--train", "--cpu", "--results", "results/out.txt"]) == 0
    with open("results/out.txt") as f:
        table = f.read()
    assert "Total Accuracy: 100.00% (2/2)" in table
    # --train-device over the cache the run left, then the cleared cache
    assert tbatch.main(["--train-device", "--cpu", "--videos-dir", "none", "--results", "results/d.txt"]) == 0
    assert tbatch.main(["--clear-cache", "--cpu", "--videos-dir", "none"]) == 1
    assert not os.listdir(cfg.fusion.features_dir)


def test_main_concurrent_eval(tmp_cwd, installed, capsys):
    make_synthetic_video("videos", name="a", duration=2.0, fps=10.0, width=96, height=72)
    make_synthetic_video("videos", name="fake_b", duration=3.0, fps=10.0, width=96, height=72)
    save_weights(tdefault_config().fusion.weights_path, {"bias": 0.0, "lip_sync": -2.0})
    installed(hermetic_providers(fps=10.0, device="cpu"))
    assert tbatch.main(["--concurrency", "2", "--cpu", "--results", "results/cc.txt"]) == 0
    with open("results/cc.txt") as f:
        table = f.read()
    rows = [ln for ln in table.splitlines() if ln.startswith(("a.mp4", "fake_b.mp4"))]
    assert len(rows) == 2 and "ERROR" not in table and "Total Accuracy" in table
    # the pipelines wrote the feature cache: a second pass takes the fast path
    assert sorted(os.listdir("features")) == ["a.mp4.json", "fake_b.mp4.json"]
    assert tbatch.main(["--concurrency", "2", "--cpu", "--results", "results/cc2.txt"]) == 0
    with open("results/cc2.txt") as f:
        assert f.read() == table
    assert "ERROR running pipeline" not in capsys.readouterr().out


def test_main_needs_a_card_or_cpu(tmp_cwd, installed):
    installed(hermetic_providers(fps=10.0, device="cpu"))
    os.makedirs("videos")
    if torch.cuda.is_available():
        pytest.skip("a card is present: main runs on it")
    with pytest.raises(RuntimeError, match="cuda"):
        tbatch.main(["--train-device", "--videos-dir", "videos"])


@pytest.fixture(scope="module")
def hermetic_runs(clips, tmp_path_factory):
    """Each package's hermetic bundle over the clips, overlapped (2 at a time)
    and one at a time."""
    out = {}
    for mode in ("many", "seq"):
        tcfg, jcfg = _configs(str(tmp_path_factory.mktemp(mode)))
        tprov_, jprov_ = hermetic_providers(fps=10.0, device="cpu"), jhermetic(fps=10.0)
        if mode == "many":
            out[mode] = (tbatch.run_pipeline_many(clips, tcfg, tprov_, concurrency=2, device="cpu"),
                         jbatch.run_pipeline_many(clips, jcfg, jprov_, concurrency=2))
        else:
            out[mode] = ([tbatch.run_pipeline(c, None, tcfg, tprov_, device="cpu") for c in clips],
                         [jbatch.run_pipeline(c, None, jcfg, jprov_) for c in clips])
    return out


def test_run_pipeline_many_matches_one_at_a_time(hermetic_runs):
    many, seq = hermetic_runs["many"][0], hermetic_runs["seq"][0]
    assert len(many) == 3 and all(p is not None and 0.0 < p < 1.0 for p in many)
    assert many == pytest.approx(seq, abs=OVERLAP_TOL)


def test_run_pipeline_matches_jax_one_at_a_time(hermetic_runs):
    t, j = hermetic_runs["seq"]
    assert t == pytest.approx(j, abs=PROB_TOL)


def test_run_pipeline_many_matches_jax(hermetic_runs):
    t, j = hermetic_runs["many"]
    assert t == pytest.approx(j, abs=OVERLAP_TOL)


def test_run_pipeline_error_gives_none(tmp_path, capsys):
    tcfg, _ = _configs(str(tmp_path))
    assert tbatch.run_pipeline(str(tmp_path / "missing.mp4"), None, tcfg,
                               hermetic_providers(fps=10.0, device="cpu"), device="cpu") is None
    assert "ERROR running pipeline" in capsys.readouterr().out

