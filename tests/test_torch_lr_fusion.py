"""The LR fusion node and ``ops/fusion.py`` of the port against the JAX
package: the reference's float64 math, the feature builders with their
debug-JSON recovery paths, what the node writes (feature cache, updated
weights), and the device half (batched forward, one SGD epoch, the
retry-until-correct replay) in float32."""

import dataclasses
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvd_tpu.config import default_config as jdefault_config
from fvd_tpu.nodes import lr_fusion as jlr
from fvd_tpu.ops import fusion as jfusion
from fvd_tpu.state import State as JState
from fvd_tpu_torch.config import default_config as tdefault_config
from fvd_tpu_torch.nodes import lr_fusion as tlr
from fvd_tpu_torch.ops import fusion as tfusion
from fvd_tpu_torch.state import State as TState

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "lr_parity.json")
with open(FIXTURE) as f:
    PARITY = json.load(f)
WEIGHTS = PARITY["weights"]
CORPUS = PARITY["corpus"]
#: float64 host math against the fixture's float64 expectations
HOST_TOL = 1e-12


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_predict_host_matches_fixture(name):
    entry = CORPUS[name]
    p = tfusion.predict_host(entry["features"], WEIGHTS)
    assert abs(p - entry["expected_probability"]) < HOST_TOL
    assert p == jfusion.predict_host(entry["features"], WEIGHTS)


@pytest.mark.parametrize("z", [1000.0, -1000.0, 0.0, 1e-300, -37.5, 12.25, -0.5])
def test_stable_sigmoid_matches_jax(z):
    assert tfusion.stable_sigmoid(z) == jfusion.stable_sigmoid(z)


def test_sgd_replay_matches_jax_and_reference_rule():
    """One online update per corpus video in order, both packages, labels by
    name; every intermediate weight dict and probability is bit-equal."""
    w_t, w_j = dict(WEIGHTS), dict(WEIGHTS)
    for name in sorted(CORPUS):
        feats, label = CORPUS[name]["features"], int("fake" in name.lower())
        w_t_next, p_t = tfusion.sgd_update_host(feats, w_t, label)
        w_j, p_j = jfusion.sgd_update_host(feats, w_j, label)
        assert w_t_next == w_j and p_t == p_j
        err = p_t - label
        assert abs(w_t_next["bias"] - (w_t["bias"] - 0.005 * err)) < HOST_TOL
        w_t = w_t_next
    assert tfusion.DEFAULT_LEARNING_RATE == jfusion.DEFAULT_LEARNING_RATE


def test_vector_helpers_match_jax():
    for name in sorted(CORPUS):
        feats = CORPUS[name]["features"]
        np.testing.assert_array_equal(tfusion.features_to_vector(feats), jfusion.features_to_vector(feats))
    for a, b in zip(tfusion.weights_to_vectors(WEIGHTS), jfusion.weights_to_vectors(WEIGHTS)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    w, b = tfusion.weights_to_vectors(WEIGHTS)
    assert tfusion.vectors_to_weights(w, b) == jfusion.vectors_to_weights(w, b)
    assert tfusion.FEATURE_ORDER == jfusion.FEATURE_ORDER
    assert tfusion.features_to_vector({}).tolist() == [0.0] * 9


def _rich_fields(data_dir):
    return dict(
        input_path="demo.mp4",
        data_dir=str(data_dir),
        metadata={"duration": 10.0},
        word_count=25,
        segments=[{"start": 5.5, "end": 9.0}, {"start": 0.0, "end": 2.0},
                  {"start": 3.0, "end": 5.0}],  # unsorted: gaps of 1 s and 0.5 s
        lip_sync_score=0.6,
        gesture_check=[{"status": "Consistent"}, {"status": "Consistent"},
                       {"status": "Inconsistent"}, {"status": "Unclear"}],
        blink_data=[{"ear": 0.3}] * 20,
        head_pose_data=[
            {"timestamp": 0.0, "pose": {"yaw": 0.0, "pitch": 0.0, "roll": 0.0}},
            {"timestamp": 1.0, "pose": {"yaw": 10.0, "pitch": 5.0, "roll": 2.0}},
            {"timestamp": 1.0, "pose": {"yaw": 90.0}},                 # dt = 0: skipped
            {"timestamp": 1.5, "yaw": "7", "pitch": None, "roll": 1.0},  # flat pose, odd types
        ],
        texture_ela_score=0.4,
        claims=[{"claim_text": "a", "evidence_score": 0.8},
                {"claim_text": "b", "evidence_score": 0.0}, "not-a-dict"],
        evidence=[{"reliability_score": 0.9}, {"reliability_score": "0.5"}, {}],
    )


def _feature_fields(case, ddir):
    if case == "rich":
        return _rich_fields(ddir)
    if case == "empty":
        return dict(data_dir=str(ddir))
    if case == "debug_recovery":
        (ddir / "C2_debug.json").write_text(json.dumps({"matched": 3, "inconsistent": 2}))
        (ddir / "V5_debug.json").write_text(json.dumps({"avg_score": 0.77}))
        return dict(data_dir=str(ddir), metadata={"duration": 5.0})
    if case == "debug_recovery_malformed":
        (ddir / "C2_debug.json").write_text(json.dumps({"matched": "x", "inconsistent": None}))
        (ddir / "V5_debug.json").write_text("{not json")
        return dict(data_dir=str(ddir), metadata={"duration": 5.0})
    if case == "state_beats_debug_json":
        (ddir / "C2_debug.json").write_text(json.dumps({"matched": 3, "inconsistent": 2}))
        (ddir / "V5_debug.json").write_text(json.dumps({"avg_score": 0.77}))
        return dict(data_dir=str(ddir), gesture_check=[{"status": "Inconsistent"}],
                    texture_ela_score="0.25", metadata={"duration": 3.0})
    if case == "saturated":
        return dict(data_dir=str(ddir), metadata={"duration": 1.0}, word_count=900,
                    blink_data=[{}] * 500, head_pose_data=[
                        {"timestamp": 0.0, "pose": {"yaw": 0.0}},
                        {"timestamp": 0.01, "pose": {"yaw": 170.0}}])
    assert case == "zero_duration"
    return dict(data_dir=str(ddir), metadata={"duration": 0.0}, word_count=10,
                segments=[{"start": 0.0, "end": 1.0}, {"start": 2.0, "end": 3.0}], blink_data=[{}])


FEATURE_CASES = ["rich", "empty", "debug_recovery", "debug_recovery_malformed",
                 "state_beats_debug_json", "saturated", "zero_duration"]


@pytest.mark.parametrize("case", FEATURE_CASES)
def test_build_features_exactly_equal(case, tmp_path):
    dirs = {k: tmp_path / k for k in ("jax", "torch")}
    for d in dirs.values():
        d.mkdir()
    ref = jlr.build_features(JState(**_feature_fields(case, dirs["jax"])))
    got = tlr.build_features(TState(**_feature_fields(case, dirs["torch"])))
    assert list(got) == list(ref) == list(tfusion.FEATURE_ORDER)
    assert got == ref
    if case == "debug_recovery":
        assert got["gesture_score"] == pytest.approx(3 / (3 + 0.5 * 2))
        assert got["texture"] == pytest.approx(0.77)


def _configs(root):
    """Both packages' configs pointed at ``root``'s weights and features."""
    out = []
    for default_config in (jdefault_config, tdefault_config):
        cfg = default_config()
        out.append(dataclasses.replace(cfg, fusion=dataclasses.replace(
            cfg.fusion, weights_path=str(root / "lr_weights.json"),
            features_dir=str(root / "features"))))
    return out


@pytest.mark.parametrize("label", [1, 0, None, 7])
def test_node_writes_equal_feature_cache_and_weights(label, tmp_path):
    deltas, files = {}, {}
    for i, (name, node, state_cls) in enumerate((("jax", jlr, JState), ("torch", tlr, TState))):
        root = tmp_path / name
        root.mkdir()
        cfg = _configs(root)[i]
        (root / "lr_weights.json").write_text(json.dumps(WEIGHTS))
        (root / "run").mkdir()
        fields = {**_rich_fields(root / "run"), "label": label}
        deltas[name] = node.run(state_cls(**fields), config=cfg)
        files[name] = {p: (root / p).read_text() for p in
                       ("lr_weights.json", "features/demo.mp4.json", "run/LR_debug.json")}
    assert deltas["torch"] == deltas["jax"]
    assert files["torch"] == files["jax"]
    new_w = json.loads(files["torch"]["lr_weights.json"])
    if label in (0, 1):
        err = deltas["torch"]["fake_probability"] - label
        assert new_w["bias"] == pytest.approx(WEIGHTS["bias"] - 0.005 * err)
    else:
        assert new_w == WEIGHTS


def test_missing_weights_file_uses_shipped_pretrained(tmp_cwd):
    """A fresh checkout scores with ``assets/lr_weights_pretrained.json``:
    all-zero features -> sigmoid(pretrained bias)."""
    pre = tlr._pretrained_weights_path()
    assert pre == jlr._pretrained_weights_path() and os.path.exists(pre)
    got = tlr.run(TState(input_path="y.mp4"))
    ref = jlr.run(JState(input_path="y.mp4"))
    assert got == ref
    assert got["fake_probability"] == pytest.approx(1.0 / (1.0 + math.exp(-WEIGHTS["bias"])))
    assert tlr.load_weights(str(tmp_cwd / "elsewhere" / "lr_weights.json")) == jlr.load_weights(pre)


@pytest.mark.parametrize("content", [None, "{broken", "[1, 2]", '{"bias": "x", "lip_sync": 2}'])
def test_custom_weights_path_has_no_fallback(tmp_cwd, content):
    """A non-default weights path has no pretrained fallback; a malformed file
    loads what it can (the reference's tolerant loader)."""
    path = tmp_cwd / "custom_w.json"
    if content is not None:
        path.write_text(content)
    assert tlr.load_weights(str(path)) == jlr.load_weights(str(path))
    cfgs = _configs(tmp_cwd)
    cfgs = [dataclasses.replace(c, fusion=dataclasses.replace(c.fusion, weights_path=str(path)))
            for c in cfgs]
    fields = dict(input_path="y.mp4", lip_sync_score=0.5)
    got = tlr.run(TState(**fields), config=cfgs[1])
    assert got == jlr.run(JState(**fields), config=cfgs[0])
    if content is None:
        assert got["fake_probability"] == 0.5


def test_save_weights_round_trip(tmp_path):
    tlr.save_weights(str(tmp_path / "t.json"), WEIGHTS)
    jlr.save_weights(str(tmp_path / "j.json"), WEIGHTS)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert tlr.load_weights(str(tmp_path / "t.json")) == WEIGHTS


# --- the device half: predict_batch, sgd_epoch, train_until_correct ----------
#: float32 on both sides; only the summation order of the 9-term dot differs
DEVICE_TOL = 1e-6


def _corpus_matrix():
    names = sorted(CORPUS)
    feats = np.stack([tfusion.features_to_vector(CORPUS[n]["features"]) for n in names])
    labels = np.array([1.0 if "fake" in n.lower() else 0.0 for n in names], np.float32)
    expected = np.array([CORPUS[n]["expected_probability"] for n in names])
    return names, feats, labels, expected


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_predict_batch_matches_jax_and_fixture():
    _, feats, _, expected = _corpus_matrix()
    w, b = tfusion.weights_to_vectors(WEIGHTS)
    got = tfusion.predict_batch(_t(feats), _t(w), _t(b)).numpy()
    ref = np.asarray(jfusion.predict_batch(jnp.asarray(feats), jnp.asarray(w), jnp.asarray(b)))
    assert got.dtype == np.float32 and got.shape == (len(feats),)
    np.testing.assert_allclose(got, ref, rtol=0, atol=DEVICE_TOL)
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-5)


def test_sgd_epoch_matches_jax_and_host_replay():
    names, feats, labels, _ = _corpus_matrix()
    w, b = tfusion.weights_to_vectors(WEIGHTS)
    w2, b2, probs = tfusion.sgd_epoch(_t(feats), _t(labels), _t(w), _t(b))
    jw, jb, jprobs = jfusion.sgd_epoch(jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=DEVICE_TOL)
    np.testing.assert_allclose(w2.numpy(), np.asarray(jw), rtol=0, atol=DEVICE_TOL)
    assert abs(float(b2) - float(jb)) <= DEVICE_TOL
    w_host = dict(WEIGHTS)
    for n, y in zip(names, labels):
        w_host, _ = tfusion.sgd_update_host(CORPUS[n]["features"], w_host, int(y))
    w_dev = tfusion.vectors_to_weights(w2.numpy(), b2.numpy())
    for k in tfusion.FEATURE_ORDER:
        assert w_dev[k] == pytest.approx(w_host[k], abs=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_until_correct_matches_jax(seed):
    """Random corpora from bad starting weights: the same updates per video
    and the same weights as the JAX package's while_loop."""
    rng = np.random.RandomState(seed)
    feats = rng.rand(7, 9).astype(np.float32)
    labels = (rng.rand(7) > 0.5).astype(np.float32)
    w = (rng.randn(9) * 0.5).astype(np.float32)
    b = np.float32(rng.randn())
    got = tfusion.train_until_correct(_t(feats), _t(labels), _t(w), _t(b))
    ref = jfusion.train_until_correct(jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(w), jnp.asarray(b))
    assert got[2].dtype == torch.int32
    assert got[2].tolist() == np.asarray(ref[2]).tolist()
    assert any(got[2].tolist())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=DEVICE_TOL)
    assert abs(float(got[1]) - float(ref[1])) <= DEVICE_TOL


def test_train_until_correct_flips_prediction_and_caps():
    feats = _t([[1.0] + [0.0] * 8])
    w2, b2, iters = tfusion.train_until_correct(feats, _t([1.0]), _t(np.zeros(9)), _t(-0.3))
    assert float(tfusion.predict_batch(feats, w2, b2)[0]) > 0.5 and 0 < int(iters[0]) < 100
    # a video no update can flip within the budget stops at max_epochs
    _, _, iters = tfusion.train_until_correct(feats, _t([1.0]), _t(np.zeros(9)), _t(-50.0), max_epochs=5)
    assert iters.tolist() == [5]


#: the full pipeline's vectors on the four HARD_REAL_RECIPES clips (sensor
#: noise 20-26, claimless speech of under four words), as
#: tests/test_lr_fusion.py records them
HARD_REALS = [
    {"speech_rate": 0.06, "pause_ratio": 0.135, "lip_sync": 0.563, "gesture_score": 1.0, "blink_rate": 1.0,
     "headpose_jerk": 0.058, "texture": 0.925, "claim_reliability": 0.0, "evidence_reliability": 0.0},
    {"speech_rate": 0.06, "pause_ratio": 0.127, "lip_sync": 0.719, "gesture_score": 0.889, "blink_rate": 1.0,
     "headpose_jerk": 0.081, "texture": 0.98, "claim_reliability": 0.0, "evidence_reliability": 0.0},
    {"speech_rate": 0.04, "pause_ratio": 0.048, "lip_sync": 0.432, "gesture_score": 0.857, "blink_rate": 1.0,
     "headpose_jerk": 0.073, "texture": 0.98, "claim_reliability": 0.0, "evidence_reliability": 0.0},
    {"speech_rate": 0.06, "pause_ratio": 0.127, "lip_sync": 0.569, "gesture_score": 0.889, "blink_rate": 1.0,
     "headpose_jerk": 0.073, "texture": 0.98, "claim_reliability": 0.0, "evidence_reliability": 0.0},
]


@pytest.mark.parametrize("index", range(len(HARD_REALS)))
def test_hard_real_vectors_misclassify_untrained_but_converge(index):
    """The hard-real contract of ``tests/test_lr_fusion.py`` on the port's
    host math: under the shipped pretrained weights a noisy genuine clip
    scores on the fake side (the eval baseline's false positive), and
    per-attempt retraining crosses the threshold within the reference's
    100-attempt budget, in the same number of attempts as the JAX
    package's."""
    feats = HARD_REALS[index]
    pretrained = tlr.load_weights(tlr._pretrained_weights_path())
    assert tfusion.predict_host(feats, pretrained) > 0.5
    w, jw = dict(pretrained), dict(pretrained)
    for attempt in range(1, 101):
        w, p = tfusion.sgd_update_host(feats, w, 0)
        jw, jp = jfusion.sgd_update_host(feats, jw, 0)
        assert p == jp
        if p <= 0.5:
            break
    assert p <= 0.5, f"did not converge within 100: {feats}"
    assert w == jw
