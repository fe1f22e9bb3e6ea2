"""``fvd_tpu_torch/tools/calibrate_lr.py`` against ``tools/calibrate_lr.py``
on the CPU: the sign-constrained fit and its prediction equal the JAX
tool's, ``--refit-from-meta`` on a copy of the shipped meta reproduces
``assets/lr_weights_calibrated.json`` exactly without touching ``assets/``,
the vector it writes loads alike through both packages' ``load_weights``,
and it passes ``tests/test_calibrated_weights.py``'s checks under the
port's ``predict_host``."""

import hashlib
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from fvd_tpu.nodes import lr_fusion as jlr
from fvd_tpu_torch.nodes import lr_fusion as tlr
from fvd_tpu_torch.ops.fusion import predict_host
from fvd_tpu_torch.tools import calibrate_lr as tcal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAL = os.path.join(REPO, "assets", "lr_weights_calibrated.json")
META = os.path.join(REPO, "assets", "lr_weights_calibrated_meta.json")
#: the shipped meta's validation accuracy (19 of 23 validation clips)
VAL_ACC = 0.8260869565217391


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jcal():
    saved = list(sys.path)
    import tools.calibrate_lr as jcal

    sys.path[:] = saved  # the JAX tool prepends tools/ on import
    return jcal


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def refit(tmp_path_factory):
    """``--refit-from-meta`` on a copy of the shipped meta -> (the vector
    it wrote, the meta it rewrote, its path); ``assets/`` unchanged."""
    before = {p: _digest(p) for p in (CAL, META)}
    out = tmp_path_factory.mktemp("refit") / "cal.json"
    shutil.copy(META, str(out).replace(".json", "_meta.json"))
    assert tcal.main(["--refit-from-meta", "--out", str(out)]) == 0
    assert {p: _digest(p) for p in (CAL, META)} == before
    with open(out) as f, open(str(out).replace(".json", "_meta.json")) as g:
        return json.load(f), json.load(g), str(out)


def test_tables_equal_the_jax_tool(jcal):
    assert tcal.FEATURES == jcal.FEATURES
    assert tcal.SIGN == jcal.SIGN


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_and_predict_equal_jax(jcal, seed):
    rng = np.random.RandomState(seed)
    X = rng.rand(18, len(tcal.FEATURES))
    y = (rng.rand(18) > 0.5).astype(np.float64)
    w, b = tcal.fit_lr(X, y, epochs=500)
    jw, jb = jcal.fit_lr(X, y, epochs=500)
    assert np.array_equal(w, jw) and b == jb
    assert np.array_equal(tcal.predict(X, w, b), jcal.predict(X, jw, jb))


def test_refit_from_meta_reproduces_the_shipped_vector(refit):
    vector, meta, _ = refit
    with open(CAL) as f:
        shipped = json.load(f)
    assert set(vector) == set(shipped) == {"bias", *tcal.FEATURES}
    assert max(abs(vector[k] - shipped[k]) for k in shipped) == 0.0
    assert meta["val_acc"] == VAL_ACC
    assert meta["fit"] == "refit-from-meta, hard reals excluded"


def test_written_vector_loads_alike_in_both_packages(refit):
    _, _, path = refit
    assert tlr.load_weights(path) == jlr.load_weights(path)


# tests/test_calibrated_weights.py's three checks on the port's refit vector
def test_reference_semantics_signs(refit):
    vector, _, _ = refit
    assert vector["texture"] >= 0.0
    assert vector["lip_sync"] <= 0.0
    assert vector["claim_reliability"] <= 0.0
    assert vector["evidence_reliability"] <= 0.0


def _val_probs(vector, meta):
    val = meta["val"]
    return [predict_host(dict(zip(tcal.FEATURES, row)), vector) for row in val["X"]], val["videos"]


def test_classifies_plain_recipes_on_fresh_seeds(refit):
    vector, meta, _ = refit
    probs, names = _val_probs(vector, meta)
    plain_real = [p for p, n in zip(probs, names) if "_real_news" in n]
    plain_fake = [p for p, n in zip(probs, names) if "_deepfake" in n and "subtle" not in n]
    assert plain_real and plain_fake
    assert np.mean([p < 0.5 for p in plain_real]) >= 5 / 6 - 1e-9, plain_real
    assert all(p > 0.5 for p in plain_fake), plain_fake


def test_probe_recipe_classifies(refit):
    vector, meta, _ = refit
    probs, names = _val_probs(vector, meta)
    assert max(p for p, n in zip(probs, names) if "_deepfake" in n and "subtle" not in n) > 0.5
