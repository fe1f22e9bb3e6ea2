"""``fvd_tpu_torch/tools/pretrain_ocr.py`` against ``tools/pretrain_ocr.py``
on the CPU, at small widths (the recognizer and both detectors at width 8).

* Float64 (JAX with x64 on): from the port's seeded weights and the same
  JAX-drawn batches, three Adam steps of the recognizer's ``ctc_loss`` and
  of each detector's BCE (the JAX tool's inline loss, copied below) give
  the same losses, first-step gradients and final parameters within
  ``F64_RTOL`` relative L2 per tensor.  The v2 detector computes in
  bfloat16 in both packages and returns float32 logits; for this check both
  compute in float64 (the port's ``compute_dtype``, and the JAX module's
  ``jnp.bfloat16`` and ``jnp.float32`` patched to float64 while it is
  traced).
* The v2 detector trains at bfloat16 (a mirror of
  ``tests/test_ocr_v2_and_fan_scale.py::test_v2_detector_trains``).
* The tool at a few steps: its ``ocr_rec.npz``, ``ocr_det.npz`` and sidecar
  load in the JAX package (``encoders.load_params``, ``ocr.load_detector``)
  and give the port's outputs within ``LOAD_TOL``.
"""

import copy
import functools
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from fvd_tpu.models import encoders as jenc  # noqa: E402
from fvd_tpu.models import ocr as jocr  # noqa: E402
from fvd_tpu.models import synthetic_text as jst  # noqa: E402
from fvd_tpu_torch import weights  # noqa: E402
from fvd_tpu_torch.models import ocr  # noqa: E402
from fvd_tpu_torch.models.layers import adam, adam_step  # noqa: E402
from fvd_tpu_torch.tools import pretrain_ocr  # noqa: E402
from test_torch_train_losses import _nest, one_torch_thread, rel_l2  # noqa: E402,F401

F64_RTOL = 1e-9
STEPS = 3
WIDTH = 8
LR = 1e-3
#: the tool's checkpoints in the JAX package against the port, float32
#: (probabilities for the detector, logits for the recognizer)
LOAD_TOL = 1e-5


def jax_det_loss(params, model, imgs, masks):
    """``tools/pretrain_ocr.py``'s detector ``loss_fn`` (lines 95-98)."""
    logits = model.apply(params, imgs)
    bce = jnp.maximum(logits, 0) - logits * masks + jnp.log1p(jnp.exp(-jnp.abs(logits)))
    return jnp.mean(bce)


def _batches(name):
    """Three JAX-drawn batches of ``name`` (float64 images), from seeds 0-2."""
    out = []
    for s in range(STEPS):
        rng = np.random.RandomState(s)
        if name == "rec":
            lines, labels, _ = jst.recognizer_batch(rng, 4, augment=s == 1)
            out.append((lines.astype(np.float64), labels))
        else:
            imgs, masks = jst.detector_batch(rng, 2, augment=s == 1)
            out.append((imgs.astype(np.float64), masks.astype(np.float64)))
    return out


def _models(name):
    """-> (port model in float64, JAX module, JAX loss, port loss)."""
    if name == "rec":
        return (weights.seeded(ocr.CTCRecognizer(WIDTH), 0), jocr.CTCRecognizer(width=WIDTH), jocr.ctc_loss,
                ocr.ctc_loss)
    arch = name[-2:]
    kw = {"compute_dtype": torch.float64} if arch == "v2" else {}
    return (weights.seeded(ocr.DET_ARCHS[arch](WIDTH, **kw), 1), jocr.DET_ARCHS[arch](width=WIDTH), jax_det_loss,
            ocr.detector_loss)


def run_both(name):
    model, jmodel, jloss, ploss = _models(name)
    model = copy.deepcopy(model).to(torch.float64)
    batches = _batches(name)
    tx = optax.adam(LR)

    @jax.jit
    def jstep(params, opt_state, *b):
        loss, grads = jax.value_and_grad(jloss)(params, jmodel, *b)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    params = _nest({k: jnp.asarray(v) for k, v in weights.from_state_dict(model, dtype=torch.float64).items()})
    opt_state, losses, grads = tx.init(params), [], None
    for b in batches:
        params, opt_state, loss, g = jstep(params, opt_state, *(jnp.asarray(x) for x in b))
        losses.append(float(loss))
        grads = grads or weights.flatten(jax.tree.map(np.asarray, g))
    out = {"jax": (losses, grads, weights.flatten(jax.tree.map(np.asarray, params)))}

    opt, losses, grads = adam(model, LR), [], None
    for b in batches:
        args = [torch.from_numpy(np.asarray(x)).to(torch.float64 if np.asarray(x).dtype.kind == "f" else torch.long)
                for x in b]
        losses.append(float(adam_step(ploss, model, opt, *args)))
        grads = grads or weights.from_state_dict({k: p.grad for k, p in model.named_parameters()},
                                                 dtype=torch.float64)
    out["port"] = (losses, grads, weights.from_state_dict(model, dtype=torch.float64))
    return out


CASES = ("rec", "det_v1", "det_v2")


@pytest.fixture(scope="module")
def f64_runs():
    jax.config.update("jax_enable_x64", True)
    patch = pytest.MonkeyPatch()
    try:
        out = {name: run_both(name) for name in CASES[:2]}
        # the v2 module reads jnp.bfloat16 (its convs) and jnp.float32 (its
        # logits) when it is traced
        patch.setattr(jnp, "bfloat16", jnp.float64)
        patch.setattr(jnp, "float32", jnp.float64)
        out["det_v2"] = run_both("det_v2")
        return out
    finally:
        patch.undo()
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("name", CASES)
def test_f64_losses_gradients_and_params_after_three_adam_steps_match_optax(f64_runs, name):
    (jl, jg, jp), (pl, pg, pp) = f64_runs[name]["jax"], f64_runs[name]["port"]
    np.testing.assert_allclose(pl, jl, rtol=F64_RTOL)
    assert set(pg) == set(jg) and set(pp) == set(jp)
    for key in jg:
        assert rel_l2(pg[key], jg[key]) <= F64_RTOL, ("grad", key, rel_l2(pg[key], jg[key]))
        assert rel_l2(pp[key], jp[key]) <= F64_RTOL, ("param", key, rel_l2(pp[key], jp[key]))
    assert pl[-1] < pl[0]


def test_v2_detector_trains():
    """A few BCE steps on a fixed target reduce the loss, in bfloat16: the
    float32 parameters get the gradients through the cast."""
    rng = np.random.RandomState(1)
    model = weights.seeded(ocr.TextRegionNetV2(width=32), 1)
    imgs = torch.from_numpy(rng.rand(2, ocr.DET_SIZE, ocr.DET_SIZE, 3).astype(np.float32))
    masks = torch.from_numpy((rng.rand(2, ocr.DET_SIZE, ocr.DET_SIZE) > 0.8).astype(np.float32))
    opt = adam(model, 1e-3)
    losses = [float(adam_step(ocr.detector_loss, model, opt, imgs, masks)) for _ in range(5)]
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 and p.grad is not None for p in model.parameters())


@pytest.fixture(scope="module")
def tool_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("ocr")
    summaries = {}
    for arch, width in (("v1", 8), ("v2", 16)):
        d = str(out / arch)
        summaries[arch] = pretrain_ocr.main(["--steps", "3", "--det-steps", "2", "--batch", "2", "--rec-width", "32",
                                             "--det-arch", arch, "--det-width", str(width), "--out-dir", d,
                                             "--cpu"] + (["--only", "det"] if arch == "v2" else []))
    return str(out), summaries


def test_tool_summaries(tool_run):
    _, s = tool_run
    assert s["v1"]["rec"]["steps"] == 3 and s["v1"]["det"]["steps"] == 2
    assert s["v2"]["det"]["arch"] == "v2" and s["v2"]["det"]["width"] == 16
    for row in (s["v1"]["rec"], s["v1"]["det"], s["v2"]["det"]):
        assert np.isfinite([row["loss_first"], row["loss_last"], row["data_ms"], row["step_ms"]]).all()
    assert 0.0 <= s["v1"]["rec"]["eval_exact"] <= 1.0 and 0.0 <= s["v1"]["det"]["eval_mask_iou"] <= 1.0


def test_tool_checkpoints_load_in_jax(tool_run, monkeypatch):
    out, _ = tool_run
    # load_detector reads the params into its init's tree: the tree's shapes
    # are enough (the eager init takes ~10 s a detector)
    init = jocr.init_detector
    monkeypatch.setattr(jocr, "init_detector", lambda rng, width=16, arch="v1": jax.eval_shape(
        functools.partial(init, width=width, arch=arch), rng))
    rng = np.random.RandomState(3)
    imgs, _ = jst.detector_batch(rng, 2)
    lines, _, _ = jst.recognizer_batch(rng, 3)
    # the recognizer: width 32, no sidecar, as the JAX tool writes it
    rec_path = os.path.join(out, "v1", "ocr_rec.npz")
    # the template's tree only (its eager init takes seconds)
    template = jax.eval_shape(lambda: jocr.init_recognizer(jax.random.PRNGKey(0), width=32))
    jparams = jenc.load_params(rec_path, template)
    want = np.asarray(jocr.recognize_forward(jparams, jnp.asarray(lines), width=32))
    got = ocr.recognize_forward(ocr.load_recognizer(rec_path, 32, "cpu"), torch.from_numpy(lines)).numpy()
    np.testing.assert_allclose(got, want, atol=LOAD_TOL, rtol=0)
    for arch, width in (("v1", 8), ("v2", 16)):
        path = os.path.join(out, arch, "ocr_det.npz")
        with open(path.replace(".npz", ".json")) as f:
            assert json.load(f) == {"arch": arch, "width": width}
        params, jw, ja = jocr.load_detector(path)
        assert (jw, ja) == (width, arch)
        x = imgs if arch == "v1" else imgs[:1]  # XLA's CPU bfloat16 convs are slow
        want = np.asarray(jocr.detect_forward(params, jnp.asarray(x), width=jw, arch=ja))
        model, pw, pa = ocr.load_detector(path, "cpu")
        assert (pw, pa) == (width, arch)
        got = ocr.detect_forward(model, torch.from_numpy(x)).numpy()
        if arch == "v1":
            np.testing.assert_allclose(got, want, atol=LOAD_TOL, rtol=0)
        else:  # bfloat16 on both sides: the masks, as tests/test_torch_ocr.py holds them
            assert ((got > 0.5) == (want > 0.5)).mean() >= 0.999
