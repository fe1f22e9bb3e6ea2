"""``fvd_tpu_torch/tools/pretrain_clip.py`` against ``tools/pretrain_clip.py``
on the CPU, at dim 32 and depth 1.

* ``make_pair`` and ``clip_batch``: the same captions, token ids, images
  and RNG state for the same ``RandomState``.
* Float64 (JAX with x64 on): three Adam steps of ``clip_loss`` on
  JAX-drawn batches from the port's seeded weights give the same losses,
  first-step gradients and final parameters within ``F64_RTOL`` relative L2
  per tensor (the key projections' biases have an exactly zero gradient,
  held to zero on both sides, as ``tests/test_torch_zoo_train.py`` does).
* The sidecar's calibration, ``cal_offset`` and ``cal_scale``, within
  ``CAL_TOL`` (relative) of the JAX tool's formula on the same batch and
  weights, and the tool's npz and sidecar loading in the JAX package.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from fvd_tpu.models import encoders as jenc  # noqa: E402
from fvd_tpu.models.transformer import ByteTokenizer as JByteTokenizer  # noqa: E402
from fvd_tpu_torch import weights  # noqa: E402
from fvd_tpu_torch.models import encoders  # noqa: E402
from fvd_tpu_torch.models.layers import adam, adam_step  # noqa: E402
from fvd_tpu_torch.models.transformer import ByteTokenizer  # noqa: E402
from fvd_tpu_torch.tools import pretrain_clip  # noqa: E402
from test_torch_train_losses import _nest, one_torch_thread, rel_l2  # noqa: E402,F401

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)
try:
    import pretrain_clip as jclip  # noqa: E402
finally:
    sys.path.remove(TOOLS)

F64_RTOL = 1e-9
ZERO_GRAD_RTOL, ZERO_PARAM_ATOL = 1e-12, 1e-9
#: float32 on both sides: the towers' summation order only
CAL_TOL = 1e-6
DIM, DEPTH = 32, 1
LR = 3e-4
STEPS = 3


def same_state(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a.get_state(), b.get_state()))


@pytest.mark.parametrize("seed", range(4))
def test_clip_batch_matches_jax(seed):
    """Every kind of pair (text, face, texture) and the redraw of a repeated
    caption come in the JAX package's order."""
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):
        ij, idj, cj = jclip.clip_batch(rj, 12, JByteTokenizer(), jenc.MAX_TEXT_LEN)
        ip, idp, cp = pretrain_clip.clip_batch(rp, 12, ByteTokenizer(), encoders.MAX_TEXT_LEN)
        assert cp == cj and len(set(cp)) == 12
        np.testing.assert_array_equal(idp, idj)
        np.testing.assert_array_equal(ip, ij)
        assert same_state(rp, rj)
    assert {c.split(" ")[0] for c in cp} <= {"text", "a", "an"}


def test_make_pair_every_kind_matches_jax():
    kinds = set()
    for seed in range(12):
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        (ij, cj), (ip, cp) = jclip.make_pair(rj), pretrain_clip.make_pair(rp)
        assert cp == cj and same_state(rp, rj)
        np.testing.assert_array_equal(ip, ij)
        kinds.add(cp.split(" ")[0])
    assert kinds == {"text", "a", "an"}


def _batches():
    tok = JByteTokenizer()
    return [jclip.clip_batch(np.random.RandomState(10 + s), 6, tok, 24)[:2] for s in range(STEPS)]


@pytest.fixture(scope="module")
def f64_run():
    jax.config.update("jax_enable_x64", True)
    try:
        model = weights.seeded(encoders.ClipModel(DIM, DEPTH, DIM), 0).to(torch.float64)
        jmodel = jenc.ClipModel(dim=DIM, depth=DEPTH, out_dim=DIM)
        batches = [(im.astype(np.float64), ids) for im, ids in _batches()]
        tx = optax.adam(LR)

        @jax.jit
        def jstep(params, opt_state, images, ids):
            loss, grads = jax.value_and_grad(jenc.clip_loss)(params, jmodel, images, ids)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss, grads

        params = _nest({k: jnp.asarray(v) for k, v in weights.from_state_dict(model, dtype=torch.float64).items()})
        opt_state, jl, jg = tx.init(params), [], None
        for im, ids in batches:
            params, opt_state, loss, g = jstep(params, opt_state, jnp.asarray(im), jnp.asarray(ids))
            jl.append(float(loss))
            jg = jg or weights.flatten(jax.tree.map(np.asarray, g))
        jp = weights.flatten(jax.tree.map(np.asarray, params))

        model, opt, pl, pg = copy.deepcopy(model), None, [], None
        opt = adam(model, LR)
        for im, ids in batches:
            pl.append(float(adam_step(encoders.clip_loss, model, opt, torch.from_numpy(im),
                                      torch.from_numpy(ids).long())))
            pg = pg or weights.from_state_dict({k: p.grad for k, p in model.named_parameters()},
                                               dtype=torch.float64, model=model)
        return (jl, jg, jp), (pl, pg, weights.from_state_dict(model, dtype=torch.float64))
    finally:
        jax.config.update("jax_enable_x64", False)


def test_f64_three_adam_steps_match_optax(f64_run):
    (jl, jg, jp), (pl, pg, pp) = f64_run
    np.testing.assert_allclose(pl, jl, rtol=F64_RTOL)
    assert set(pg) == set(jg) and set(pp) == set(jp)
    total = np.sqrt(sum(float(np.sum(g ** 2)) for g in jg.values()))
    for key in jg:
        if key.endswith("['key']['bias']"):
            for g, p in ((jg[key], jp[key]), (pg[key], pp[key])):
                assert np.linalg.norm(g) <= ZERO_GRAD_RTOL * total and np.abs(p).max() <= ZERO_PARAM_ATOL, key
            continue
        assert rel_l2(pg[key], jg[key]) <= F64_RTOL, ("grad", key, rel_l2(pg[key], jg[key]))
        assert rel_l2(pp[key], jp[key]) <= F64_RTOL, ("param", key, rel_l2(pp[key], jp[key]))


def _jax_calibration(params, model, images, ids):
    """``tools/pretrain_clip.py``'s calibration (lines 133-145)."""
    ie = model.apply(params, jnp.asarray(images), method=jenc.ClipModel.encode_image)
    te = model.apply(params, jnp.asarray(ids), method=jenc.ClipModel.encode_text)
    cos = np.asarray(ie @ te.T)
    d = np.diag(cos)
    o = (cos.sum(1) - d) / (cos.shape[1] - 1)
    return float(o.mean()), float(0.35 / max(d.mean() - o.mean(), 1e-6))


def test_tool_calibration_and_checkpoint_match_jax(tmp_path):
    out = str(tmp_path / "clip.npz")
    summary = pretrain_clip.main(["--steps", "3", "--batch", "6", "--dim", str(DIM), "--depth", str(DEPTH),
                                  "--out", out, "--cpu"])
    assert summary["steps"] == 3 and np.isfinite([summary["loss_first"], summary["loss_last"]]).all()
    with open(out.replace(".npz", ".json")) as f:
        meta = json.load(f)
    assert {k: meta[k] for k in ("dim", "depth", "out_dim")} == {"dim": DIM, "depth": DEPTH, "out_dim": DIM}
    # the tool's eval batch: the batches after three training batches of seed 0
    rng, tok = np.random.RandomState(0), JByteTokenizer()
    for _ in range(3):
        jclip.clip_batch(rng, 6, tok, jenc.MAX_TEXT_LEN)
    images, ids, _ = jclip.clip_batch(rng, 32, tok, jenc.MAX_TEXT_LEN)
    jmodel = jenc.ClipModel(dim=DIM, depth=DEPTH, out_dim=DIM)
    template = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 112, 112, 3)),
                                                  jnp.zeros((1, jenc.MAX_TEXT_LEN), jnp.int32)))
    params = jenc.load_params(out, template)
    cal_offset, cal_scale = _jax_calibration(params, jmodel, images, ids)
    np.testing.assert_allclose([meta["cal_offset"], meta["cal_scale"]], [cal_offset, cal_scale], rtol=CAL_TOL)
    assert meta["cal_offset"] == summary["eval_cal_offset"] and meta["cal_scale"] == summary["eval_cal_scale"]
