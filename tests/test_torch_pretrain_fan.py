"""``fvd_tpu_torch/tools/pretrain_fan.py`` and its optimiser against the
JAX package's ``tools/pretrain_fan.py`` on the CPU, the FAN at width 32 and
2 stacks on 64-px crops (``tests/test_torch_fan_pose50.py`` holds the
module's forward and ``PoseResNet50``).

* The optimiser chain: three steps of ``clip_by_global_norm(1.0)`` +
  ``adamw`` on the warmup-cosine schedule in float64 (JAX with x64 on; the
  module's ``jnp.float32`` output cast patched to float64 while it is
  traced) from the port's seeded weights on the same batches.  The first
  loss and gradient within ``F64_RTOL``; the port's clip + AdamW + schedule
  fed JAX's gradient of each step ends at JAX's parameters within
  ``F64_RTOL`` (the first two steps clip: the global norms are 8.4 and
  6.7); end to end within ``F64_END_TO_END``.  The schedule equals optax's,
  and the clipping equals optax's above and below the threshold.
* The tool at 2 steps: its npz loads in JAX's ``lf.load_params``,
  ``--resume`` continues from it, and the paired evaluation of the shipped
  hourglass gives JAX's error on the same samples.
"""

import copy
import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch.nn as nn

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from fvd_tpu.models import landmarks_fan as jlf  # noqa: E402
from fvd_tpu.models import synthetic_faces as jsf  # noqa: E402
from fvd_tpu_torch import weights  # noqa: E402
from fvd_tpu_torch.models import landmarks_fan as lf  # noqa: E402
from fvd_tpu_torch.models import optim  # noqa: E402
from fvd_tpu_torch.tools import pretrain_fan  # noqa: E402
from test_torch_train_losses import _nest, one_torch_thread, rel_l2  # noqa: E402,F401

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
WIDTH, STACKS, CROP = 32, 2, 64
F64_RTOL = 1e-12
#: a tensor's gradient against its own norm: the hourglass' 1x1 bottom has
#: gradients 1e-9 of the whole, computed with cancellation (measured 2.1e-11)
F64_TENSOR_RTOL = 1e-9
#: three steps end to end, where Adam magnifies rounding (see
#: ``test_f64_three_steps_end_to_end``; measured 4e-14, 2.7e-10 and 3.3e-10)
F64_END_TO_END = {"losses": 1e-12, "grads": F64_TENSOR_RTOL, "params": F64_TENSOR_RTOL}
STEPS, WARMUP, LR = 3, 2, 1e-2
ZERO_GRAD_RTOL = 1e-12
#: optax's float32 schedule against the float64 one (measured 9.3e-7)
SCHEDULE_F32_RTOL = 2e-6


def _crops(seed=0, n=2):
    return jsf.landmark_batch(np.random.RandomState(seed), n, crop=CROP, augment=True, hard_half=True)


# ------------------------------------------------------------ the optimiser
def _jax_loss(net, p, crops, targets):
    """``tools/pretrain_fan.py``'s ``loss_fn`` (lines 87-89)."""
    coords = jlf.decode_heatmaps(net.apply(p, crops))
    return jnp.mean(jnp.sum((coords - targets) ** 2, axis=-1))


def _jax_schedule(lr, warmup, steps):
    return optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1), end_value=lr * 0.05)


def _jax_chain(lr, warmup, steps):
    """``tools/pretrain_fan.py``'s ``tx`` (lines 78-85), its schedule read at
    a float64 count: optax reads it at its int32 count in float32, 1e-6 of
    the float64 value (``test_schedule_matches_optax``), which would hide
    the rest of the chain's agreement."""
    sched = _jax_schedule(lr, warmup, steps)
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        lambda count: sched(jnp.asarray(count, jnp.float64)), weight_decay=1e-4))


def _f64_run():
    """Three steps of the chain from the port's seeded weights on the same
    batches: JAX's, the port's end to end, and the port's optimiser fed
    JAX's gradients of each step."""
    batches = [tuple(x.astype(np.float64) for x in _crops(seed)) for seed in range(STEPS)]
    seeded = weights.seeded(lf.FANLandmarkNet(WIDTH, STACKS), 0).to(torch.float64)
    net = jlf.FANLandmarkNet(width=WIDTH, n_stacks=STACKS, dtype=jnp.float64)
    tx = _jax_chain(LR, WARMUP, STEPS)
    clip = optax.clip_by_global_norm(1.0)

    @jax.jit
    def jstep(params, opt_state, crops, targets):
        loss, grads = jax.value_and_grad(functools.partial(_jax_loss, net))(params, crops, targets)
        clipped, _ = clip.update(grads, clip.init(params))
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads, clipped, optax.global_norm(grads)

    params = _nest({k: jnp.asarray(v) for k, v in weights.from_state_dict(seeded, dtype=torch.float64).items()})
    opt_state = tx.init(params)
    jout = {k: [] for k in ("losses", "grads", "clipped", "norms")}
    for b in batches:
        params, opt_state, loss, g, gc, norm = jstep(params, opt_state, *(jnp.asarray(x) for x in b))
        jout["losses"].append(float(loss))
        jout["grads"].append(weights.flatten(jax.tree.map(np.asarray, g)))
        jout["clipped"].append(weights.flatten(jax.tree.map(np.asarray, gc)))
        jout["norms"].append(float(norm))
    jout["params"] = weights.flatten(jax.tree.map(np.asarray, params))

    model = copy.deepcopy(seeded)
    opt, sched = optim.adamw_warmup_cosine(model, LR, WARMUP, STEPS)
    pout = {"losses": [], "clipped": []}
    for b in batches:
        loss = optim.clipped_adamw_step(pretrain_fan.fan_loss, model, opt, sched,
                                        *(torch.from_numpy(x) for x in b))
        pout["losses"].append(float(loss))
        pout["clipped"].append(weights.from_state_dict({k: p.grad for k, p in model.named_parameters()},
                                                       dtype=torch.float64))
    pout["params"] = weights.from_state_dict(model, dtype=torch.float64)
    model = copy.deepcopy(seeded)
    loss = pretrain_fan.fan_loss(model, *(torch.from_numpy(x) for x in batches[0]))
    loss.backward()
    pout["loss0"] = float(loss.detach())
    pout["grad0"] = weights.from_state_dict({k: p.grad for k, p in model.named_parameters()}, dtype=torch.float64)

    model = copy.deepcopy(seeded)
    opt, sched = optim.adamw_warmup_cosine(model, LR, WARMUP, STEPS)
    for g in jout["grads"]:
        for name, value in weights.to_state_dict(g, dtype=torch.float64).items():
            model.get_parameter(name).grad = value
        optim.clip_by_global_norm_(model.parameters(), 1.0)
        opt.step()
        sched.step()
    pout["params_on_jax_grads"] = weights.from_state_dict(model, dtype=torch.float64)
    return jout, pout


@pytest.fixture(scope="module")
def f64_run():
    jax.config.update("jax_enable_x64", True)
    patch = pytest.MonkeyPatch()
    try:
        # the module casts its heatmaps to jnp.float32 when it is traced
        patch.setattr(jnp, "float32", jnp.float64)
        return _f64_run()
    finally:
        patch.undo()
        jax.config.update("jax_enable_x64", False)


def _zero_grads(grads):
    """The tensors whose gradient is zero in exact arithmetic, as JAX's
    first gradient shows them (under ``ZERO_GRAD_RTOL`` of the whole): the
    last heatmap bias, and the conv biases ahead of a GroupNorm of one
    channel per group (the 8-channel 3x3s of the width-32 bottlenecks)."""
    total = np.sqrt(sum(float(np.sum(g ** 2)) for g in grads.values()))
    return {k for k, g in grads.items() if np.linalg.norm(g) <= ZERO_GRAD_RTOL * total}


def test_f64_loss_and_gradient_match_jax(f64_run):
    jout, pout = f64_run
    np.testing.assert_allclose(pout["loss0"], jout["losses"][0], rtol=F64_RTOL)
    zero = _zero_grads(jout["grads"][0])
    assert "['params']['Conv_6']['bias']" in zero and len(zero) == 7, sorted(zero)
    total = np.sqrt(sum(float(np.sum(g ** 2)) for g in jout["grads"][0].values()))
    for key, ref in jout["grads"][0].items():
        if key in zero:
            assert np.linalg.norm(pout["grad0"][key]) <= ZERO_GRAD_RTOL * total, key
        else:  # within 1e-12 of the whole gradient, and 1e-9 of its own
            assert np.linalg.norm(pout["grad0"][key] - ref) <= F64_RTOL * total, key
            assert rel_l2(pout["grad0"][key], ref) <= F64_TENSOR_RTOL, ("grad", key, rel_l2(pout["grad0"][key], ref))


def test_f64_optimiser_chain_matches_optax_on_the_same_gradients(f64_run):
    """JAX's gradient of each step through the port's clip + AdamW +
    schedule leaves JAX's parameters; the first two steps clip."""
    jout, pout = f64_run
    assert jout["norms"][0] > 1.0 and jout["norms"][1] > 1.0, jout["norms"]
    for key, ref in jout["params"].items():
        assert rel_l2(pout["params_on_jax_grads"][key], ref) <= F64_RTOL, ("param", key)


def test_f64_three_steps_end_to_end(f64_run):
    """The port's three steps on its own gradients.  Adam divides each
    gradient by its own root mean square, so a gradient that rounding moves
    by a relative 1e-11 moves its update by as much whatever its size: the
    exactly-zero gradients (``_zero_grads``) take steps of ~lr from rounding
    noise on either side (left out), and the tiny ones at the hourglass' 1x1
    bottom carry their 1e-11 into the parameters.  Losses within 1e-12,
    clipped gradients and parameters within 1e-9 per tensor."""
    jout, pout = f64_run
    zero = _zero_grads(jout["grads"][0])
    np.testing.assert_allclose(pout["losses"], jout["losses"], rtol=F64_END_TO_END["losses"])
    for jg, pg in zip(jout["clipped"], pout["clipped"]):
        for key in jg:
            if key not in zero:
                assert rel_l2(pg[key], jg[key]) <= F64_END_TO_END["grads"], ("grad", key)
    for key, ref in jout["params"].items():
        if key not in zero:
            assert rel_l2(pout["params"][key], ref) <= F64_END_TO_END["params"], ("param", key)


@pytest.mark.parametrize("lr,warmup,steps", [(3e-4, 200, 3000), (LR, WARMUP, STEPS), (1e-3, 0, 10), (1e-3, 50, 20)])
def test_schedule_matches_optax(lr, warmup, steps):
    """The lr of each update: equal to optax's schedule in float64 (x64 on,
    the count a Python int), and within ``SCHEDULE_F32_RTOL`` of it as the
    JAX tool reads it, at an int32 count in float32."""
    counts = range(max(steps, warmup + 1) + 3)
    jax.config.update("jax_enable_x64", True)
    try:
        ref = [float(_jax_schedule(lr, warmup, steps)(c)) for c in counts]
    finally:
        jax.config.update("jax_enable_x64", False)
    tool = jax.jit(_jax_schedule(lr, warmup, steps))
    ref32 = [float(tool(jnp.asarray(c, jnp.int32))) for c in counts]
    model = nn.Linear(2, 2)
    opt, lr_sched = optim.adamw_warmup_cosine(model, lr, warmup, steps)
    got = []
    for _ in counts:  # the lr each update would use, as the optimiser reads it
        got.append(opt.param_groups[0]["lr"])
        opt.step()
        lr_sched.step()
    np.testing.assert_allclose(got, ref, rtol=1e-15, atol=0)
    np.testing.assert_allclose(got, ref32, rtol=SCHEDULE_F32_RTOL, atol=0)


@pytest.mark.parametrize("scale", [0.1, 0.999, 1.0, 3.0])
def test_clipping_matches_optax(scale):
    rng = np.random.RandomState(0)
    grads = [rng.randn(3, 4), rng.randn(5)]
    norm = np.sqrt(sum(np.sum(g ** 2) for g in grads))
    grads = [g * scale / norm for g in grads]
    jax.config.update("jax_enable_x64", True)
    try:
        clip = optax.clip_by_global_norm(1.0)
        ref, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(grads))
        ref = [np.asarray(r) for r in ref]
    finally:
        jax.config.update("jax_enable_x64", False)
    params = [nn.Parameter(torch.zeros(g.shape, dtype=torch.float64)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    optim.clip_by_global_norm_(params, 1.0)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-15, atol=0)


# ------------------------------------------------------------------ the tool
@pytest.fixture(scope="module")
def tool_run(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("fan")
    shutil.copy(os.path.join(CKPT, "landmarks.npz"), out_dir / "landmarks.npz")
    out = str(out_dir / "fan_landmarks.npz")
    argv = ["--cpu", "--steps", "2", "--width", str(WIDTH), "--stacks", str(STACKS), "--batch", "2", "--out", out]
    first = pretrain_fan.main(argv)
    with open(out.replace(".npz", ".json")) as f:
        sidecar = json.load(f)
    trained = weights.read_npz(out)
    resumed = pretrain_fan.main(argv + ["--resume", "--steps", "1"])
    return out, first, sidecar, trained, resumed


def test_tool_summary_and_sidecar(tool_run):
    _, first, sidecar, _, _ = tool_run
    assert first["steps"] == 2 and np.isfinite([first["loss_first"], first["loss_last"], first["crops_per_s"]]).all()
    assert {k: sidecar[k] for k in ("arch", "width", "n_stacks", "train", "steps")} == \
        {"arch": "fan", "width": WIDTH, "n_stacks": STACKS, "train": "pretrain_fan.py", "steps": 2}
    assert sidecar["paired_eval_pct_crop"] == first["paired_eval_pct_crop"]
    for split in ("clean", "hard"):
        assert set(sidecar["paired_eval_pct_crop"][split]) == {"fan", "shipped_128px"}
        assert all(np.isfinite(v) for v in sidecar["paired_eval_pct_crop"][split].values())


def test_tool_npz_loads_in_jax_and_resume_continues(tool_run):
    out, _, _, trained, resumed = tool_run
    template = jax.eval_shape(lambda: jlf.init_fan_params(jax.random.PRNGKey(0), width=WIDTH, n_stacks=STACKS))
    params = jlf.load_params(out, template)
    assert jax.tree.structure(params) == jax.tree.structure(template)
    model = lf.FANLandmarkNet(WIDTH, STACKS)
    model.load_state_dict(weights.to_state_dict(trained), strict=True)
    # --resume started from the first run's weights: one step at the schedule's
    # count 0 (lr 0) leaves them unchanged
    np.testing.assert_array_equal(weights.read_npz(out)["['params']['Conv_0']['kernel']"],
                                  trained["['params']['Conv_0']['kernel']"])
    assert resumed["steps"] == 1


def test_tool_paired_eval_of_the_shipped_hourglass_matches_jax(tool_run):
    """The shipped hourglass's error on the clean evaluation samples, as the
    JAX tool computes it (``cv2.resize`` to 128, ``landmarks_forward`` in
    bfloat16) on the JAX package's samples."""
    import cv2

    _, first, _, _, _ = tool_run
    crops, targets = jsf.landmark_batch(np.random.RandomState(10_000), 64, crop=jlf.FAN_CROP_SIZE)
    small = np.stack([cv2.resize(c, (jlf.CROP_SIZE, jlf.CROP_SIZE)) for c in crops])
    template = jlf.init_landmark_params(jax.random.PRNGKey(1), width=32)
    ship = jlf.load_params(os.path.join(CKPT, "landmarks.npz"), template)
    coords = np.asarray(jlf.landmarks_forward(ship, jnp.asarray((small * 255).astype(np.uint8)), width=32))
    ref = 100 * float(np.mean(np.linalg.norm(coords - targets, axis=-1)))
    # bfloat16 backbones on both sides: 64 samples' mean moves by ~1e-3 %
    assert abs(first["paired_eval_pct_crop"]["clean"]["shipped_128px"] - ref) <= 0.05
