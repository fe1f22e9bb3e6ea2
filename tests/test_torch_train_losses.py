"""The port's training half against the JAX package's on the CPU: ``ssd_loss``
and ``landmark_loss``, their gradients, and three Adam steps of
``make_train_step`` and ``make_landmark_train_step``, from the same params on
the same batches of the JAX package's generators.  The params are the port's
seeded initialisation, carried to JAX as a flax tree by
``weights.from_state_dict`` (a JAX-side flax init costs seconds of compile
per model; ``tests/test_torch_train_tool.py`` holds the pose steps).

In float32 the loss on the first batch agrees within ``F32_LOSS_RTOL``; the
losses of later Adam steps drift apart after Adam's first update (below).
The losses of all steps, per-tensor gradients and parameters are held in
float64 (JAX with x64 on,
the port's modules in double), within ``F64_RTOL`` relative L2: in float32
a tensor whose gradient is a small difference of large terms (a GroupNorm
bias, the consistency term's A-B divergence) disagrees in the third decimal
from summation order alone (``chip_smoke.py``'s train phase prints the worst
tensor, card against CPU), and Adam's first updates are about +-lr wherever
|g| >> eps, so a gradient within rounding of 0 moves a parameter either way.
The bias of the hourglass's heatmap conv has an exactly zero gradient (the
spatial soft-argmax ignores a per-map constant); it is held to zero on both
sides instead.  The float64 SSD batch 0 holds a flat frame, whose interior
anchors tie: hard-negative mining must break the ties as JAX's stable
argsort does.  (In float32 a flat frame is ill-conditioned: GroupNorm
divides rounding noise by the near-zero spread of a constant map.)
"""

import copy
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fvd_tpu.models import face_ssd as jssd  # noqa: E402
from fvd_tpu.models import landmarks_fan as jlf  # noqa: E402
from fvd_tpu.models import synthetic_faces as jsf  # noqa: E402
from fvd_tpu_torch import weights  # noqa: E402
from fvd_tpu_torch.models import face_ssd, landmarks_fan  # noqa: E402

#: the first step's float32 loss; the hourglass's soft-argmax at temperature
#: 10 magnifies float32 rounding in the heatmaps (measured 1.02e-5 between the
#: two packages at width 16, where float64 agrees within 1e-15)
F32_LOSS_RTOL = {"ssd": 1e-5, "lmk": 2e-5}
F64_RTOL = 1e-9
#: the gradient of the heatmap conv's bias, relative to the whole gradient
ZERO_GRAD_RTOL = 1e-12
#: parameters with an exactly zero gradient (see the module docstring)
ZERO_GRAD = {"lmk": ("['params']['Conv_1']['bias']",)}
SSD_WIDTH, LMK_WIDTH = 8, 16
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: the suite runs six workers on the
    machine's cores, and under that load torch's default of one spinning
    thread per core made ``test_ssd_loss_decreases`` take 27 s (well under
    a second alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nest(flat):
    """Flat ``"['params'][...]"`` keys -> the nested flax tree."""
    tree = {}
    for key, value in flat.items():
        *path, leaf = weights._KEY_PART.findall(key)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _batches(double: bool):
    ssd = [list(jsf.detector_batch(np.random.RandomState(s), 2)[:3]) for s in range(STEPS)]
    if double:
        ssd[0][0][0] = 60.0  # a flat frame: its interior anchors' logits tie
    return {"ssd": ssd, "lmk": [jsf.landmark_batch(np.random.RandomState(s), 2) for s in range(STEPS)]}


def _cases():
    """name -> (port model, JAX (step, init_opt), port (step, init_opt))."""
    ssd = weights.seeded(face_ssd.FaceSSD(SSD_WIDTH), 0)
    lmk = weights.seeded(landmarks_fan.LandmarkHourglass(LMK_WIDTH), 1)
    return {"ssd": (ssd, jssd.make_train_step(width=SSD_WIDTH), face_ssd.make_train_step()),
            "lmk": (lmk, jlf.make_landmark_train_step(width=LMK_WIDTH), landmarks_fan.make_landmark_train_step())}


def run_both(model, jax_step, port_step, batches, double: bool):
    """Both packages' steps over ``batches`` from ``model``'s weights ->
    {side: (losses, step-0 grads, final params)}, flat flax keys.  JAX's
    step-0 gradient is read from Adam's first moment, which one step from
    zero leaves at ``(1 - b1) * g``."""
    (jstep, jinit), (pstep, pinit) = jax_step, port_step
    jdt, tdt, ndt = ((jnp.float64, torch.float64, np.float64) if double
                     else (jnp.float32, torch.float32, np.float32))
    model = copy.deepcopy(model).to(tdt)
    params = _nest({k: jnp.asarray(v) for k, v in weights.from_state_dict(model.state_dict(), dtype=tdt).items()})
    out = {}
    opt_state, losses, grads = jinit(params), [], None
    for b in batches:
        params, opt_state, loss = jstep(params, opt_state, *(jnp.asarray(np.asarray(x, ndt)) for x in b))
        losses.append(float(loss))
        if grads is None:
            grads = weights.flatten(jax.tree.map(lambda m: np.asarray(m) / (1 - 0.9), opt_state[0].mu))
    out["jax"] = (losses, grads, weights.flatten(jax.tree.map(np.asarray, params)))

    opt, losses, grads = pinit(model), [], None
    for b in batches:
        losses.append(float(pstep(model, opt, *(torch.from_numpy(np.asarray(x, ndt)) for x in b))))
        if grads is None:
            grads = weights.from_state_dict({k: p.grad for k, p in model.named_parameters()}, dtype=tdt)
    out["port"] = (losses, grads, weights.from_state_dict(model.state_dict(), dtype=tdt))
    return out


@pytest.fixture(scope="module")
def runs():
    cases = _cases()
    jax.config.update("jax_enable_x64", True)
    try:
        batches = _batches(double=True)
        return {name: run_both(*case, batches[name], double=True) for name, case in cases.items()}
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def f32_losses():
    """name -> (port loss, JAX loss) in float32 on the first batch."""
    cases, batches = _cases(), _batches(double=False)
    jax_loss = {"ssd": functools.partial(jssd.ssd_loss, width=SSD_WIDTH),
                "lmk": functools.partial(jlf.landmark_loss, width=LMK_WIDTH)}
    port_loss = {"ssd": face_ssd.ssd_loss, "lmk": landmarks_fan.landmark_loss}
    out = {}
    for name, (model, _, _) in cases.items():
        b = batches[name][0]
        params = _nest({k: jnp.asarray(v) for k, v in weights.from_state_dict(model.state_dict()).items()})
        with torch.no_grad():
            got = float(port_loss[name](model, *(torch.from_numpy(np.asarray(x, np.float32)) for x in b)))
        out[name] = got, float(jax.jit(jax_loss[name])(params, *(jnp.asarray(x, jnp.float32) for x in b)))
    return out


def rel_l2(a, b):
    """Relative L2 distance of ``a`` to ``b``; 0 where both are all zero (the
    SSD's smallest-anchor loc head gets no gradient without a small face)."""
    diff, ref = np.linalg.norm(a - b), np.linalg.norm(b)
    return 0.0 if diff == ref == 0 else float(diff / ref)


def check_f64(out, zero_grad=()):
    """Float64 losses, step-0 gradients and final parameters within
    ``F64_RTOL`` per tensor; ``zero_grad`` tensors' gradients at zero."""
    (jl, jg, jp), (pl, pg, pp) = out["jax"], out["port"]
    np.testing.assert_allclose(pl, jl, rtol=F64_RTOL)
    assert set(pg) == set(jg) and set(pp) == set(jp)
    total = np.sqrt(sum(float(np.sum(g ** 2)) for g in jg.values()))
    for key in jg:
        if key in zero_grad:
            assert np.linalg.norm(jg[key]) <= ZERO_GRAD_RTOL * total
            assert np.linalg.norm(pg[key]) <= ZERO_GRAD_RTOL * total
            continue  # Adam scales rounding noise to ~lr * noise / eps
        assert rel_l2(pg[key], jg[key]) <= F64_RTOL, ("grad", key, rel_l2(pg[key], jg[key]))
        assert rel_l2(pp[key], jp[key]) <= F64_RTOL, ("param", key, rel_l2(pp[key], jp[key]))


CASES = ("ssd", "lmk")


@pytest.mark.parametrize("name", CASES)
def test_f32_loss_matches_jax(f32_losses, name):
    got, ref = f32_losses[name]
    np.testing.assert_allclose(got, ref, rtol=F32_LOSS_RTOL[name])


@pytest.mark.parametrize("name", CASES)
def test_f64_losses_gradients_and_params_after_three_adam_steps_match_jax(runs, name):
    check_f64(runs[name], ZERO_GRAD.get(name, ()))


def test_tied_negatives_follow_the_stable_order():
    """On a flat frame many negatives tie; the kept set is the lowest anchor
    indices among the ties, and the loss is JAX's on the same logits."""
    conf = torch.zeros(1, 12)
    conf[0, 2] = 3.0
    labels = torch.zeros(1, 12)
    labels[0, 7] = 1.0

    class Fixed(torch.nn.Module):
        def forward(self, x):
            return torch.zeros(1, 12, 4), conf

    got = float(face_ssd.ssd_loss(Fixed(), None, labels, torch.zeros(1, 12, 4)))
    bce = np.log1p(np.exp(-np.abs(conf.numpy()))) + np.maximum(conf.numpy(), 0) - conf.numpy() * labels.numpy()
    # n_pos 1 keeps 3 negatives: anchor 2 (the largest) and the first two tied ones, 0 and 1
    np.testing.assert_allclose(got, bce[0, [2, 0, 1, 7]].sum(), rtol=1e-6)


def test_ssd_loss_decreases():
    rng = np.random.RandomState(0)
    model = weights.seeded(face_ssd.FaceSSD(8), 0)
    gt = np.asarray([[0.3, 0.3, 0.7, 0.7]], np.float32)
    from fvd_tpu_torch.ops import detection

    anchors = face_ssd.anchors()
    labels, matched = detection.match_anchors(gt, anchors)
    loc_t = detection.encode_boxes(matched, anchors)
    loc_t[labels == 0] = 0
    frames = rng.rand(1, 300, 300, 3).astype(np.float32) * 50
    frames[0, 90:210, 90:210] += 150
    step, init_opt = face_ssd.make_train_step(lr=1e-3)
    opt = init_opt(model)
    batch = [torch.from_numpy(frames), torch.from_numpy(labels[None]), torch.from_numpy(loc_t[None].astype(np.float32))]
    losses = [float(step(model, opt, *batch)) for _ in range(8)]
    assert losses[-1] < losses[0]


def test_landmark_loss_decreases():
    rng = np.random.RandomState(0)
    model = weights.seeded(landmarks_fan.LandmarkHourglass(16), 0)
    crops = torch.from_numpy(rng.rand(2, 128, 128, 3).astype(np.float32))
    targets = torch.from_numpy(rng.rand(2, 68, 2).astype(np.float32))
    step, init_opt = landmarks_fan.make_landmark_train_step(lr=3e-3)
    opt = init_opt(model)
    losses = [float(step(model, opt, crops, targets)) for _ in range(6)]
    assert losses[-1] < losses[0]


def test_eval_after_a_step_sees_the_new_weights():
    """The bf16 copy that ``in_dtype`` keeps is cast again after the weights
    change: evaluate, train one step, evaluate again."""
    rng = np.random.RandomState(0)
    model = weights.seeded(landmarks_fan.LandmarkHourglass(16), 0)
    crops_u8 = torch.from_numpy((rng.rand(2, 128, 128, 3) * 255).astype(np.uint8))
    before = landmarks_fan.landmarks_forward(model, crops_u8)
    step, init_opt = landmarks_fan.make_landmark_train_step(lr=1e-2)
    step(model, init_opt(model), crops_u8.float() / 255.0, torch.rand(2, 68, 2))
    after = landmarks_fan.landmarks_forward(model, crops_u8)
    fresh = landmarks_fan.landmarks_forward(_copy(model), crops_u8)
    assert float((after - before).abs().max()) > 1e-3
    torch.testing.assert_close(after, fresh, rtol=0, atol=0)


def _copy(model):
    clone = landmarks_fan.LandmarkHourglass(model.width)
    clone.load_state_dict(model.state_dict())
    return clone
