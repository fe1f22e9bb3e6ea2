"""``python -m fvd_tpu_torch.tools.pretrain_synthetic`` end to end on the CPU:
the npz files it writes have the shipped checkpoints' layout, load in the
JAX package's ``load_params`` and detect what the port detects; ``--resume``
continues the detector from its train state; the realism levers reach the
three trainers.  Also the tool's pose steps (``pose_loss``, and
``pose_consistency_loss`` on the paired batches) against the JAX package's,
held as ``tests/test_torch_train_losses.py`` holds the other two trainers,
and the port's ``checkpointing`` module as ``tests/test_checkpointing.py``
holds orbax's.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from fvd_tpu.models import face_ssd as jssd  # noqa: E402
from fvd_tpu.models import landmarks_fan as jlf  # noqa: E402
from fvd_tpu.models import synthetic_pose as jsp  # noqa: E402
from fvd_tpu_torch import weights  # noqa: E402
from fvd_tpu_torch.models import checkpointing, face_ssd, landmarks_fan  # noqa: E402
from fvd_tpu_torch.models.layers import adam, adam_step  # noqa: E402
from fvd_tpu_torch.tools import pretrain_synthetic  # noqa: E402
from test_torch_train_losses import _nest, check_f64, one_torch_thread  # noqa: E402,F401

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
NPZ = ("face_ssd.npz", "landmarks.npz", "pose.npz")
POSE_WIDTH = 16
#: the first pose batch's float32 loss
F32_LOSS_RTOL = 1e-5


def _shipped_tree(name):
    """The flax params tree of a shipped checkpoint (the template a JAX
    ``load_params`` fills)."""
    return _nest({k: jnp.asarray(v) for k, v in weights.read_npz(os.path.join(CKPT, name)).items()})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt")
    first = pretrain_synthetic.main(["--steps", "2", "--batch", "2", "--cpu", "--consistency", "--out-dir", str(out)])
    resumed = pretrain_synthetic.main(["--only", "det", "--resume", "--steps", "1", "--batch", "2", "--cpu",
                                       "--out-dir", str(out)])
    return str(out), first, resumed


@pytest.mark.parametrize("name", NPZ)
def test_npz_has_the_shipped_layout(trained, name):
    got, ref = weights.read_npz(os.path.join(trained[0], name)), weights.read_npz(os.path.join(CKPT, name))
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape and got[key].dtype == ref[key].dtype, key


def test_summaries_and_pose_json(trained):
    out, first, resumed = trained
    assert set(first) == {"det", "lmk", "pose"} and set(resumed) == {"det"}
    for s in first.values():
        assert s["steps"] == 2 and np.isfinite([s["loss_first"], s["loss_last"], s["data_ms"], s["step_ms"]]).all()
    assert 0.0 <= first["det"]["eval_mean_iou"] <= 1.0
    assert len(first["pose"]["eval_mean_abs_err_deg"]) == 3
    assert "consistency_loss_first" in first["pose"]
    with open(os.path.join(out, "pose.json")) as f:
        assert json.load(f) == {"width": 32}


def test_resume_continues_from_the_saved_step(trained):
    out, first, resumed = trained
    assert first["det"]["start_step"] == 0 and resumed["det"]["start_step"] == 2
    state_dir = os.path.join(out, "train_state_det")
    assert sorted(int(d) for d in os.listdir(state_dir)) == [2, 3]


def test_jax_load_params_detects_what_the_port_detects(trained, monkeypatch):
    # JAX's load_params takes its template tree from an eager flax init at
    # 300 px, op by op (seconds); the shipped checkpoint's tree is the same tree
    monkeypatch.setattr(jssd, "init_params", lambda rng, width=32: _shipped_tree("face_ssd.npz"))
    path = os.path.join(trained[0], "face_ssd.npz")
    jparams = jssd.load_params(path, width=32)
    frames = np.random.RandomState(1).randint(0, 255, size=(2, 240, 320, 3), dtype=np.uint8)
    ref_b, ref_s = jssd.detect_batch_jit(jparams, jnp.asarray(frames), width=32, compute_dtype=jnp.float32)
    provider = face_ssd.SSDFaceDetector(path, compute_dtype=torch.float32, device="cpu")
    got_b, got_s = face_ssd.detect_batch(provider.model, torch.from_numpy(frames), compute_dtype=torch.float32)
    # the bars of tests/test_torch_face_ssd.py
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b), atol=1e-5)
    assert len(provider.detect_batch(frames)) == 2


def test_landmark_and_pose_npz_load_in_jax_and_the_port(trained):
    out = trained[0]
    crops = np.random.RandomState(2).randint(0, 255, size=(2, 96, 96, 3), dtype=np.uint8)
    for name, fwd, port_fwd, port_cls in (
            ("landmarks.npz", jlf.landmarks_forward, landmarks_fan.landmarks_forward, landmarks_fan.LandmarkHourglass),
            ("pose.npz", jlf.pose_forward, landmarks_fan.pose_forward, landmarks_fan.PoseHead)):
        jparams = jlf.load_params(os.path.join(out, name), _shipped_tree(name))
        model = landmarks_fan.load_params(os.path.join(out, name), port_cls(32))
        kw = {"compute_dtype": jnp.float32} if name == "landmarks.npz" else {}
        ref = np.asarray(fwd(jparams, jnp.asarray(crops), width=32, **kw))
        got = port_fwd(model, torch.from_numpy(crops), **({"compute_dtype": torch.float32} if kw else {}))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-3 if name == "pose.npz" else 1e-5)


def test_levers_train_and_write_their_checkpoints(tmp_path, monkeypatch):
    """``--dense --photometric --shading --portrait`` reach the three
    trainers' generators (each draws its batches with them) and the tool
    writes its checkpoints."""
    seen = []
    for name in ("detector_batch", "landmark_batch", "pose_batch"):
        monkeypatch.setattr(pretrain_synthetic, name,
                            functools.partial(_recording, getattr(pretrain_synthetic, name), name, seen))
    out = pretrain_synthetic.main(["--dense", "--photometric", "--shading", "--portrait", "--augment", "--cpu",
                                   "--steps", "1", "--batch", "2", "--out-dir", str(tmp_path)])
    assert set(out) == {"det", "lmk", "pose"} and all(r["steps"] == 1 for r in out.values())
    for name in NPZ:
        assert os.path.exists(tmp_path / name)
    levers = {"photometric": True, "shaded": True, "portrait": True}
    assert ("detector_batch", {"augment": True, "dense": True, **levers}) in seen
    assert ("landmark_batch", {"augment": True, "hard_half": False, **levers}) in seen
    assert ("pose_batch", {"augment": True, "hard_half": False, **levers}) in seen


def _recording(real, name, seen, rng, batch, **kw):
    if kw:
        seen.append((name, kw))
    return real(rng, batch, **kw)


# ------------------------------------------------------------ the pose steps
def _jax_step(loss_fn):
    tx = optax.adam(1e-3)

    @jax.jit
    def step(params, opt_state, *batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, *batch, width=POSE_WIDTH)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return step, tx.init


POSE_CASES = {
    "pose": (jlf.pose_loss, landmarks_fan.pose_loss, lambda s: jsp.pose_batch(np.random.RandomState(s), 2)[:2]),
    "consistency": (jlf.pose_consistency_loss, landmarks_fan.pose_consistency_loss,
                    lambda s: jsp.pose_batch_paired(np.random.RandomState(s), 2)),
}


@pytest.mark.parametrize("name", POSE_CASES)
def test_pose_steps_match_jax(name):
    from test_torch_train_losses import run_both

    jloss, ploss, batch = POSE_CASES[name]
    model = weights.seeded(landmarks_fan.PoseHead(POSE_WIDTH), 2)
    b0 = batch(0)
    params = _nest({k: jnp.asarray(v) for k, v in weights.from_state_dict(model.state_dict()).items()})
    ref = float(jax.jit(functools.partial(jloss, width=POSE_WIDTH))(params, *(jnp.asarray(x, jnp.float32) for x in b0)))
    with torch.no_grad():
        got = float(ploss(model, *(torch.from_numpy(np.asarray(x, np.float32)) for x in b0)))
    np.testing.assert_allclose(got, ref, rtol=F32_LOSS_RTOL)
    jax.config.update("jax_enable_x64", True)
    try:
        out = run_both(model, _jax_step(jloss), (functools.partial(adam_step, ploss), adam),
                       [batch(s) for s in range(3)], double=True)
    finally:
        jax.config.update("jax_enable_x64", False)
    check_f64(out)


def test_paired_batch_shares_rotation_differs_in_appearance():
    from fvd_tpu_torch.models.synthetic_pose import pose_batch_paired

    ca, cb, Rs = pose_batch_paired(np.random.RandomState(3), 6)
    assert ca.shape == cb.shape == (6, 128, 128, 3) and Rs.shape == (6, 3, 3)
    for R in Rs:
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-9)
        assert np.linalg.det(R) > 0.99
    diff = np.abs(ca - cb).mean(axis=(1, 2, 3))
    assert (diff > 0).all() and (diff < 0.5).all()


def test_consistency_loss_penalizes_divergence():
    ca, cb, Rs = (torch.from_numpy(np.asarray(x, np.float32))
                  for x in jsp.pose_batch_paired(np.random.RandomState(1), 4))
    model = weights.seeded(landmarks_fan.PoseHead(8), 0)
    with torch.no_grad():
        base = landmarks_fan.pose_consistency_loss(model, ca, cb, Rs, lam=0.0)
        with_cons = landmarks_fan.pose_consistency_loss(model, ca, cb, Rs, lam=1.0)
        same = landmarks_fan.pose_consistency_loss(model, ca, ca, Rs, lam=1.0)
        sup_only = landmarks_fan.pose_consistency_loss(model, ca, ca, Rs, lam=0.0)
    assert float(with_cons) >= float(base)
    np.testing.assert_allclose(float(same), float(sup_only), rtol=1e-6)


# ------------------------------------------------------------ checkpointing
def _stepped(value: float):
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.fill_(value)
    opt = adam(model)
    adam_step(lambda m, x: m(x).sum(), model, opt, torch.ones(1, 3))
    return model, opt


def test_save_load_roundtrip(tmp_path):
    model, opt = _stepped(1.5)
    checkpointing.save_train_state(str(tmp_path / "ckpt"), 7, model, opt)
    fresh, fresh_opt = _stepped(0.0)
    assert checkpointing.load_train_state(str(tmp_path / "ckpt"), fresh, fresh_opt) == 7
    for a, b in zip(model.state_dict().values(), fresh.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    sa, sb = opt.state_dict()["state"], fresh_opt.state_dict()["state"]
    for k in sa:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(sa[k][name], sb[k][name], rtol=0, atol=0)


def test_load_missing_returns_none(tmp_path):
    model, opt = _stepped(0.0)
    assert checkpointing.load_train_state(str(tmp_path / "nope"), model, opt) is None


def test_retention_keeps_latest(tmp_path):
    path = str(tmp_path / "ckpt")
    for step in range(5):
        model, opt = _stepped(float(step))
        checkpointing.save_train_state(path, step, model, opt)
    assert sorted(os.listdir(path)) == ["2", "3", "4"]
    model, opt = _stepped(0.0)
    assert checkpointing.load_train_state(path, model, opt) == 4
    ref, _ = _stepped(4.0)
    torch.testing.assert_close(model.weight, ref.weight, rtol=0, atol=0)
