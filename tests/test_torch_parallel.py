"""``fvd_tpu_torch/parallel`` against ``fvd_tpu/parallel`` on the CPU, case
for case with ``tests/test_parallel.py``: the rank programs run on one module's
group of four gloo ranks (``parallel/launch.py``, spawned, so no process group
ever lives in this process), the in-process inference mesh on CPU entries, and
the JAX side on the conftest's 8 virtual devices.  Meshes of four devices at
most stand in for the JAX tests' eight (2x2, 1x2, 1x4, 4x1)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fvd_tpu.ops import lipsync as jlipsync
from fvd_tpu.parallel import pipeline as jpp
from fvd_tpu.parallel.mesh import make_mesh as jmake_mesh
from fvd_tpu_torch.parallel import pipeline as tpp
from fvd_tpu_torch.parallel import programs
from fvd_tpu_torch.parallel.inference import get_inference_mesh, set_inference_mesh, shard_for_inference
from fvd_tpu_torch.parallel.launch import RankGroup
from fvd_tpu_torch.parallel.mesh import make_mesh

#: SP lip-sync against the JAX package's single-device score
SP_TOL = 1e-5
#: the DP LR step
DP_TOL = 1e-6
#: the fused train step over 5 steps
MULTICHIP_TOL = 1e-5
#: sharded inference against one device
SHARDED_TOL = 2e-3
#: TP against the replicated forward, times max(1, |output|)
TP_TOL = 1e-4

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with RankGroup(4, "gloo", "cpu", str(tmp_path_factory.mktemp("store")), timeout=120.0) as group:
        yield group


def _signals(n=1800, fps=30.0, seed=0):
    rng = np.random.RandomState(seed)
    t = np.linspace(0, n / fps, n)
    mouth = np.clip(0.5 * (1 + np.sin(2 * np.pi * 2 * t)) + 0.1 * rng.rand(n), 0, 1)
    return mouth.astype(np.float32), np.roll(mouth, 3).astype(np.float32)


def test_make_mesh_shapes():
    mesh = make_mesh(n_data=4, n_time=2, devices=CPU8)
    assert mesh.shape == {"data": 4, "time": 2}
    mesh = make_mesh(n_time=8, devices=CPU8)
    assert mesh.shape == {"data": 1, "time": 8}
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        make_mesh(n_data=16, n_time=1, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(n_data=1)  # the default devices are the visible cards


@pytest.mark.parametrize("n_time", [1, 2, 4])
def test_time_sharded_lipsync_matches_single_device(ranks, n_time):
    mouth, audio = _signals()
    got = ranks.run(programs.sp_lipsync, 1, n_time, mouth, audio, 30.0)
    assert got[n_time:] == [None] * (4 - n_time)  # ranks outside the mesh
    assert len(set(got[:n_time])) == 1            # the score is replicated
    ref = float(jlipsync.lip_sync_score_xla(jnp.asarray(mouth), jnp.asarray(audio), 30.0).score)
    assert got[0] == pytest.approx(ref, abs=SP_TOL)


def test_time_sharded_lipsync_silence_is_zero(ranks):
    mouth, _ = _signals()
    got = ranks.run(programs.sp_lipsync, 2, 2, mouth, np.zeros(len(mouth), np.float32), 30.0)
    assert got == [0.0] * 4


def test_time_sharding_constraints_validated():
    mesh = make_mesh(n_data=1, n_time=8, devices=CPU8)
    with pytest.raises(ValueError, match="not divisible"):
        tpp.make_time_sharded_lipsync(mesh, 1801, 30.0)
    with pytest.raises(ValueError, match="multiple of hop"):
        tpp.make_time_sharded_lipsync(mesh, 800, 30.0)     # chunk 100, hop 75
    with pytest.raises(ValueError, match="shorter than window"):
        tpp.make_time_sharded_lipsync(mesh, 600, 30.0)     # chunk 75 < window + lag
    with pytest.raises(ValueError, match="batch 6 not divisible by data=4"):
        tpp.make_multichip_train_step(make_mesh(n_data=4, n_time=2, devices=CPU8), 6, 150, 10.0)
    with pytest.raises(ValueError, match="invalid time sharding"):
        tpp.make_multichip_train_step(make_mesh(n_data=4, n_time=2, devices=CPU8), 8, 100, 10.0)


def test_dp_lr_train_step_matches_single_device(ranks):
    rng = np.random.RandomState(0)
    feats = rng.rand(16, 9).astype(np.float32)
    labels = (rng.rand(16) > 0.5).astype(np.float32)
    w0 = rng.randn(9).astype(np.float32) * 0.1
    b0 = np.float32(0.2)

    got = ranks.run(programs.dp_lr_step, 4, feats, labels, w0, b0, 0.005)
    want = jpp.make_dp_lr_train_step(jmake_mesh(n_data=8, n_time=1), lr=0.005)(
        jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(w0), jnp.asarray(b0))
    for r in got:
        for k, v in zip(("w", "b", "probs", "loss"), want):
            np.testing.assert_allclose(r[k], np.asarray(v), atol=DP_TOL, rtol=0, err_msg=k)
    p = 1 / (1 + np.exp(-(feats @ w0 + b0)))
    np.testing.assert_allclose(got[0]["w"], w0 - 0.005 * feats.T @ (p - labels) / 16, atol=DP_TOL)
    np.testing.assert_allclose(got[0]["b"], b0 - 0.005 * (p - labels).mean(), atol=DP_TOL)


def test_multichip_train_step_runs_and_learns(ranks):
    fps, chunk, batch = 10.0, 75, 8
    n = chunk * 2
    rng = np.random.RandomState(0)
    t = np.linspace(0, n / fps, n)
    base = (0.5 * (1 + np.sin(2 * np.pi * 1.0 * t))).astype(np.float32)
    mouth = np.stack([np.roll(base, 3 * i) for i in range(batch)])
    audio = np.stack([np.roll(base, 3 * i + 1) for i in range(batch)])
    other = rng.rand(batch, 8).astype(np.float32)
    labels = (rng.rand(batch) > 0.5).astype(np.float32)
    w0, b0 = np.zeros(9, np.float32), np.float32(0.0)

    got = ranks.run(programs.multichip_train, 2, 2, batch, fps, mouth, audio, other, labels, w0, b0, 5)[0]
    step = jpp.make_multichip_train_step(jmake_mesh(n_data=4, n_time=2), batch, n, fps)
    w, b = jnp.asarray(w0), jnp.asarray(b0)
    for ours in got:
        w, b, probs, loss = step(jnp.asarray(mouth), jnp.asarray(audio), jnp.asarray(other),
                                 jnp.asarray(labels), w, b)
        for k, v in zip(("w", "b", "probs", "loss"), (w, b, probs, loss)):
            np.testing.assert_allclose(ours[k], np.asarray(v), atol=MULTICHIP_TOL, rtol=0, err_msg=k)
    assert got[-1]["probs"].shape == (batch,)
    assert got[0]["loss"] == pytest.approx(np.log(2.0), abs=1e-6)   # w = 0: p = 1/2
    assert got[-1]["loss"] < got[0]["loss"]                         # gradient steps reduce BCE


def test_dryrun_multichip_prints_ok(capsys, tmp_path):
    """The six checks on 4 gloo ranks, the production bundle on the npz view
    of the checkpoints (``tests/test_torch_zoo_dag.py``'s, no ``hf/``: the
    HF models' CPU decode would double the file's time)."""
    import os

    from fvd_tpu_torch.entry import CHECKPOINT_DIR, dryrun_multichip
    from test_torch_zoo_dag import LINKED

    for name in LINKED:
        os.symlink(os.path.join(CHECKPOINT_DIR, name), tmp_path / name)
    out = dryrun_multichip(4, device="cpu", checkpoint_dir=str(tmp_path))
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("dryrun_multichip OK")]
    assert len(line) == 1 and "mesh=(2x2)" in line[0] and "backend=gloo" in line[0]
    assert set(out["checks"]) == {"train", "tp", "tp_whisper2", "tp_whisper4", "pp", "ep", "sharded", "fan", "dag"}
    assert out["checks"]["dag"]["delta"] <= 1e-3


# ---------------------------------------------------------------------------
# Data-parallel sharded inference (parallel/inference.py)
# ---------------------------------------------------------------------------
def test_sharded_detector_matches_single_device():
    """The SSD provider with its frames split over an 8-entry mesh gives the
    single-device detections (items are independent)."""
    import os

    from fvd_tpu_torch.models.face_ssd import SSDFaceDetector

    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
    frames = np.random.RandomState(0).randint(0, 255, (16, 48, 64, 3)).astype(np.uint8)
    det = SSDFaceDetector(os.path.join(ckpt, "face_ssd.npz"), compute_dtype=torch.float32, device="cpu")
    calls = []
    det.model.register_forward_hook(lambda m, i, o: calls.append(i[0].shape[0]))

    base = det.detect_batch(frames)
    prev = set_inference_mesh(make_mesh(n_data=8, n_time=1, devices=CPU8))
    try:
        sharded = det.detect_batch(frames)
    finally:
        set_inference_mesh(prev)
    assert calls == [16] + [2] * 8   # one forward, then one per shard
    assert len(base) == len(sharded) == 16
    for b_dets, s_dets in zip(base, sharded):
        assert len(b_dets) == len(s_dets)
        for b, s in zip(b_dets, s_dets):
            np.testing.assert_allclose([b.x1, b.y1, b.x2, b.y2, b.confidence],
                                       [s.x1, s.y1, s.x2, s.y2, s.confidence], rtol=0, atol=SHARDED_TOL)


def test_shard_for_inference_falls_back_when_indivisible():
    model = torch.nn.Linear(4, 3)
    seen = []

    def fn(m, x):
        seen.append(x)
        return m(x), x.sum(dim=1)

    prev = set_inference_mesh(make_mesh(n_data=8, n_time=1, devices=CPU8))
    try:
        x = torch.ones(6, 4)  # 6 % 8 != 0
        out = shard_for_inference(fn, model, x)
        assert len(seen) == 1 and seen[0] is x  # the call as it is, no split
        y = torch.arange(64.0).reshape(16, 4)
        sharded = shard_for_inference(fn, model, y)
        assert len(seen) == 9 and all(s.shape == (2, 4) for s in seen[1:])
        torch.testing.assert_close(sharded[0], model(y), rtol=0, atol=SHARDED_TOL)
        torch.testing.assert_close(sharded[1], y.sum(dim=1))
        assert out[0].shape == (6, 3)
    finally:
        set_inference_mesh(prev)


def test_shard_for_inference_noop_without_mesh():
    assert get_inference_mesh() is None
    model = torch.nn.Linear(4, 2)
    x = torch.ones(8, 4)
    seen = []
    shard_for_inference(lambda m, a: seen.append((m, a)), model, x)
    assert seen == [(model, x)]
    # a 1-entry mesh passes through too
    prev = set_inference_mesh(make_mesh(n_data=1, n_time=1, devices=["cpu"]))
    try:
        shard_for_inference(lambda m, a: seen.append((m, a)), model, x)
    finally:
        set_inference_mesh(prev)
    assert seen[-1] == (model, x)


def test_scoring_service_shards_each_micro_batch():
    """Three CPU entries: each micro-batch padded to a multiple of 3, one
    stage call per device, every result equal to the JAX service's (on the
    8 virtual devices, its mesh branch) and to the single-device service's."""
    import json
    import os

    from fvd_tpu.serving import ScoringService as JaxScoringService
    from fvd_tpu_torch.serving import ScoreRequest, ScoringService

    with open(os.path.join(os.path.dirname(__file__), "fixtures", "lr_parity.json")) as f:
        weights = json.load(f)["weights"]
    rng = np.random.RandomState(3)
    reqs = [ScoreRequest(*_signals(300, 30.0, seed=i), rng.rand(8).astype(np.float32)) for i in range(5)]
    one = ScoringService(weights, n=300, fps=30.0, max_batch=8, max_wait_ms=50.0, devices=["cpu"])
    many = ScoringService(weights, n=300, fps=30.0, max_batch=8, max_wait_ms=50.0, devices=["cpu"] * 3)
    ref = JaxScoringService(weights, n=300, fps=30.0, max_batch=8, max_wait_ms=50.0)
    shards = []
    program = many.batch_program
    many.batch_program = lambda m, a, o: shards.append(m.shape[0]) or program(m, a, o)
    try:
        single = [f.result(timeout=60) for f in [one.submit(r) for r in reqs]]
        got = [f.result(timeout=60) for f in [many.submit(r) for r in reqs]]
        want = [f.result(timeout=120) for f in [ref.submit(r) for r in reqs]]
    finally:
        one.close()
        many.close()
        ref.close()
    assert many.devices == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ScoringService(weights, n=300, fps=30.0, devices=["cuda:0", "cuda:1"])  # named cards, none present
    assert shards and len(shards) % 3 == 0 and sum(shards) >= len(reqs)
    for g, s, w in zip(got, single, want):
        for k in ("lip_sync_score", "fake_probability"):
            assert g[k] == pytest.approx(s[k], abs=1e-6)
            assert g[k] == pytest.approx(w[k], abs=1e-5)   # the JAX service's own bar


def test_batch_main_installs_a_dp_mesh_over_several_cards(tmp_cwd, monkeypatch, capsys):
    """``main``'s multi-card branch, with two CPU entries standing in for two
    cards: it prints the mesh, runs under it and restores the previous one."""
    from fvd_tpu_torch import batch as tbatch
    from fvd_tpu_torch import providers as tprov
    from fvd_tpu_torch.synthetic import hermetic_providers

    monkeypatch.setattr(tprov, "_default", hermetic_providers(fps=10.0, device="cpu"))
    monkeypatch.setattr(tprov, "_default_is_custom", True)
    monkeypatch.setattr(tbatch, "_mesh_devices", lambda device: [torch.device("cpu")] * 2)
    seen = []
    monkeypatch.setattr(tbatch, "_main_body", lambda args, config, device: seen.append(get_inference_mesh()) or 0)
    assert tbatch.main(["--cpu", "--videos-dir", "none"]) == 0
    assert "inference mesh: 2-way DP" in capsys.readouterr().out
    assert seen[0].shape == {"data": 2, "time": 1} and get_inference_mesh() is None
    # one device: no mesh, as on a single card
    monkeypatch.setattr(tbatch, "_mesh_devices", lambda device: [])
    assert tbatch.main(["--cpu", "--videos-dir", "none"]) == 0
    assert seen[1] is None and "inference mesh" not in capsys.readouterr().out


def test_fan_landmark_net_matches_flax():
    """``FANLandmarkNet`` (dryrun check 3c's model) at a small width against
    the flax module on the same params, then 2-way sharded."""
    from fvd_tpu.models import landmarks_fan as jlmk
    from fvd_tpu_torch import weights
    from fvd_tpu_torch.models import landmarks_fan as tlmk

    crops = np.random.RandomState(9).rand(2, 64, 64, 3).astype(np.float32)
    jfan = jlmk.FANLandmarkNet(width=32, n_stacks=2)
    params = jax.jit(jfan.init)(jax.random.PRNGKey(9), jnp.asarray(crops))
    want = np.asarray(jax.jit(lambda p, c: jlmk.decode_heatmaps(jfan.apply(p, c)))(params, jnp.asarray(crops)))
    tfan = tlmk.FANLandmarkNet(width=32, n_stacks=2)
    tfan.load_state_dict(weights.to_state_dict(params), strict=True)

    def fwd(m, c):
        return tlmk.decode_heatmaps(m(c))

    with torch.no_grad():
        got = fwd(tfan, torch.from_numpy(crops)).numpy()
        prev = set_inference_mesh(make_mesh(n_data=2, n_time=1, devices=["cpu"] * 2))
        try:
            sharded = shard_for_inference(fwd, tfan, torch.from_numpy(crops)).numpy()
        finally:
            set_inference_mesh(prev)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(sharded, got, atol=SHARDED_TOL, rtol=0)


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------
def _shipped_tower():
    import json
    import os

    from fvd_tpu.models.encoders import MAX_TEXT_LEN, TextTower, load_params

    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
    with open(os.path.join(ckpt, "text_encoder.json")) as f:
        cfg = json.load(f)
    model = TextTower(dim=cfg["dim"], depth=cfg["depth"], out_dim=cfg["out_dim"])
    params = model.init(jax.random.PRNGKey(2), jnp.zeros((1, MAX_TEXT_LEN), jnp.int32))
    params = load_params(os.path.join(ckpt, "text_encoder.npz"), params)
    return model, params, (cfg["dim"], cfg["depth"], cfg["out_dim"]), MAX_TEXT_LEN


def test_tensor_parallel_text_tower_matches_replicated(ranks):
    """Megatron TP over 2 ranks on the shipped text tower (dim 192, 6 heads):
    the JAX package's replicated forward up to reduction order, with heads
    and MLP sharded (10 leaves a block)."""
    from fvd_tpu.models.transformer import ByteTokenizer
    from fvd_tpu_torch import weights
    from fvd_tpu_torch.models.encoders import TextTower
    from fvd_tpu_torch.parallel.tensor import tp_shardings, validate_tp_divisibility

    jmodel, params, (dim, depth, out_dim), seq = _shipped_tower()
    tok = ByteTokenizer()
    ids = np.stack([tok.encode(t, seq) for t in
                    ["the river rose", "taxes will fall", "a face appears", "nothing happened today"]])
    ref = np.asarray(jax.jit(jmodel.apply)(params, ids))

    validate_tp_divisibility(heads=max(1, dim // 32), mlp_hidden=4 * dim, tp=2)
    state = weights.to_state_dict(params)
    tmodel = TextTower(dim=dim, depth=depth, out_dim=out_dim)
    tmodel.load_state_dict(state, strict=True)
    specs = tp_shardings(tmodel)
    # q/k/v/out kernels + q/k/v biases + 2 MLP kernels + 1 MLP bias per block
    assert sum(d is not None for d in specs.values()) == depth * 10

    got = ranks.run(programs.tp_text_tower, 2, {k: v.numpy() for k, v in state.items()}, dim, depth, out_dim, ids)
    assert got[2:] == [None, None]
    scale = max(1.0, float(np.abs(ref).max()))
    for r in got[:2]:
        np.testing.assert_allclose(r, ref, rtol=0, atol=TP_TOL * scale)


def test_tensor_parallel_divisibility_guard():
    from fvd_tpu_torch.parallel.tensor import validate_tp_divisibility

    with pytest.raises(ValueError):
        validate_tp_divisibility(heads=6, mlp_hidden=768, tp=4)


# ---------------------------------------------------------------------------
# The rank launcher (parallel/launch.py)
# ---------------------------------------------------------------------------
def test_rank_group_fails_fast_on_a_rank_error_and_at_its_deadline(tmp_path):
    """A rank that raises, and a program that outlives the deadline (as a
    hung collective would), each end the group with every rank killed; a
    closed group leaves no process behind."""
    import operator
    import time

    group = RankGroup(2, "gloo", "cpu", str(tmp_path))
    assert group.run(operator.add, 1, 2) == [3, 3]
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        group.run(operator.truediv, 1, 0)
    assert not any(p.is_alive() for p in group._procs)

    with RankGroup(2, "gloo", "cpu", str(tmp_path)) as group:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="within 2 s"):
            group.run(time.sleep, 60, timeout=2.0)
        assert time.monotonic() - t0 < 30
    assert not any(p.is_alive() for p in group._procs)
