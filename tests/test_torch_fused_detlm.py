"""The chained detector -> landmarks -> pose program of the port
(``fvd_tpu_torch.models.landmarks_fan.detlm_pose_from_frames``, switched on
by ``FVD_TPU_FUSED_DETLM``) against the port's unchained path and against
``fvd_tpu/models/landmarks_fan.py``'s ``detlm_pose_from_frames``.  The
detector is the JAX package's random initialisation at width 16 with 8 NMS
slots (several detections a frame), written as npz; the hourglass and the
pose head are the shipped ``landmarks.npz`` and ``pose.npz`` (a random
hourglass's soft-argmax magnifies float32 rounding past the f32 landmark
bar: 9.4e-5 of the crop between the packages).  The port's providers load
all three through ``fvd_tpu_torch.weights``; the frames are those of
``tests/test_models.py::test_chained_detlm_matches_unchained``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvd_tpu.models import face_ssd as jssd
from fvd_tpu.models import landmarks_fan as jlmk
from fvd_tpu_torch import weights
from fvd_tpu_torch.models import face_ssd as tssd
from fvd_tpu_torch.models import landmarks_fan as tlmk

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")

#: the f32 landmark bars of ``tests/test_torch_pose.py``: landmarks in crop
#: [0, 1] units (the fused program end to end), the pose head in degrees
LANDMARK_TOL = 1e-5
POSE_TOL_DEG = 5e-3
#: chained against unchained in the port: the JAX test's bars (pixels,
#: degrees); the two paths run the same float32 arithmetic on the same boxes
CHAIN_LM_TOL, CHAIN_POSE_TOL = 1e-5, 1e-3
THRESHOLD = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames():
    """``tests/test_models.py:580-585``: three 120x160 frames, a bright
    block on a dark ground with a little noise."""
    rng = np.random.RandomState(11)
    frames = np.full((3, 120, 160, 3), 30, np.uint8)
    for i in range(3):
        x0, y0 = 35 + 8 * i, 18 + 5 * i
        frames[i, y0:y0 + 72, x0:x0 + 64] = 205
        frames[i] += rng.randint(0, 6, frames[i].shape).astype(np.uint8)
    return frames


def _nest(flat):
    """Flat keystr npz tree -> the nested params dict flax applies."""
    out = {}
    for key, v in flat.items():
        node = out
        parts = key[2:-2].split("']['")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return out


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """JAX's random detector (as ``test_chained_detlm_matches_unchained``
    builds it) with the shipped hourglass and pose head, and the port's
    providers on the same weights, f32."""
    root = tmp_path_factory.mktemp("detlm")
    jdet = jssd.SSDFaceDetector(width=16, max_out=8)
    paths = {"det": str(root / "det.npz"), "lmk": os.path.join(CKPT, "landmarks.npz"),
             "pose": os.path.join(CKPT, "pose.npz")}
    jssd.save_params(paths["det"], jdet.params)
    jprov = jlmk.FANLandmarks(jdet, landmark_params=_nest(weights.read_npz(paths["lmk"])),
                              pose_params=_nest(weights.read_npz(paths["pose"])), width=32, pose_width=32,
                              detector_threshold=THRESHOLD)
    tdet = tssd.SSDFaceDetector(paths["det"], max_out=8, compute_dtype=torch.float32, device="cpu")
    tprov = tlmk.FANLandmarks(tdet, paths["lmk"], pose_checkpoint=paths["pose"], detector_threshold=THRESHOLD,
                              compute_dtype=torch.float32, device="cpu")
    return jprov, tprov


def _both_paths(prov, frames, monkeypatch):
    dev = torch.from_numpy(frames)
    monkeypatch.delenv("FVD_TPU_FUSED_DETLM", raising=False)
    unchained = prov.landmarks_pose_batch(frames, device_frames=dev, pose_pad=0.1)
    monkeypatch.setenv("FVD_TPU_FUSED_DETLM", "1")
    chained = prov.landmarks_pose_batch(frames, device_frames=dev, pose_pad=0.1)
    return unchained, chained


def test_chained_matches_unchained_in_the_port(models, monkeypatch):
    """``tests/test_models.py:568``: with every slot carried
    (``chained_k_slots = 8``), the chained path gives the unchained path's
    detections, landmarks (1e-5 px) and poses (1e-3 degree)."""
    _, prov = models
    prov.chained_k_slots = 8
    try:
        (lm_a, pose_a), (lm_b, pose_b) = _both_paths(prov, _frames(), monkeypatch)
    finally:
        prov.chained_k_slots = tlmk.FANLandmarks.chained_k_slots
    assert [len(x) for x in lm_a] == [len(x) for x in lm_b]
    assert sum(len(x) for x in lm_a) > 3  # random weights: several detections a frame
    for per_a, per_b in zip(lm_a, lm_b):
        for a, b in zip(per_a, per_b):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, atol=CHAIN_LM_TOL, rtol=0)
    for per_a, per_b in zip(pose_a, pose_b):
        for a, b in zip(per_a, per_b):
            np.testing.assert_allclose(a, b, atol=CHAIN_POSE_TOL, rtol=0)


@pytest.mark.parametrize("k_slots", [2, 8])
def test_chained_program_matches_jax(models, k_slots):
    """The port's program against JAX's ``detlm_pose_from_frames``, f32 on
    the same weights and frames: the slots' integer boxes and their gate
    equal; landmarks within LANDMARK_TOL of the crop and poses within
    POSE_TOL_DEG (the bars of ``tests/test_torch_pose.py``) in every valid
    slot."""
    jprov, tprov = models
    frames = _frames()
    T, H, W = frames.shape[:3]
    jout = jax.device_get(jlmk.detlm_pose_from_frames(
        jprov.face_detector.params, jprov.landmark_params, jprov.pose_params, jnp.asarray(frames),
        float(W), float(H), THRESHOLD, 0.1, det_width=16, det_max_out=8, k_slots=k_slots, width=32,
        pose_width=32, compute_dtype=jnp.float32))
    tout = tlmk.detlm_pose_from_frames(
        tprov.face_detector.model, tprov.landmark_model, tprov.pose_model, torch.from_numpy(frames),
        float(W), float(H), THRESHOLD, 0.1, det_max_out=8, k_slots=k_slots, compute_dtype=torch.float32)
    jb, js, jv, jc, jp = (np.asarray(a) for a in jout)
    tb, ts, tv, tc, tp = (t.numpy() for t in tout)
    assert tb.shape == (T, k_slots, 4) and tc.shape == (T * k_slots, 68, 2) and tp.shape == (T * k_slots, 3)
    assert tv.dtype == bool and tv.sum() >= T
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    ok = tv.reshape(-1)
    np.testing.assert_allclose(tc[ok], jc[ok], atol=LANDMARK_TOL, rtol=0)
    np.testing.assert_allclose(tp[ok], jp[ok], atol=POSE_TOL_DEG, rtol=0)


def test_chained_keeps_k_slots_detections_a_frame(models, monkeypatch):
    """With ``chained_k_slots = 2`` on frames holding more valid detections,
    the chained path keeps each frame's first two (NMS order) and drops the
    rest, as the JAX package's does."""
    jprov, tprov = models
    frames = _frames()
    (lm_a, pose_a), (lm_b, pose_b) = _both_paths(tprov, frames, monkeypatch)
    assert max(len(x) for x in lm_a) > 2
    assert [len(x) for x in lm_b] == [min(2, len(x)) for x in lm_a]
    for per_a, per_b in zip(lm_a, lm_b):
        for a, b in zip(per_a[:2], per_b):
            np.testing.assert_allclose(a, b, atol=CHAIN_LM_TOL, rtol=0)
    # the JAX package's chained provider keeps as many in each frame
    jprov.chained_k_slots = 2
    jlm, _ = jprov._landmarks_pose_chained(frames, jnp.asarray(frames), 0.1, frames.shape[2], frames.shape[1])
    assert [len(x) for x in jlm] == [len(x) for x in lm_b]


class _NoSync:
    """Makes every host read of a tensor raise: ``.cpu()``, ``.item()``,
    ``.tolist()``, ``.numpy()`` and ``bool(tensor)``."""

    NAMES = ("cpu", "item", "tolist", "numpy", "__bool__")

    def __init__(self, monkeypatch):
        def refuse(name):
            def f(*_a, **_k):
                raise AssertionError(f"host read of a tensor: {name}")
            return f
        for name in self.NAMES:
            monkeypatch.setattr(torch.Tensor, name, refuse(name))


def test_chained_program_reads_nothing_back(models, monkeypatch):
    """Nothing between the detector and the program's outputs reads a
    tensor back to the host: the provider's one ``.cpu()`` of the packed
    outputs is the path's only fetch."""
    _, prov = models
    frames = _frames()
    with monkeypatch.context() as m:
        _NoSync(m)
        outs = tlmk.detlm_pose_from_frames(
            prov.face_detector.model, prov.landmark_model, prov.pose_model, torch.from_numpy(frames),
            160.0, 120.0, THRESHOLD, 0.1, det_max_out=8, k_slots=2, compute_dtype=torch.float32)
    assert [tuple(o.shape) for o in outs] == [(3, 2, 4), (3, 2), (3, 2), (6, 68, 2), (6, 3)]
    calls = []
    real_cpu = torch.Tensor.cpu

    def counting(t, *a, **k):
        calls.append(tuple(t.shape))
        return real_cpu(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    monkeypatch.setenv("FVD_TPU_FUSED_DETLM", "1")
    prov.landmarks_pose_batch(frames, device_frames=torch.from_numpy(frames), pose_pad=0.1)
    assert calls == [(3, 2 * (4 + 1 + 1 + 136 + 3))]


def test_chained_switch_needs_a_detector_model(models, monkeypatch):
    """As in JAX (a detector holding ``params``), the switch acts only with
    a detector that holds its model; another detector takes the unchained
    path."""
    _, prov = models

    class Scripted:
        max_out, compute_dtype = 8, torch.float32

        def detect_batch(self, frames):
            from fvd_tpu_torch.providers.vision import FaceBox
            return [[FaceBox(40.0, 20.0, 100.0, 90.0, 0.9)] for _ in range(len(frames))]

    scripted = tlmk.FANLandmarks.__new__(tlmk.FANLandmarks)
    scripted.__dict__.update(prov.__dict__, face_detector=Scripted())
    monkeypatch.setenv("FVD_TPU_FUSED_DETLM", "1")
    frames = _frames()
    lm, poses = scripted.landmarks_pose_batch(frames, device_frames=torch.from_numpy(frames), pose_pad=0.1)
    assert [len(x) for x in lm] == [1, 1, 1] and [len(x) for x in poses] == [1, 1, 1]
