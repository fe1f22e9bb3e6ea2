"""The port's CUDA kernels on the card: each against its plain version.

These tests need an NVIDIA card (``-m cuda``) and skip elsewhere; on a
machine with one run ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from fvd_tpu_torch import _kernels
from fvd_tpu_torch.c1_timing import count_device_ops
from fvd_tpu_torch.ops import lipsync as tlip

pytestmark = pytest.mark.cuda
TOL = 1e-5  # float32 on both sides; only the summation order differs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is CUDA C++ and has no CPU mode")
    return torch.device("cuda")


def bessel_gate_signal(rng_seed: int = 0) -> np.ndarray:
    """A raw 10 s row at 30 fps (3 windows of 150) whose first window,
    z-normalised with the row's population std, has a Bessel std midway
    between ``silence_std`` = 0.01 and 0.01 * sqrt(150/149), so its population
    std is just under 0.01: the gate passes it only with the Bessel std."""
    rest = np.random.RandomState(rng_seed).rand(150)
    target = 0.01 * (1 + np.sqrt(150 / 149)) / 2
    a = 0.003
    for _ in range(20):  # the row's std moves a little with a
        sig = np.concatenate([0.5 + a * np.tile([1.0, -1.0], 75), rest])
        a = target * sig.std() / np.sqrt(150 / 149)
    return np.concatenate([0.5 + a * np.tile([1.0, -1.0], 75), rest]).astype(np.float32)


def _stage_pair(cuda, batch, n, fps):
    rng = np.random.RandomState(batch * 1000 + n)
    m = torch.from_numpy(rng.rand(batch, n).astype(np.float32)).to(cuda)
    a = torch.from_numpy(rng.rand(batch, n).astype(np.float32)).to(cuda)
    a[0] = 0.0  # a silent video: every window invalid
    return m, a


# (batch, n, fps): the analyzer's shape, 30 fps, a short signal, a serving batch, odd sizes,
# and the DAG node's: 60 s, a coalesced group of 64, 10 min
SHAPES = [(1, 50, 5.0), (1, 300, 30.0), (2, 40, 30.0), (64, 50, 5.0), (7, 611, 25.0), (3, 10, 1.0),
          (1, 1800, 30.0), (64, 1800, 30.0), (1, 18000, 30.0)]


@pytest.mark.parametrize("batch,n,fps", SHAPES)
def test_window_kernel_matches_plain(cuda, batch, n, fps):
    """The stage kernel against the plain stage from the same raw signals,
    with one launch per call."""
    m, a = _stage_pair(cuda, batch, n, fps)
    before = _kernels.LAUNCHES["lipsync_score"]
    r = tlip.lip_sync_score_batch(m, a, fps)
    assert _kernels.LAUNCHES["lipsync_score"] == before + 1
    p = tlip.lip_sync_score_batch_plain(m, a, fps)
    torch.cuda.synchronize()
    assert float((r.score - p.score).abs().max()) <= TOL
    assert float((r.window_scores - p.window_scores).abs().max()) <= TOL
    assert torch.equal(r.window_valid, p.window_valid) and torch.equal(r.n_valid, p.n_valid)
    assert not bool(r.window_valid[0].any()) and float(r.score[0]) == 0.0


def test_window_gate_uses_bessel_std(cuda):
    sig = torch.from_numpy(bessel_gate_signal()).to(cuda)[None]
    r = tlip.lip_sync_score_batch(sig, sig, 30.0)
    p = tlip.lip_sync_score_batch_plain(sig, sig, 30.0)
    assert r.window_valid[0].tolist() == p.window_valid[0].tolist() == [True, True, True]
    assert abs(float(r.score[0]) - float(p.score[0])) <= TOL


def test_batch_score_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(0)
    mouths = rng.rand(16, 300).astype(np.float32)
    audios = rng.rand(16, 300).astype(np.float32)
    got = tlip.lip_sync_score_batch(torch.from_numpy(mouths).to(cuda), torch.from_numpy(audios).to(cuda), 30.0)
    ref = tlip.lip_sync_score_batch(torch.from_numpy(mouths), torch.from_numpy(audios), 30.0)
    np.testing.assert_allclose(got.score.cpu().numpy(), ref.score.numpy(), atol=TOL)
    assert torch.equal(got.n_valid.cpu(), ref.n_valid)


def test_single_video_on_card_matches_its_batch_row(cuda):
    m, a = _stage_pair(cuda, 4, 300, 30.0)
    rb = tlip.lip_sync_score_batch(m, a, 30.0)
    before = _kernels.LAUNCHES["lipsync_score"]
    r = tlip.lip_sync_score(m[2], a[2], 30.0)
    assert _kernels.LAUNCHES["lipsync_score"] == before + 1
    assert r.score.shape == () and r.n_valid.shape == () and r.window_scores.shape == (3,)
    assert float(r.score) == float(rb.score[2]) and int(r.n_valid) == int(rb.n_valid[2])
    assert torch.equal(r.window_scores, rb.window_scores[2]) and torch.equal(r.window_valid, rb.window_valid[2])


def test_stage_call_dispatches_no_device_op(cuda):
    """Besides its outputs' allocation and its one launch, a stage call does
    no device work."""
    m, a = _stage_pair(cuda, 64, 1800, 30.0)
    tlip.lip_sync_score_batch(m, a, 30.0)
    before = _kernels.LAUNCHES["lipsync_score"]
    ops = count_device_ops(lambda: tlip.lip_sync_score_batch(m, a, 30.0))
    assert not ops and _kernels.LAUNCHES["lipsync_score"] == before + 1


def test_window_wrapper_rejects_bad_inputs(cuda):
    m = torch.zeros(2, 50, device=cuda)
    with pytest.raises(ValueError):
        tlip.lip_sync_score_batch(m, m[:, :40].contiguous(), 5.0)  # shapes differ
    with pytest.raises(ValueError):
        tlip.lip_sync_score_batch(m[None], m[None], 5.0)  # neither [B, N] nor [N]
    with pytest.raises(ValueError):
        tlip.lip_sync_score_batch(m, m.cpu(), 5.0)  # two devices
    with pytest.raises(ValueError):  # a 5 s window at 6000 fps: no slice fits the shared memory
        tlip.lip_sync_score_batch(torch.zeros(1, 40000, device=cuda), torch.zeros(1, 40000, device=cuda), 6000.0)


def test_stage_takes_strided_and_half_signals(cuda):
    """Signals that are not contiguous float32 are converted before the launch."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(300, 4).astype(np.float32)).to(cuda)
    r = tlip.lip_sync_score_batch(x.t()[:2], x.t()[2:].half(), 30.0)
    p = tlip.lip_sync_score_batch_plain(x.t()[:2], x.t()[2:].half(), 30.0)
    assert float((r.score - p.score).abs().max()) <= TOL


def test_entry_on_card_launches_the_kernel(cuda):
    from fvd_tpu_torch.entry import entry

    fn, args = entry(device=cuda, duration=4.0)
    _kernels.reset_launches()
    prob, lip = fn(*args)
    assert _kernels.LAUNCHES["lipsync_score"] == 1
    assert 0.0 <= float(prob) <= 1.0 and float(lip) >= 0.0


def test_c1_node_on_card_matches_cpu_and_groups_launch_once(cuda):
    """The C1 node on the card equals the node on the CPU, one launch per
    single-video call, and a coalesced group of 4 videos is one launch."""
    from concurrent.futures import ThreadPoolExecutor

    from fvd_tpu_torch.nodes import c1_lipsync
    from fvd_tpu_torch.providers import coalesce
    from fvd_tpu_torch.state import State

    rng = np.random.RandomState(6)
    t = np.linspace(0, 60.0, 1800)
    states = []
    for i in range(4):
        env = np.clip(0.5 * (1 + np.sin(2 * np.pi * 2 * t)) + 0.1 * rng.rand(t.size), 0, 1)
        mouth = np.roll(env, 3 * i) if i < 3 else rng.rand(t.size)
        states.append(State(metadata={"fps": 30.0, "duration": 60.0}, face_detections=[{"box": [0, 0, 9, 9]}],
                            mouth_landmarks=[{"timestamp": t[j], "mar": mouth[j]} for j in range(0, t.size, 6)],
                            audio_envelope=env))
    cpu = [c1_lipsync.run(s, device="cpu")["lip_sync_score"] for s in states]
    _kernels.reset_launches()
    single = [c1_lipsync.run(s, device=cuda)["lip_sync_score"] for s in states]
    assert _kernels.LAUNCHES["lipsync_score"] == len(states)
    np.testing.assert_allclose(single, cpu, atol=TOL, rtol=0)

    deactivate = coalesce._activate_program_coalescer(max_wait_ms=200.0)
    co = coalesce._program_co
    try:
        _kernels.reset_launches()
        with ThreadPoolExecutor(len(states)) as pool:
            grouped = [d["lip_sync_score"] for d in pool.map(lambda s: c1_lipsync.run(s, device=cuda), states)]
        launches, groups = _kernels.LAUNCHES["lipsync_score"], co.groups_run
    finally:
        deactivate()
    assert groups == 1 and launches == 1, (groups, launches)
    np.testing.assert_allclose(grouped, cpu, atol=TOL, rtol=0)


def _video_dag(root, device, dtype):
    """The seven nodes IN -> A1 -> A3, IN -> V1 -> V3, {A3, V3} -> C1 -> LR of
    the port on ``device``, with the shipped checkpoints."""
    import dataclasses
    import functools
    import os

    from fvd_tpu_torch.config import default_config
    from fvd_tpu_torch.models.face_ssd import SSDFaceDetector
    from fvd_tpu_torch.models.landmarks_fan import FANLandmarks
    from fvd_tpu_torch.nodes import (a1_standardize, a3_onsets, c1_lipsync, ingest, lr_fusion, v1_faces,
                                     v3_landmarks)
    from fvd_tpu_torch.providers import Providers
    from fvd_tpu_torch.runtime import DAG

    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
    det = SSDFaceDetector(checkpoint=os.path.join(ckpt, "face_ssd.npz"), compute_dtype=dtype, device=device)
    prov = Providers(face_detector=det, landmarks=FANLandmarks(
        det, checkpoint=os.path.join(ckpt, "landmarks.npz"), compute_dtype=dtype, device=device))
    cfg = default_config()
    cfg = cfg.replace(ingest=dataclasses.replace(cfg.ingest, processed_dir=str(root / "processed")),
                      fusion=dataclasses.replace(cfg.fusion, weights_path=str(root / "lr_weights.json"),
                                                 features_dir=str(root / "features")))
    part = functools.partial
    dag = DAG()
    dag.add_node("IN", part(ingest.run, config=cfg), host_only=True)
    dag.add_node("A1", part(a1_standardize.run, config=cfg, device=device), deps=["IN"])
    dag.add_node("V1", part(v1_faces.run, config=cfg, providers=prov, device=device), deps=["IN"])
    dag.add_node("A3", part(a3_onsets.run, config=cfg, device=device), deps=["A1"])
    dag.add_node("V3", part(v3_landmarks.run, config=cfg, providers=prov, device=device), deps=["V1"])
    dag.add_node("C1", part(c1_lipsync.run, config=cfg, device=device), deps=["A3", "V3"])
    dag.add_node("LR", part(lr_fusion.run, config=cfg), deps=["C1"])
    return dag


@pytest.fixture(scope="module")
def video_runs(tmp_path_factory):
    """The seven-node DAG in f32 on the CPU and on the card, for a clip in
    sync and one with a dubbed mouth: final states, and per card run the C1
    launches and the frame uploads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the C1 kernel is CUDA C++ and has no CPU mode")
    from fvd_tpu_torch.providers import media
    from fvd_tpu_torch.runtime import Scheduler
    from fvd_tpu_torch.state import State
    from fvd_tpu_torch.synthetic import make_face_video

    root = tmp_path_factory.mktemp("video")
    clips = [make_face_video(str(root / "clips"), "sync", duration=6.0, fps=10.0, sr=44100),
             make_face_video(str(root / "clips"), "dubbed", duration=6.0, fps=10.0, sr=44100,
                             mouth_gate_hz=0.37)]
    out = {"cpu": [], "cuda": [], "launches": [], "uploads": []}
    # f32 against f32: keep cuDNN's convolutions and cuBLAS out of TF32
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in ("cpu", "cuda"):
            sched = Scheduler(_video_dag(tmp_path_factory.mktemp(device), device, torch.float32))
            for clip in clips:
                media.clear_frame_cache()
                _kernels.reset_launches()
                out[device].append(sched.invoke(State(input_path=clip)))
                if device == "cuda":
                    out["launches"].append(_kernels.LAUNCHES["lipsync_score"])
                    out["uploads"].append(media._device_frames.uploads)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def test_video_dag_on_card_matches_cpu(video_runs):
    for card, cpu in zip(video_runs["cuda"], video_runs["cpu"]):
        assert abs(card.lip_sync_score - cpu.lip_sync_score) <= 1e-4
        assert abs(card.fake_probability - cpu.fake_probability) <= 1e-5
        assert sum(bool(m["landmarks"]) for m in card.mouth_landmarks) >= 24
    assert video_runs["cuda"][0].lip_sync_score > video_runs["cuda"][1].lip_sync_score


def test_video_dag_launches_the_c1_kernel_once_per_video(video_runs):
    assert video_runs["launches"] == [1, 1]


def test_video_dag_uploads_frames_once_per_video(video_runs):
    """V1 uploads the union of its keyframes and V3's samples; V3 gathers
    from it on the card."""
    assert video_runs["uploads"] == [1, 1]


@pytest.fixture(scope="module")
def full_dag_runs(tmp_path_factory):
    """The 16-node DAG of ``graph.build_graph`` in f32 on the CPU and on the
    card (TF32 off), with ``pose.npz`` and ``chip_smoke.py``'s hermetic
    bundle, for one clip: final states, and for the card run the C1
    launches, the frame uploads and the shared landmark forwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the C1 kernel is CUDA C++ and has no CPU mode")
    import os
    import sys

    from fvd_tpu_torch.providers import media
    from fvd_tpu_torch.state import State
    from fvd_tpu_torch.synthetic import make_face_video

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    clip = make_face_video(str(tmp_path_factory.mktemp("clips")), "clip", duration=6.0, fps=10.0, sr=44100)
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in ("cpu", "cuda"):
            sched = chip_smoke._full_dag_scheduler(str(tmp_path_factory.mktemp(device)), device, torch.float32)
            media.clear_frame_cache()
            _kernels.reset_launches()
            out[device] = sched.invoke(State(input_path=clip))
            out[device + "_counts"] = (_kernels.LAUNCHES["lipsync_score"], media._device_frames.uploads,
                                       media._landmark_share.forwards)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def test_full_dag_on_card_matches_cpu(full_dag_runs):
    card, cpu = full_dag_runs["cuda"], full_dag_runs["cpu"]
    assert list(card.features) == list(cpu.features) and len(card.features) == 9
    for k, v in cpu.features.items():
        assert abs(card.features[k] - v) <= 1e-4, (k, card.features[k], v)
    assert abs(card.fake_probability - cpu.fake_probability) <= 1e-5
    assert len(card.head_pose_data) >= 24 and len(card.claims) == 2 and card.texture_ela_score == 0.3


def test_full_dag_launches_c1_once_and_shares_one_landmark_forward(full_dag_runs):
    """One C1 launch, one frame upload and one landmark forward (V3's and
    V4's, shared) for the clip's one chunk."""
    assert full_dag_runs["cuda_counts"] == (1, 1, 1)


def test_pose_head_runs_in_f32_under_a_bf16_bundle(cuda, tmp_path):
    """Landmarks in bf16 on the card, the pose head in float32: the fused
    program's poses are the f32 pose head's on the bf16 landmarks' boxes."""
    import os

    from fvd_tpu_torch.models.face_ssd import SSDFaceDetector
    from fvd_tpu_torch.models.landmarks_fan import FANLandmarks
    from fvd_tpu_torch.nodes._tracking import landmark_box
    from fvd_tpu_torch.providers.media import VideoReader
    from fvd_tpu_torch.synthetic import make_face_video

    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
    det = SSDFaceDetector(checkpoint=os.path.join(ckpt, "face_ssd.npz"), compute_dtype=torch.bfloat16, device=cuda)
    prov = FANLandmarks(det, checkpoint=os.path.join(ckpt, "landmarks.npz"),
                        pose_checkpoint=os.path.join(ckpt, "pose.npz"), compute_dtype=torch.bfloat16, device=cuda)
    clip = make_face_video(str(tmp_path), "f", duration=1.6, fps=10.0)
    frames, _ = VideoReader(use_cache=False).sample(clip, range(16))
    lm, poses = prov.landmarks_pose_batch(frames, pose_pad=0.1)
    assert next(prov.pose_model.parameters()).dtype == torch.float32
    boxes, owners, got = [], [], []
    for i, (lms, ps) in enumerate(zip(lm, poses)):
        for pts, p in zip(lms, ps):
            x1, y1, x2, y2 = landmark_box(pts)
            pw, ph = int((x2 - x1) * 0.1), int((y2 - y1) * 0.1)
            boxes.append((max(0, x1 - pw), max(0, y1 - ph), min(320, x2 + pw), min(240, y2 + ph)))
            owners.append(i)
            got.append(p)
    assert len(got) >= 14
    ref = prov.pose_boxes_batch(torch.from_numpy(frames).to(cuda), boxes, owners)
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-3, rtol=0)


def _face_provider(device, dtype):
    """The shipped detector, hourglass and pose head on ``device``."""
    import os

    from fvd_tpu_torch.models.face_ssd import SSDFaceDetector
    from fvd_tpu_torch.models.landmarks_fan import FANLandmarks

    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
    det = SSDFaceDetector(checkpoint=os.path.join(ckpt, "face_ssd.npz"), compute_dtype=dtype, device=device)
    return FANLandmarks(det, checkpoint=os.path.join(ckpt, "landmarks.npz"),
                        pose_checkpoint=os.path.join(ckpt, "pose.npz"), compute_dtype=dtype, device=device)


def test_chained_detlm_on_card_matches_cpu_and_the_unchained_path(cuda, tmp_path, monkeypatch):
    """``FVD_TPU_FUSED_DETLM`` on the card, f32 with TF32 off, on a face
    clip's frames: the chained program finds the unchained path's faces
    (landmarks within 1e-5 of the crop, poses within 1e-3 degree) and the
    CPU chained program's (integer boxes equal, landmarks within 1e-4 of the
    crop and poses within 5e-3 degree: card against CPU convolutions), with
    one device-to-host copy a call.  Landmarks are compared in crop units,
    each gap over its detector box's extent: at 240x320 a pixel coordinate's
    float32 ulp is already 1.5e-5."""
    from fvd_tpu_torch.models import landmarks_fan
    from fvd_tpu_torch.providers.media import VideoReader
    from fvd_tpu_torch.synthetic import make_face_video

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        clip = make_face_video(str(tmp_path), "f", duration=1.6, fps=10.0, opencv=True)
        frames, _ = VideoReader(use_cache=False).sample(clip, range(16))
        card, cpu = _face_provider(cuda, torch.float32), _face_provider("cpu", torch.float32)
        dev = torch.from_numpy(frames).to(cuda)
        owners, boxes = card._collect_detections(card.face_detector.detect_batch(dev), 320, 240)
        monkeypatch.delenv("FVD_TPU_FUSED_DETLM", raising=False)
        lm_u, pose_u = card.landmarks_pose_batch(frames, device_frames=dev, pose_pad=0.1)
        monkeypatch.setenv("FVD_TPU_FUSED_DETLM", "1")
        copies = []
        real_cpu = torch.Tensor.cpu

        def counting_cpu(t, *a, **k):
            copies.append(t.device.type)
            return real_cpu(t, *a, **k)

        monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
        lm_c, pose_c = card.landmarks_pose_batch(frames, device_frames=dev, pose_pad=0.1)
        monkeypatch.setattr(torch.Tensor, "cpu", real_cpu)
        lm_h, pose_h = cpu.landmarks_pose_batch(frames, pose_pad=0.1)
        prog = [landmarks_fan.detlm_pose_from_frames(
            p.face_detector.model, p.landmark_model, p.pose_model, f, 320.0, 240.0, 0.5, 0.1,
            compute_dtype=torch.float32)[0].to("cpu") for p, f in ((card, dev), (cpu, torch.from_numpy(frames)))]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert copies == ["cuda"]
    assert [len(x) for x in lm_c] == [len(x) for x in lm_u] == [len(x) for x in lm_h] and sum(map(len, lm_c)) >= 14
    assert owners == sorted(owners) and len(owners) == sum(map(len, lm_c))
    assert torch.equal(prog[0], prog[1])
    flat = [(u, c, h) for a, b, d in zip(lm_u, lm_c, lm_h) for u, c, h in zip(a, b, d)]
    for (u, c, h), (x1, y1, x2, y2) in zip(flat, boxes):
        extent = np.array([x2 - x1, y2 - y1], np.float64)
        assert (np.abs(c.astype(np.float64) - u) / extent).max() <= 1e-5
        assert (np.abs(c.astype(np.float64) - h) / extent).max() <= 1e-4
    for pa, pb, ph in zip(pose_u, pose_c, pose_h):
        for x, y, z in zip(pa, pb, ph):
            np.testing.assert_allclose(y, x, atol=1e-3, rtol=0)
            np.testing.assert_allclose(y, z, atol=5e-3, rtol=0)


@pytest.fixture(scope="module")
def zoo():
    """The production bundle's four npz models at their shipped checkpoints
    (a view of the checkpoints less ``hf/``), on the card and on the CPU,
    with TF32 off while the module's tests run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the models are compared card against CPU")
    from fvd_tpu_torch.providers.factory import production_providers

    ckpt = _chip_smoke()._npz_checkpoints()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield {d: production_providers(ckpt, device=d, compute_dtype=torch.float32) for d in ("cuda", "cpu")}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _chip_smoke():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


def test_text_encoder_on_card_matches_cpu(zoo):
    sentences = _chip_smoke()._sentences(64)
    e = {d: p.text_encoder.encode_batch(sentences) for d, p in zoo.items()}
    e = {d: v / np.linalg.norm(v, axis=-1, keepdims=True) for d, v in e.items()}
    np.testing.assert_allclose(e["cuda"], e["cpu"], atol=1e-5, rtol=0)
    assert np.array_equal(np.argsort(-(e["cuda"] @ e["cuda"].T), 1)[:, :3], np.argsort(-(e["cpu"] @ e["cpu"].T), 1)[:, :3])


def test_clip_on_card_matches_cpu(zoo):
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, (240, 320, 3)).astype(np.uint8) for _ in range(8)]
    texts = _chip_smoke()._sentences(8)
    s = {d: p.clip.image_text_similarity_batch(images, texts) for d, p in zoo.items()}
    np.testing.assert_allclose(s["cuda"], s["cpu"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("checkpoint", ["asr.npz", "asr_formant.npz"])
def test_asr_tokens_on_card_equal_cpu(zoo, checkpoint):
    import os

    from fvd_tpu_torch.models.asr import JaxASR
    from fvd_tpu_torch.synthetic import gated_speech

    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints", checkpoint)
    asr = {d: JaxASR.from_checkpoint(ckpt, device=d) for d in zoo}
    speech = gated_speech(_chip_smoke().ASR_TEXT, duration=15.0, gate_hz=1.0)
    _, rows, nf = asr["cuda"].windows(speech)
    assert np.array_equal(asr["cuda"].decode_windows(rows, nf), asr["cpu"].decode_windows(rows, nf))
    assert asr["cuda"].transcribe("", audio=speech) == asr["cpu"].transcribe("", audio=speech)


def test_ocr_device_path_on_card_matches_the_cpu_and_the_host_path(zoo):
    """``detect_packed_mask`` on the card against the CPU's bf16 masks, and
    the device path's texts against the host path's on 256x256 frames (both
    resizes are the identity there)."""
    from fvd_tpu_torch.models.ocr import detect_packed_mask

    frames = _chip_smoke()._text_frames()
    masks = {d: detect_packed_mask(p.ocr.detector, torch.from_numpy(frames).to(d)).cpu().numpy()
             for d, p in zoo.items()}
    assert masks["cuda"].sum() > 1000 and (masks["cuda"] == masks["cpu"]).mean() >= 0.999
    square = np.ascontiguousarray(frames[:, :, 32:288])[:, :256]
    square = np.concatenate([square, np.zeros((3, 16, 256, 3), np.uint8)], axis=1)
    card = zoo["cuda"].ocr
    dev = card.read_text_batch_device(torch.from_numpy(square).cuda(), list(square))
    host = card.read_text_batch(list(square))
    assert [[d["text"] for d in f] for f in dev] == [[d["text"] for d in f] for f in host]
    assert [[d["text"] for d in f] for f in dev] == \
        [[d["text"] for d in f] for f in zoo["cpu"].ocr.read_text_batch_device(torch.from_numpy(square),
                                                                                list(square))]


@pytest.fixture(scope="module")
def hf_models():
    """The HF lineup on the card and on the CPU with TF32 off: MiniLM and
    Whisper from ``checkpoints/hf``, CLIP at ``hf/clip/config.json``'s
    geometry with ``chip_smoke.py``'s seeded weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the models are compared card against CPU")
    import json
    import os

    from fvd_tpu_torch.providers.hf_models import HFClip, HFTextEncoder, HFWhisperASR
    from fvd_tpu_torch.utils.hf_tokenizers import Tokenizer

    hf = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints", "hf")
    with open(os.path.join(hf, "clip", "config.json")) as f:
        cfg = json.load(f)
    tok = Tokenizer.from_dir(os.path.join(hf, "clip"))
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield {d: {"minilm": HFTextEncoder.from_local(os.path.join(hf, "minilm"), device=d),
                   "whisper": HFWhisperASR.from_local(os.path.join(hf, "whisper"), device=d),
                   "clip": HFClip(_chip_smoke()._seeded_clip(cfg), lambda t: tok(t, 77), 224, -0.205, 0.588235,
                                  device=d)}
               for d in ("cuda", "cpu")}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def test_hf_minilm_on_card_matches_cpu(hf_models):
    sentences = _chip_smoke()._sentences(64)
    e = {d: m["minilm"].encode_batch(sentences) for d, m in hf_models.items()}
    np.testing.assert_allclose(e["cuda"], e["cpu"], atol=_chip_smoke().HF_TOL, rtol=0)


def test_hf_clip_on_card_matches_cpu(hf_models):
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, (240, 320, 3)).astype(np.uint8) for _ in range(8)]
    texts = _chip_smoke()._sentences(8)
    s = {d: m["clip"].image_text_similarity_batch(images, texts) for d, m in hf_models.items()}
    np.testing.assert_allclose(s["cuda"], s["cpu"], atol=_chip_smoke().HF_TOL, rtol=0)


def test_hf_whisper_on_card_matches_cpu(hf_models):
    """Formant speech: tokens up to the CPU's first near-tie, teacher-forced
    logits, and the transcripts."""
    from fvd_tpu_torch.synthetic import formant_speech

    audio = np.zeros(5 * 16000, np.float32)
    speech = formant_speech("the river rose two feet", np.random.RandomState(0))
    audio[8000:8000 + len(speech)] = speech
    row = _chip_smoke()._whisper_window(hf_models["cuda"]["whisper"], hf_models["cpu"]["whisper"], audio)
    assert row["logits_max_abs_err"] <= _chip_smoke().HF_LOGIT_TOL and row["tokens"] > 5
    if row["first_near_tie_step"] is None:
        assert hf_models["cuda"]["whisper"].transcribe("", audio=audio) == \
            hf_models["cpu"]["whisper"].transcribe("", audio=audio)


def _two_clips_frames():
    """Frames of two synthetic face clips (10 fps, 320x240): 20 and 30."""
    import tempfile

    from fvd_tpu_torch.providers.media import VideoReader
    from fvd_tpu_torch.synthetic import make_face_video

    with tempfile.TemporaryDirectory() as tmp:
        out = []
        for seed, n in ((0, 20), (1, 30)):
            clip = make_face_video(tmp, f"c{seed}", duration=n / 10.0, fps=10.0, seed=seed)
            out.append(VideoReader(use_cache=False).sample(clip, range(n))[0])
    return out


def _concurrently(fns):
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(fns)) as pool:
        return [f.result(timeout=300) for f in [pool.submit(fn) for fn in fns]]


def test_vision_wrappers_on_card_match_the_unwrapped_providers(zoo):
    """The four wrappers of ``coalesce_providers`` over the card's bundle:
    two callers at once, each against the unwrapped provider on its own
    frames; the groups pad to the ladder, so only the batch differs."""
    from fvd_tpu_torch.providers.coalesce import coalesce_providers

    bundle = zoo["cuda"]
    frames = _two_clips_frames()
    dev = [torch.from_numpy(f).cuda() for f in frames]
    wrapped, close = coalesce_providers(bundle)
    try:
        assert type(wrapped.face_detector).__name__ == "CoalescingDetector"
        dets = _concurrently([lambda d=d: wrapped.face_detector.detect_batch(d) for d in dev])
        lms = _concurrently([lambda f=f, d=d: wrapped.landmarks.landmarks_batch(f, device_frames=d)
                             for f, d in zip(frames, dev)])
        ocr = _concurrently([lambda f=f, d=d: wrapped.ocr.read_text_batch_device(d[:4], list(f[:4]))
                             for f, d in zip(frames, dev)])
        texts = _chip_smoke()._sentences(4)
        sims = _concurrently([lambda f=f: wrapped.clip.image_text_similarity_batch(list(f[:4]), texts)
                              for f in frames])
    finally:
        close()
    for f, d, got_det, got_lm, got_ocr, got_sim in zip(frames, dev, dets, lms, ocr, sims):
        ref_det = bundle.face_detector.detect_batch(d)
        assert [len(x) for x in got_det] == [len(x) for x in ref_det] and sum(map(len, ref_det)) >= len(f) // 2
        for a, b in zip(got_det, ref_det):
            np.testing.assert_allclose([[x.x1, x.y1, x.x2, x.y2, x.confidence] for x in a],
                                       [[x.x1, x.y1, x.x2, x.y2, x.confidence] for x in b], atol=1e-2, rtol=0)
        ref_lm = bundle.landmarks.landmarks_batch(f, device_frames=d)
        assert [len(x) for x in got_lm] == [len(x) for x in ref_lm]
        for a, b in zip(got_lm, ref_lm):
            for pa, pb in zip(a, b):
                np.testing.assert_allclose(pa, pb, atol=1e-2, rtol=0)
        ref_ocr = bundle.ocr.read_text_batch_device(d[:4], list(f[:4]))
        assert [[x["text"] for x in r] for r in got_ocr] == [[x["text"] for x in r] for r in ref_ocr]
        np.testing.assert_allclose(got_sim, bundle.clip.image_text_similarity_batch(list(f[:4]), texts),
                                   atol=1e-5, rtol=0)


def test_train_until_correct_on_card_matches_cpu(cuda):
    from fvd_tpu_torch.ops import fusion

    rng = np.random.RandomState(0)
    feats = rng.rand(16, 9).astype(np.float32)
    labels = (rng.rand(16) > 0.5).astype(np.float32)
    w, b = (rng.randn(9) * 0.5).astype(np.float32), np.float32(0.2)
    out = {d: fusion.train_until_correct(*(torch.from_numpy(np.asarray(x)).to(d) for x in (feats, labels, w, b)))
           for d in ("cpu", cuda)}
    assert out[cuda][2].cpu().tolist() == out["cpu"][2].tolist() and sum(out["cpu"][2].tolist()) > 0
    assert float((out[cuda][0].cpu() - out["cpu"][0]).abs().max()) <= 1e-6
    assert abs(float(out[cuda][1]) - float(out["cpu"][1])) <= 1e-6


# ---------------------------------------------------------------------------
# The parallel layer on the card (fvd_tpu_torch/parallel)
# ---------------------------------------------------------------------------
def _sp_signals(n=1800, fps=30.0, seed=0):
    rng = np.random.RandomState(seed)
    t = np.linspace(0, n / fps, n)
    mouth = np.clip(0.5 * (1 + np.sin(2 * np.pi * 2 * t)) + 0.1 * rng.rand(n), 0, 1)
    return mouth.astype(np.float32), np.roll(mouth, 3).astype(np.float32)


def test_scoring_service_shards_over_card_entries(cuda):
    """Two entries of the card: one C1 launch per shard, results equal to the
    single-device CPU service's."""
    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.serving import ScoreRequest, ScoringService

    weights = {"bias": -0.3, "lip_sync": -1.2, "speech_rate": 0.4}
    rng = np.random.RandomState(3)
    reqs = [ScoreRequest(*_sp_signals(300, 30.0, seed=i), rng.rand(8).astype(np.float32)) for i in range(6)]
    card = ScoringService(weights, n=300, fps=30.0, max_batch=8, max_wait_ms=50.0, devices=[cuda, cuda])
    cpu = ScoringService(weights, n=300, fps=30.0, max_batch=8, max_wait_ms=50.0, devices=["cpu"])
    try:
        _kernels.reset_launches()
        got = [f.result(timeout=60) for f in [card.submit(r) for r in reqs]]
        launches = _kernels.LAUNCHES["lipsync_score"]
        want = [f.result(timeout=60) for f in [cpu.submit(r) for r in reqs]]
    finally:
        card.close()
        cpu.close()
    assert launches == 2 * card.batcher.batches_run
    for g, w in zip(got, want):
        assert g["lip_sync_score"] == pytest.approx(w["lip_sync_score"], abs=1e-5)
        assert g["fake_probability"] == pytest.approx(w["fake_probability"], abs=1e-6)


def test_gloo_ranks_sharing_the_card_match_one_device(cuda, tmp_path):
    """Two gloo ranks on the card (NCCL refuses two on one device): the SP
    score against the plain stage, the EP MoE against the dense oracle."""
    from fvd_tpu_torch.ops.lipsync import lip_sync_score_batch_plain
    from fvd_tpu_torch.parallel import experts, programs
    from fvd_tpu_torch.parallel.launch import RankGroup

    mouth, audio = _sp_signals()
    params = {k: v.numpy() for k, v in experts.init_moe_params(np.random.RandomState(5), 4, 16, 64).items()}
    x = np.random.RandomState(4).randn(32, 16).astype(np.float32)
    with RankGroup(2, "gloo", "cuda:0", str(tmp_path), timeout=120.0) as group:
        sp = group.run(programs.sp_lipsync, 1, 2, mouth, audio, 30.0)
        moe = group.run(programs.moe, 2, params, x)
    ref = float(lip_sync_score_batch_plain(torch.from_numpy(mouth)[None], torch.from_numpy(audio)[None], 30.0).score[0])
    assert sp[0] == sp[1] == pytest.approx(ref, abs=1e-5)
    dense = experts.moe_forward_dense({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(moe[0]["out"], dense.numpy(), atol=1e-5, rtol=0)


def test_one_nccl_rank_runs_the_dp_step(cuda, tmp_path):
    from fvd_tpu_torch.parallel import programs
    from fvd_tpu_torch.parallel.launch import RankGroup

    rng = np.random.RandomState(0)
    feats = rng.rand(16, 9).astype(np.float32)
    labels = (rng.rand(16) > 0.5).astype(np.float32)
    w0 = rng.randn(9).astype(np.float32) * 0.1
    with RankGroup(1, "nccl", "cuda:0", str(tmp_path), timeout=120.0) as group:
        got = group.run(programs.dp_lr_step, 1, feats, labels, w0, np.float32(0.2), 0.005)[0]
    p = 1 / (1 + np.exp(-(feats @ w0 + 0.2)))
    np.testing.assert_allclose(got["w"], w0 - 0.005 * feats.T @ (p - labels) / 16, atol=1e-6)
    np.testing.assert_allclose(got["probs"], p, atol=1e-6)


def test_sharded_inference_over_card_entries(cuda):
    """The SSD provider with its frames split over two entries of the card
    gives the single-device detections."""
    import os

    from fvd_tpu_torch.models.face_ssd import SSDFaceDetector
    from fvd_tpu_torch.parallel.inference import set_inference_mesh
    from fvd_tpu_torch.parallel.mesh import make_mesh

    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints", "face_ssd.npz")
    frames = np.random.RandomState(0).randint(0, 255, (16, 96, 128, 3)).astype(np.uint8)
    det = SSDFaceDetector(ckpt, compute_dtype=torch.float32, device=cuda)
    # f32 without TF32: cuDNN picks its algorithm by batch size, and TF32's
    # rounding would move scores near NMS's threshold
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    prev = set_inference_mesh(None)
    try:
        base = det.detect_batch(frames)
        set_inference_mesh(make_mesh(n_data=2, n_time=1, devices=[cuda, cuda]))
        sharded = det.detect_batch(frames)
    finally:
        set_inference_mesh(prev)
        torch.backends.cudnn.allow_tf32 = tf32
    for b_dets, s_dets in zip(base, sharded):
        assert len(b_dets) == len(s_dets)
        for b, s in zip(b_dets, s_dets):
            np.testing.assert_allclose([b.x1, b.y1, b.x2, b.y2, b.confidence],
                                       [s.x1, s.y1, s.x2, s.y2, s.confidence], atol=2e-3, rtol=0)


def _gloo_collective(name):
    """One gloo collective on card tensors (a rank program: this module
    imports no JAX)."""
    import torch.distributed as dist

    from fvd_tpu_torch.parallel.launch import rank_device

    dev, r, n = rank_device(), dist.get_rank(), dist.get_world_size()
    t = torch.ones(4, device=dev)
    if name == "all_reduce":
        dist.all_reduce(t)
    elif name == "all_gather":
        dist.all_gather_into_tensor(torch.empty(4 * n, device=dev), t)
    elif name == "p2p":
        ops = [dist.P2POp(dist.isend, t, (r + 1) % n), dist.P2POp(dist.irecv, torch.empty_like(t), (r - 1) % n)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    elif name == "all_to_all":
        dist.all_to_all([torch.empty(2, device=dev) for _ in range(n)], [torch.ones(2, device=dev) for _ in range(n)])
    torch.cuda.synchronize()
    return float(t.sum())


@pytest.mark.parametrize("name,takes", [("all_reduce", True), ("all_gather", True), ("p2p", False),
                                        ("all_to_all", False)])
def test_gloo_collectives_on_card_tensors(cuda, tmp_path, name, takes):
    """Which gloo collectives take card tensors as they are (those that do
    not are why ``parallel/mesh.py`` copies through host memory on gloo)."""
    from fvd_tpu_torch.parallel.launch import RankGroup

    group = RankGroup(2, "gloo", "cuda:0", str(tmp_path), timeout=60.0)
    try:
        if takes:
            want = 8.0 if name == "all_reduce" else 4.0   # the sum over 2 ranks, or the tensor as it was
            assert group.run(_gloo_collective, name) == [want, want]
        else:
            with pytest.raises(RuntimeError):
                group.run(_gloo_collective, name)
    finally:
        group.close()


# ------------------------------------------------------------ the trainers
def _train_step(name, device, dtype, batch):
    """One Adam step of the tool's trainer ``name`` at width 32 from the
    seeded weights -> (loss, {param: grad}, {param: value after})."""
    from fvd_tpu_torch import weights
    from fvd_tpu_torch.models import face_ssd, landmarks_fan
    from fvd_tpu_torch.models.layers import adam, adam_step

    net, loss_fn = {"det": (face_ssd.FaceSSD, face_ssd.ssd_loss),
                    "lmk": (landmarks_fan.LandmarkHourglass, landmarks_fan.landmark_loss),
                    "pose": (landmarks_fan.PoseHead, landmarks_fan.pose_loss)}[name]
    model = weights.seeded(net(32), 0).to(device, dtype)
    opt = adam(model)
    loss = adam_step(loss_fn, model, opt, *(torch.as_tensor(np.asarray(x), dtype=dtype, device=device) for x in batch))
    return (float(loss), {k: p.grad.cpu() for k, p in model.named_parameters()},
            {k: p.detach().cpu() for k, p in model.named_parameters()})


def _train_batch(name):
    from fvd_tpu_torch.models.synthetic_faces import detector_batch, landmark_batch
    from fvd_tpu_torch.models.synthetic_pose import pose_batch

    rng = np.random.RandomState(0)
    return {"det": lambda: detector_batch(rng, 4)[:3], "lmk": lambda: landmark_batch(rng, 4),
            "pose": lambda: pose_batch(rng, 4)[:2]}[name]()


@pytest.mark.parametrize("name", ["det", "lmk", "pose"])
def test_train_step_on_card_matches_cpu(cuda, name):
    """One train step at width 32 on the card against the CPU: the float32
    loss within 1e-4 (TF32 off), and in float64 the loss, every gradient and
    every updated parameter within 1e-8 relative L2 (the bars of
    ``chip_smoke.py``'s train phase; the heatmap bias's gradient is zero)."""
    batch = _train_batch(name)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card, cpu = (_train_step(name, d, torch.float32, batch) for d in (cuda, "cpu"))
        assert abs(card[0] - cpu[0]) <= 1e-4 * abs(cpu[0])
        card, cpu = (_train_step(name, d, torch.float64, batch) for d in (cuda, "cpu"))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(card[0] - cpu[0]) <= 1e-8 * abs(cpu[0])
    for k in cpu[1]:
        if name == "lmk" and k == "Conv_1.bias":
            continue
        for a, b in ((card[1][k], cpu[1][k]), (card[2][k], cpu[2][k])):
            diff, ref = float((a - b).norm()), float(b.norm())
            assert diff <= 1e-8 * ref, (k, diff, ref)


def test_in_dtype_follows_an_optimizer_step_on_card(cuda):
    """The bf16 copy ``in_dtype`` keeps is cast again after Adam's default
    (foreach) update on the card."""
    from fvd_tpu_torch import weights
    from fvd_tpu_torch.models import landmarks_fan

    model = weights.seeded(landmarks_fan.LandmarkHourglass(16), 0).to(cuda)
    crops = torch.from_numpy((np.random.RandomState(0).rand(2, 128, 128, 3) * 255).astype(np.uint8)).to(cuda)
    before = landmarks_fan.landmarks_forward(model, crops)
    step, init_opt = landmarks_fan.make_landmark_train_step(lr=1e-2)
    step(model, init_opt(model), crops.float() / 255.0, torch.rand(2, 68, 2, device=cuda))
    after = landmarks_fan.landmarks_forward(model, crops)
    clone = landmarks_fan.LandmarkHourglass(16).to(cuda)
    clone.load_state_dict(model.state_dict())
    assert float((after - before).abs().max()) > 1e-3
    torch.testing.assert_close(after, landmarks_fan.landmarks_forward(clone, crops), rtol=0, atol=0)


# ------------------------------------------ the networked services, the zoo
def test_networked_services_on_card_match_the_scripted(cuda):
    """``chip_smoke.py``'s net phase: the DAG on the card with the OpenAI LLM
    and the cached search chain on a loopback server, against the scripted
    LLM and search (the same decisions, |dp| <= 1e-6, one C1 launch for
    each of its four DAG runs)."""
    cs = _chip_smoke()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        assert cs.net_phase() == cs.NET_RUNS == 4
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.fixture(scope="module")
def zoo_train_batches():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the losses are compared card against CPU")
    return _chip_smoke()._zoo_train_batches()


@pytest.mark.parametrize("name", ["asr", "text", "clip", "ctc"])
def test_zoo_train_step_on_card_matches_cpu(zoo_train_batches, name):
    """One Adam step of ``asr_loss``, the text InfoNCE, ``clip_loss`` and
    ``ctc_loss`` at the shipped geometries on the card against the CPU: the
    float32 loss within 1e-4 (TF32 off), and in float64 the loss, every
    gradient and every updated parameter within 1e-8 relative L2 (the key
    projections' biases have a zero gradient and are left out)."""
    cs = _chip_smoke()
    batch = zoo_train_batches[name][:1]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card, cpu = (cs._zoo_train_run(name, batch, d, torch.float32) for d in ("cuda", "cpu"))
        assert abs(card[0][0] - cpu[0][0]) <= 1e-4 * abs(cpu[0][0])
        card, cpu = (cs._zoo_train_run(name, batch, d, torch.float64) for d in ("cuda", "cpu"))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(card[0][0] - cpu[0][0]) <= 1e-8 * abs(cpu[0][0])
    skip = tuple(k for k in cpu[1] if k.endswith("key.bias"))
    for side in (1, 2):
        assert cs._worst_rel(card[side], cpu[side], skip)[0] <= 1e-8


# ------------------------------------------------- the labeled-corpus levers
def test_texture_noise_clip_on_card_matches_cpu(cuda, tmp_path):
    """``chip_smoke.py``'s corpus phase (c) on one clip: a ``texture_noise``
    fake of the labeled corpus through the production bundle's 16 nodes,
    card f32 against CPU f32 within the batch phase's bars (features 1e-4,
    probability 1e-5, the same decisions), one C1 launch on the card."""
    import os

    from fvd_tpu_torch.providers.factory import production_providers
    from fvd_tpu_torch.tools.make_labeled_corpus import FAKE_RECIPES, SENTENCES, corpus_speech, write_clip

    cs = _chip_smoke()
    ckpt = os.path.join(cs.REPO, "checkpoints")
    clip = write_clip(str(tmp_path / "videos"), "texture_deepfake", corpus_speech(), duration=3.0, fps=30.0,
                      seed=602, speech_text=SENTENCES[1], **FAKE_RECIPES[1])
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {d: cs._batch_run(production_providers(ckpt, device=d, compute_dtype=torch.float32,
                                                      recorded_services=True), [clip], str(tmp_path / d), d, 1)
                for d in ("cuda", "cpu")}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert runs["cuda"]["launches"] == 1
    cs._batch_compare(runs["cuda"]["finals"], runs["cpu"]["finals"], "texture_noise clip, card vs CPU")


# ------------------------------------------------- the OCR and CLIP trainers
@pytest.mark.parametrize("name", ["rec", "det_v2"])
def test_text_train_step_on_card_matches_cpu(cuda, name):
    """One Adam step of the recognizer's ``ctc_loss`` (width 32, batch 32)
    and the v2 detector's BCE (width 32, batch 8, computing in float64) on
    ``chip_smoke.py``'s text batches, card against CPU in float64: the loss,
    every gradient and every updated parameter within 1e-8 relative L2."""
    cs = _chip_smoke()
    batch = cs._text_train_batches((name,))[name][:1]
    card, cpu = (cs._text_train_run(name, batch, d, torch.float64) for d in ("cuda", "cpu"))
    assert abs(card[0][0] - cpu[0][0]) <= cs.TRAIN_F64_TOL * abs(cpu[0][0])
    for side in (1, 2):
        assert cs._worst_rel(card[side], cpu[side])[0] <= cs.TRAIN_F64_TOL


def test_eval_ocr_det_on_card_matches_cpu(cuda):
    """``eval_heldout.eval_ocr_det`` at n 4 on the shipped v2 detector:
    the card's mask IoUs within the text phase's bar of the CPU's."""
    from fvd_tpu_torch.tools.eval_heldout import eval_ocr_det

    cs = _chip_smoke()
    card, cpu = eval_ocr_det(4, device="cuda"), eval_ocr_det(4, device="cpu")
    for k in ("in_domain", "held_out"):
        assert np.isfinite(card[k]) and abs(card[k] - cpu[k]) <= cs.TEXT_EVAL_IOU_TOL, (k, card[k], cpu[k])


def test_diagnose_det_row_on_card_matches_cpu(cuda):
    """``diagnose_det_heldout``'s all-factors row (``render_factored``'s
    frames, n 8) on the shipped detector in float32, card (TF32 off)
    against CPU within ``chip_smoke.DIAGNOSE_TOL``."""
    from fvd_tpu_torch import weights
    from fvd_tpu_torch.models import face_ssd
    from fvd_tpu_torch.tools import diagnose_det_heldout as dd
    from fvd_tpu_torch.tools.eval_heldout import CKPT

    cs = _chip_smoke()
    frames, gts = dd.case_frames(8, dict(dd.CASES)["ALL (held-out-like)"])
    params = weights.read_npz(f"{CKPT}/face_ssd.npz")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = dd.mean_iou(face_ssd.from_params(params, cuda), frames, gts, torch.float32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = dd.mean_iou(face_ssd.from_params(params, "cpu"), frames, gts, torch.float32)
    assert np.isfinite(card) and abs(card - cpu) <= cs.DIAGNOSE_TOL["det"], (card, cpu)


# -------------------------------------------- the FAN trainer, PoseResNet50
def test_fan_train_step_on_card_matches_cpu(cuda):
    """Three steps of ``pretrain_fan``'s loss and clipped AdamW at width 32
    and 2 stacks on ``chip_smoke.py``'s batches of the tool's 256-px crops,
    card against CPU in float64: the losses, the first step's clipped
    gradients and the last parameters within 1e-8 relative L2 per tensor
    (the tensors whose gradient is zero in exact arithmetic held at zero)."""
    cs = _chip_smoke()
    out = cs._train_parity(cs._fan_batches(), run=cs._fan_train_run, tags=("f64",), zero_grad=cs._tiny_grads)
    assert max(out["fan"]["f64"]["loss_rel"]) <= cs.TRAIN_F64_TOL


def test_pose50_on_card_matches_cpu(cuda):
    """``PoseResNet50`` from seeded weights on two 224-px crops, card f32
    (TF32 off) against CPU f32 within ``chip_smoke.POSE50_TOL``."""
    cs = _chip_smoke()
    crops = np.random.RandomState(1).rand(2, 224, 224, 3).astype(np.float32)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, card = cs._pose50_outputs(cuda, None, crops)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    _, cpu = cs._pose50_outputs("cpu", None, crops)
    assert np.abs(card - cpu).max() <= cs.POSE50_TOL


# ------------------------------------------------------------ the HF trainers
@pytest.mark.parametrize("name", ["minilm", "clip", "whisper"])
def test_hf_train_step_on_card_matches_cpu(cuda, tmp_path, name):
    """One step of each HF tool's loss and clipped AdamW at ``chip_smoke.py``'s
    small geometries (BERT 2 x 64, CLIP ``--tiny``, Whisper d64 2 + 2) on
    its batches, card against CPU in float64: the loss, every gradient and
    every updated parameter within 1e-8 relative L2 (the tensors whose
    gradient is zero in exact arithmetic held at zero)."""
    cs = _chip_smoke()
    cases = cs._hf_parity_cases(str(tmp_path))
    out = cs._train_parity({name: cases[name][2][:1]}, run=cs._hf_train_run, tags=("f64",),
                           zero_grad=cs._tiny_grads)
    assert max(out[name]["f64"]["loss_rel"]) <= cs.TRAIN_F64_TOL


def test_whisper_canvas_batch_on_card_matches_cpu(cuda):
    """``compose_canvas_batch`` of a pool of phrase tiles on the card (the
    scatter-add into ``[B, 1 + 3000 + F, 80]``, atomics included) against
    the CPU: unused slots, clipped offsets and overlapping tiles."""
    from fvd_tpu_torch.ops.whisper_frontend import compose_canvas_batch, mel_filter_bank, phrase_power_mel

    rng = np.random.RandomState(0)
    audio = torch.from_numpy((rng.randn(6, 104 * 160) * 0.1).astype(np.float32))
    mel = torch.from_numpy(mel_filter_bank().astype(np.float32))
    idx = torch.tensor([[0, 1, 2, -1, 5], [3, 4, -1, -1, -1], [5, 5, 0, 1, 2]])
    off = torch.tensor([[0, 100, 3100, 5, 2999], [-5, 2990, 0, 0, 0], [7, 87, 180, 260, 3000]])
    out = {}
    for d in (cuda, torch.device("cpu")):
        pool = phrase_power_mel(audio.to(d), mel.to(d))
        out[d.type] = (pool.cpu(), compose_canvas_batch(pool, idx.to(d), off.to(d)).cpu())
    assert torch.allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-6 * float(out["cpu"][0].abs().max()))
    assert float((out["cuda"][1] - out["cpu"][1]).abs().max()) <= 1e-4


def _mpeg4_gop(tmp_path, w=320, h=240, n=24):
    """Two GOPs of parsed VOPs of a moving texture written by the port's
    encoder (I-VOPs and P-VOPs with not_coded macroblocks), and the frames,
    for the decode kernels."""
    from fvd_tpu_torch.providers import native_decode as tnd

    rng = np.random.RandomState(3)
    base = rng.randint(0, 256, (h + n, w + 2 * n, 3)).astype(np.float32)
    for _ in range(4):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    frames = np.stack([base[t // 3:t // 3 + h, 2 * t:2 * t + w] for t in range(n)]).astype(np.uint8)
    path = str(tmp_path / "gop.mp4")
    tnd.write_mp4v(path, frames, 30.0, device="cpu")
    from fvd_tpu_torch.ops import mpeg4 as tops

    rng = tops.parse_vops(*_parse_inputs(path), "cpu")
    geo = tops.Geometry(w, h)
    return [rng.vop(i, geo) for i in range(len(rng))], frames, geo


def test_mpeg4_kernels_match_plain_over_a_gop(cuda, tmp_path):
    """mpeg4_recon and yuv420_rgb against their plain versions, bit for bit,
    on every VOP of a GOP and a half, each VOP predicted from the kernel's own
    previous frame; one launch per VOP and per frame."""
    from fvd_tpu_torch.ops import mpeg4 as tops

    vops, _, geo = _mpeg4_gop(tmp_path)
    ref_k = ref_p = None
    before = dict(_kernels.LAUNCHES)
    for v in vops:
        args = [torch.from_numpy(a) for a in (v.levels, v.qscale, v.intra, v.mv, v.coded)]
        pred = None if v.kind == "I" else ref_k
        out_k = tops.reconstruct_vop(*[a.to(cuda) for a in args], pred, v.rounding, geo)
        out_p = tops.reconstruct_vop_plain(*args, None if v.kind == "I" else ref_p, v.rounding, geo)
        assert torch.equal(out_k.cpu(), out_p)
        ref_k, ref_p = out_k, out_p
        assert torch.equal(tops.yuv420_to_rgb(out_k, geo).cpu(),
                           tops.yuv420_to_rgb_plain(out_p[None], geo)[0])
    assert _kernels.LAUNCHES["mpeg4_recon"] - before["mpeg4_recon"] == len(vops)
    assert _kernels.LAUNCHES["yuv420_rgb"] - before["yuv420_rgb"] == len(vops)


@pytest.mark.parametrize("w,h", [(320, 240), (72, 40)])
def test_mpeg4_forward_matches_plain(cuda, tmp_path, w, h):
    """mpeg4_forward against its plain version, bit for bit, for an I-VOP and
    a P-VOP, at an aligned size and at one the macroblocks overhang."""
    from fvd_tpu_torch.ops import mpeg4 as tops

    rng = np.random.RandomState(w)
    geo = tops.Geometry(w, h)
    rgb = torch.from_numpy(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    ref = torch.from_numpy(rng.randint(0, 256, geo.frame_bytes).astype(np.uint8))
    for r in (None, ref):
        got = tops.forward_vop(rgb.to(cuda), None if r is None else r.to(cuda), 3, geo)
        assert torch.equal(got.cpu(), tops.forward_vop_plain(rgb, r, 3, geo))


def test_mpeg4_file_on_card_matches_cpu(cuda, tmp_path):
    """The whole codec on the card against the CPU: the same file bytes from
    the encoder, the same frames from the decoder."""
    from fvd_tpu_torch.providers import native_decode as tnd

    _, frames, _ = _mpeg4_gop(tmp_path)
    a, b = str(tmp_path / "card.mp4"), str(tmp_path / "cpu.mp4")
    tnd.write_mp4v(a, frames, 30.0, device=cuda)
    tnd.write_mp4v(b, frames, 30.0, device="cpu")
    assert open(a, "rb").read() == open(b, "rb").read()
    with tnd.NativeVideo(a, device=cuda) as v, tnd.NativeVideo(a, device="cpu") as c:
        np.testing.assert_array_equal(v.read_frames(range(len(frames)))[0],
                                      c.read_frames(range(len(frames)))[0])


def _nv12_surface(flat, geo, pitch, top=0, left=0):
    """A flat YUV 4:2:0 frame laid out as an NV12 surface ``pitch`` bytes
    wide, its picture ``top`` rows and ``left`` columns in (both even)."""
    h, w = geo.luma
    rows = h + top
    surface = torch.full((rows + rows // 2, pitch), 200, dtype=torch.uint8)
    surface[top:top + h, left:left + w] = flat[:h * w].reshape(h, w)
    uv = surface[rows + top // 2:rows + top // 2 + h // 2, left:left + w]
    uv[:, 0::2] = flat[h * w:h * w * 5 // 4].reshape(h // 2, w // 2)
    uv[:, 1::2] = flat[h * w * 5 // 4:].reshape(h // 2, w // 2)
    return surface, rows


@pytest.mark.parametrize("w,h,pitch,top,left", [(320, 240, 512, 0, 0), (320, 180, 384, 4, 32), (72, 40, 128, 0, 8)])
def test_nv12_rgb_matches_plain(cuda, w, h, pitch, top, left):
    """nv12_rgb against its plain version and against yuv420_to_rgb_plain of
    the same samples, bit for bit, at a pitch wider than the picture and from
    an offset (a surface's display rectangle); luma below 16 included."""
    from fvd_tpu_torch.ops import mpeg4 as tops

    geo = tops.Geometry(w, h)
    flat = torch.from_numpy(np.random.RandomState(w + h).randint(0, 256, geo.frame_bytes).astype(np.uint8))
    surface, rows = _nv12_surface(flat, geo, pitch, top, left)
    luma, uv = surface[top:rows, left:], surface[rows + top // 2:, left:]
    dev = surface.to(cuda)
    before = _kernels.LAUNCHES["nv12_rgb"]
    got = tops.nv12_to_rgb(dev[top:rows, left:], dev[rows + top // 2:, left:], w, h)
    assert _kernels.LAUNCHES["nv12_rgb"] == before + 1
    want = tops.yuv420_to_rgb_plain(flat[None], geo)[0]
    assert torch.equal(got.cpu(), want)
    assert torch.equal(tops.nv12_to_rgb_plain(luma, uv, w, h), want)
    assert torch.equal(tops.nv12_to_rgb_plain(dev[top:rows, left:], dev[rows + top // 2:, left:], w, h).cpu(), want)


@pytest.fixture
def nvdec_caps(cuda):
    """The card's NVDEC capabilities for H.264, or a skip in the one state
    that the machine causes (``out_of_reach``: CUresult 2 in a container
    without NVIDIA's video capability); any other failure, or a card that
    does not decode H.264 4:2:0 8-bit, fails."""
    from fvd_tpu_torch.providers import nvdec as tnv

    try:
        caps = tnv.decoder_caps(cuda)
    except RuntimeError as e:
        if not tnv.out_of_reach(e):
            raise
        pytest.skip(f"NVDEC is out of reach on this machine: {e}")
    assert caps["supported"] == 1, caps
    return caps


@pytest.mark.parametrize("h,pattern", [(240, "IBPBPBPPIBPP"), (180, "IPBPIBPP")])
def test_nvdec_decodes_known_answer_streams(nvdec_caps, tmp_path, h, pattern):
    """NVDEC and nv12_rgb give the known-answer writer's frames bit for bit,
    in display order: B pictures reordered, a cropped height, still P
    pictures of P_Skip runs; one nv12_rgb launch a frame."""
    from fvd_tpu_torch.providers import nvdec as tnv
    from fvd_tpu_torch.utils import h264_pcm

    rng = np.random.RandomState(h)
    frames = rng.randint(0, 256, (len(pattern), h, 320, 3)).astype(np.uint8)
    frames[5] = frames[4]
    path = str(tmp_path / "v.mp4")
    expect = h264_pcm.write_pcm_h264(path, frames, 30.0, pattern)
    before = _kernels.LAUNCHES["nv12_rgb"]
    with tnv.NvdecVideo(path, device="cuda") as v:
        got, kept = v.read_frames(range(len(pattern)))
    assert kept == list(range(len(pattern)))
    np.testing.assert_array_equal(got, expect)
    assert _kernels.LAUNCHES["nv12_rgb"] - before == len(pattern)


def test_nvdec_fails_without_fallback(cuda, tmp_path):
    """No fallback on the card: where NVDEC answers, a stream wider than it
    decodes raises naming NVDEC; where it is out of reach, the first read
    raises naming NVDEC and the reason."""
    from fvd_tpu_torch.providers import nvdec as tnv
    from fvd_tpu_torch.utils import h264_pcm
    from fvd_tpu_torch.utils.avi import UnsupportedVideo

    path = str(tmp_path / "wide.mp4")
    h264_pcm.write_pcm_h264(path, np.zeros((2, 32, 4112, 3), np.uint8), 30.0)
    try:
        tnv.decoder_caps(cuda)
        expected = UnsupportedVideo
    except RuntimeError as e:
        if not tnv.out_of_reach(e):
            raise
        expected = tnv.NvdecError
    with tnv.NvdecVideo(path, device="cuda") as v:
        with pytest.raises(expected, match="NVDEC") as raised:
            v.read_frames([0, 1])
    assert expected is UnsupportedVideo or tnv.out_of_reach(raised.value)


def _parse_inputs(path):
    """Every sample of ``path`` as ``parse_vops``' inputs."""
    from fvd_tpu_torch.utils import mp4, mpeg4v

    data = open(path, "rb").read()
    track = mp4.parse(path, data)
    return mpeg4v.scan_samples([data[o:o + n] for o, n in zip(track.offsets, track.sizes)],
                               mpeg4v.find_vol(track.config))


@pytest.mark.parametrize("source", ["ka_64x48", "ka_96x64", "encoder_320x240"])
def test_mpeg4_parse_matches_plain(cuda, tmp_path, source):
    """mpeg4_parse against the host parser, bit for bit, on every VOP of a
    known-answer stream (every syntax path) and of the port's encoder's
    file: one launch a range."""
    from fvd_tpu_torch.ops import mpeg4 as tops
    from fvd_tpu_torch.providers import native_decode as tnd
    from fvd_tpu_torch.utils import mpeg4v_ka

    path = str(tmp_path / "s.mp4")
    if source.startswith("ka"):
        w, h = (int(v) for v in source[3:].split("x"))
        mpeg4v_ka.write_mp4(path, w, h, 10.0, mpeg4v_ka.covering_stream(w, h, 14, seed=w))
    else:
        frames = np.random.RandomState(0).randint(0, 256, (14, 240, 320, 3)).astype(np.uint8)
        tnd.write_mp4v(path, frames, 30.0, device="cpu")
    args = _parse_inputs(path)
    before = _kernels.LAUNCHES["mpeg4_parse"]
    got = tops.parse_vops(*args, device=cuda)
    assert _kernels.LAUNCHES["mpeg4_parse"] - before == 1
    plain = tops.parse_vops_plain(*args)
    assert got.kinds == plain.kinds and got.rounding == plain.rounding
    assert torch.equal(got.packed.cpu(), plain.packed)


def test_mpeg4_parse_reports_the_host_parsers_errors(cuda):
    """Each fault of ``tests/test_torch_mpeg4_parse.py``'s list: the kernel
    raises the host parser's message, bit position included."""
    from test_torch_mpeg4_parse import BROKEN, _broken
    from fvd_tpu_torch.ops import mpeg4 as tops
    from fvd_tpu_torch.utils import mpeg4v
    from fvd_tpu_torch.utils.avi import UnsupportedVideo

    vol = mpeg4v.find_vol(mpeg4v.write_headers(32, 32, 10))
    for _, body, message in BROKEN:
        sample = _broken(vol, lambda w: body(w, vol))
        args = (sample, [(0, 4, len(sample))], [0], [vol])
        with pytest.raises(UnsupportedVideo, match=message) as plain:
            tops.parse_vops(*args, device="cpu")
        with pytest.raises(UnsupportedVideo) as card:
            tops.parse_vops(*args, device=cuda)
        assert str(card.value) == str(plain.value)


def test_card_session_never_parses_in_python(cuda, tmp_path, monkeypatch):
    """A session on the card reads a known-answer file to the CPU
    session's frames with the host parser disabled."""
    from fvd_tpu_torch.providers import native_decode as tnd
    from fvd_tpu_torch.utils import mpeg4v, mpeg4v_ka

    path = str(tmp_path / "ka.mp4")
    mpeg4v_ka.write_mp4(path, 64, 48, 10.0, mpeg4v_ka.covering_stream(64, 48, 12))
    with tnd.NativeVideo(path, device="cpu") as v:
        want, kept = v.read_frames(range(12))

    def refuse(*a, **k):
        raise AssertionError("the host parser ran in a card session")

    monkeypatch.setattr(mpeg4v.Decoder, "_vop", refuse)
    before = _kernels.LAUNCHES["mpeg4_parse"]
    with tnd.NativeVideo(path, device=cuda) as v:
        got, kept_c = v.read_frames(range(12))
    assert kept_c == kept and np.array_equal(got, want)
    assert _kernels.LAUNCHES["mpeg4_parse"] - before >= 1


def _aac_spectra(channels, rate, n=20, seed=0):
    from fvd_tpu_torch.utils import aac, aac_tables, aac_writer

    frames = aac_writer.covering_frames(channels, rate, n=n, seed=seed)
    index = aac_tables.SAMPLE_RATES.index(rate)
    units = [aac_writer.write_frame(f, index) for f in frames]
    spectra = aac.decode(aac.parse_asc(aac_writer.audio_specific_config(rate, channels)), units)
    meta = np.stack([spectra.sequence, spectra.shape, spectra.prev_sequence, spectra.prev_shape])
    return torch.from_numpy(spectra.coef), torch.from_numpy(meta)


@pytest.mark.parametrize("channels,rate", [(1, 44100), (2, 48000)])
def test_aac_synth_matches_plain(cuda, channels, rate):
    """aac_synth (float64 sums) against the float64 plain synthesis over
    every window sequence and shape: within 1e-6 (a few float32 steps at
    the signal's scale), one launch."""
    from fvd_tpu_torch.ops import aac as taac

    coef, meta = _aac_spectra(channels, rate)
    before = _kernels.LAUNCHES["aac_synth"]
    got = taac.imdct_synth(coef.to(cuda), meta.to(cuda)).cpu()
    assert _kernels.LAUNCHES["aac_synth"] - before == 1
    want = taac.imdct_synth(coef, meta)
    assert got.shape == want.shape and float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("channels,rate", [(2, 48000), (1, 22050), (2, 44100), (1, 8000)])
def test_audio_resample_matches_plain(cuda, channels, rate):
    from fvd_tpu_torch.ops import aac as taac

    x = torch.from_numpy(np.random.RandomState(rate).uniform(-0.5, 0.5, (channels, 30000)).astype(np.float32))
    before = _kernels.LAUNCHES["audio_resample"]
    got = taac.resample(x.to(cuda)[:, 100:], rate, 44100).cpu()
    assert _kernels.LAUNCHES["audio_resample"] - before == 1
    want = taac.resample(x[:, 100:].contiguous(), rate, 44100)
    assert got.shape == want.shape and float((got - want).abs().max()) <= 1e-6


def test_aac_track_on_card_matches_cpu(cuda, tmp_path):
    from fvd_tpu_torch.providers import native_decode as tnd
    from fvd_tpu_torch.utils import aac_tables, aac_writer

    frames = aac_writer.covering_frames(2, 48000, n=16, seed=9)
    units = [aac_writer.write_frame(f, aac_tables.SAMPLE_RATES.index(48000)) for f in frames]
    path = str(tmp_path / "a.mp4")
    tnd.write_mp4v(path, np.zeros((3, 16, 16, 3), np.uint8), 10.0, device="cpu",
                   audio=(aac_writer.audio_specific_config(48000, 2), 48000, 2, units, 1024))
    with tnd.NativeVideo(path, device="cpu") as v:
        want = v.extract_audio(44100)
    with tnd.NativeVideo(path, device=cuda) as v:
        got = v.extract_audio(44100)
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-6
