"""The port's vision wrappers of ``providers/coalesce.py`` (detector,
landmarks, OCR, CLIP) and ``coalesce_providers``, mirroring the wrapper
cases of ``tests/test_coalesce.py``: grouping, the pad ladder, splits back
to each caller, oversize, errors reaching every caller, incompatible shapes
grouped apart, only device models wrapped, idempotence and the env
overrides; then ``CoalescingClip`` over the port's two CLIPs (the npz
``JaxClip`` on ``clip.npz`` and ``HFClip`` at a small seeded geometry)
against the unwrapped providers.  Device tensors are CPU tensors here."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from fvd_tpu.providers.coalesce import _pad_target as j_pad_target
from fvd_tpu_torch.providers import Providers
from fvd_tpu_torch.providers import coalesce
from fvd_tpu_torch.providers.coalesce import (
    CoalescingClip,
    CoalescingDetector,
    CoalescingLandmarks,
    CoalescingOCR,
    coalesce_providers,
)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
#: a coalesced CLIP group against the same pairs alone, float32 on the CPU:
#: only the batch a row rides in differs
CLIP_TOL = 1e-6


class FakeLandmarks:
    """Host-path landmark provider: the landmark value encodes the source
    pixel, so callers can verify they got THEIR frames' results back."""

    model_name = "fake_lm"
    accepts_device_frames = False

    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()

    def landmarks_batch(self, frames, device_frames=None):
        with self.lock:
            self.calls.append(len(frames))
        return [[np.full((68, 2), float(f[0, 0, 0]))] for f in frames]

    def pose_batch(self, crops):
        return np.zeros((len(crops), 3))


class FakeDeviceLandmarks(FakeLandmarks):
    """Device-path provider: reads pixels from the device tensor (the host
    array is a zero-copy shape proxy, as with the real FANLandmarks)."""

    accepts_device_frames = True

    def landmarks_batch(self, frames, device_frames=None):
        with self.lock:
            self.calls.append(len(frames))
        assert torch.is_tensor(device_frames) and len(device_frames) == len(frames)
        return [[np.full((68, 2), float(d[0, 0, 0]))] for d in device_frames.numpy()]

    def pose_boxes_batch(self, device_frames, boxes, owners):
        dev = device_frames.numpy()
        return np.stack([np.array([float(dev[o][0, 0, 0]), 0.0, 0.0]) for o in owners])

    def landmarks_pose_batch(self, frames, device_frames=None, pose_pad=0.0):
        with self.lock:
            self.calls.append(len(frames))
        assert torch.is_tensor(device_frames)
        dev = device_frames.numpy()
        lm = [[np.full((68, 2), float(d[0, 0, 0]))] for d in dev]
        poses = [[np.array([float(d[0, 0, 0]), pose_pad, 0.0])] for d in dev]
        return lm, poses


class FakeDetector:
    model_name = "fake_det"
    accepts_device_frames = False

    def __init__(self):
        self.calls = []
        self.kinds = []

    def detect_batch(self, frames):
        self.calls.append(len(frames))
        self.kinds.append(type(frames).__name__)
        return [[("box", float(f[0, 0, 0]))] for f in np.asarray(frames)]


class FakeDeviceDetector(FakeDetector):
    accepts_device_frames = True


class FakeOCR:
    model_name = "fake_ocr"
    coalescable = True

    def __init__(self):
        self.calls = []

    def read_text_batch(self, images):
        self.calls.append(len(images))
        return [[{"text": str(int(im[0, 0, 0])), "confidence": 1.0}] if im[0, 0, 0] else [] for im in images]


class FakeDeviceOCR(FakeOCR):
    def read_text_batch_device(self, dev_frames, images):
        self.calls.append((len(dev_frames), len(images)))
        assert torch.is_tensor(dev_frames) and len(dev_frames) == len(images)
        return [[{"text": str(int(d[0, 0, 0])), "confidence": 1.0}] if d[0, 0, 0] else []
                for d in dev_frames.numpy()]


class FakeClip:
    model_name = "fake_clip"
    coalescable = True

    def __init__(self):
        self.calls = []

    def image_text_similarity_batch(self, images, texts):
        self.calls.append(len(images))
        return np.array([float(im[0, 0, 0]) / 100.0 for im in images])


def _submit_concurrently(fns):
    results = [None] * len(fns)
    errs = []

    def run(i):
        try:
            results[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return results, errs


@pytest.mark.parametrize("total,bucket", [(1, 256), (30, 256), (33, 256), (150, 256), (256, 256), (300, 256),
                                          (5, 16), (22, 64), (512, 512), (0, 32)])
def test_pad_target_ladder_matches_jax(total, bucket):
    assert coalesce._pad_target(total, bucket) == j_pad_target(total, bucket)


def test_concat_pad_device_and_host():
    a, b = torch.full((3, 2, 2, 3), 4, dtype=torch.uint8), torch.full((2, 2, 2, 3), 9, dtype=torch.uint8)
    cat = coalesce._concat_pad_device([a, b], 8)
    assert cat.shape == (8, 2, 2, 3) and cat.dtype == torch.uint8 and cat.device == a.device
    assert cat[:3].eq(4).all() and cat[3:5].eq(9).all() and cat[5:].eq(0).all()
    assert coalesce._concat_pad_device([a], 3) is a
    host = coalesce._concat_pad_host([a.numpy(), b.numpy()], 4)  # pad below total: exact
    assert host.shape == (5, 2, 2, 3) and (host[3:] == 9).all()
    assert coalesce._shape_hw(a) == coalesce._shape_hw(a.numpy()) == (2, 2)


def test_landmarks_coalesce_host_path():
    inner = FakeLandmarks()
    co = CoalescingLandmarks(inner, bucket_frames=64, max_wait_ms=80.0)
    try:
        a = np.full((10, 8, 8, 3), 7, np.uint8)
        b = np.full((12, 8, 8, 3), 9, np.uint8)
        (ra, rb), errs = _submit_concurrently([lambda: co.landmarks_batch(a), lambda: co.landmarks_batch(b)])
        assert not errs
        # one merged inner call, padded to the next power-of-two rung (22 -> 32)
        assert inner.calls == [32]
        assert len(ra) == 10 and len(rb) == 12
        assert all(lm[0][0, 0] == 7.0 for lm in ra)
        assert all(lm[0][0, 0] == 9.0 for lm in rb)
    finally:
        co.close()


def test_landmarks_coalesce_device_path_and_pose_offsets():
    inner = FakeDeviceLandmarks()
    co = CoalescingLandmarks(inner, bucket_frames=32, max_wait_ms=80.0)
    try:
        host_a = np.full((4, 8, 8, 3), 5, np.uint8)
        host_b = np.full((6, 8, 8, 3), 11, np.uint8)
        dev_a, dev_b = torch.from_numpy(host_a), torch.from_numpy(host_b)
        (ra, rb), errs = _submit_concurrently([
            lambda: co.landmarks_batch(host_a, device_frames=dev_a),
            lambda: co.landmarks_batch(host_b, device_frames=dev_b),
        ])
        assert not errs
        assert inner.calls == [32]
        assert all(lm[0][0, 0] == 5.0 for lm in ra)
        assert all(lm[0][0, 0] == 11.0 for lm in rb)
        # pose: owner ids offset per group member; each caller sees poses of ITS frames
        (pa, pb), errs = _submit_concurrently([
            lambda: co.pose_boxes_batch(dev_a, [(0, 0, 4, 4)] * 2, [0, 1]),
            lambda: co.pose_boxes_batch(dev_b, [(0, 0, 4, 4)] * 3, [0, 2, 4]),
        ])
        assert not errs
        assert pa.shape == (2, 3) and pb.shape == (3, 3)
        assert all(p[0] == 5.0 for p in pa) and all(p[0] == 11.0 for p in pb)
        assert co.pose_boxes_batch(dev_a, [], []).shape == (0, 3)
    finally:
        co.close()


def test_landmarks_pose_fused_stage_coalesces():
    inner = FakeDeviceLandmarks()
    co = CoalescingLandmarks(inner, bucket_frames=32, max_wait_ms=80.0)
    try:
        host_a = np.full((4, 8, 8, 3), 5, np.uint8)
        host_b = np.full((6, 8, 8, 3), 11, np.uint8)
        dev_a, dev_b = torch.from_numpy(host_a), torch.from_numpy(host_b)
        (res_a, res_b), errs = _submit_concurrently([
            lambda: co.landmarks_pose_batch(host_a, device_frames=dev_a, pose_pad=0.1),
            lambda: co.landmarks_pose_batch(host_b, device_frames=dev_b, pose_pad=0.1),
        ])
        assert not errs
        assert inner.calls == [32]  # 10 frames -> ONE group (ladder floor 32)
        (lm_a, pose_a), (lm_b, pose_b) = res_a, res_b
        assert len(lm_a) == len(pose_a) == 4 and len(lm_b) == len(pose_b) == 6
        assert all(lm[0][0, 0] == 5.0 for lm in lm_a)
        assert all(p[0][0] == 5.0 and p[0][1] == 0.1 for p in pose_a)
        assert all(lm[0][0, 0] == 11.0 for lm in lm_b)
        assert all(p[0][0] == 11.0 and p[0][1] == 0.1 for p in pose_b)
    finally:
        co.close()


def test_landmarks_pose_fused_stage_host_fallback():
    co = CoalescingLandmarks(FakeLandmarks(), bucket_frames=32, max_wait_ms=20.0)
    try:
        lm, poses = co.landmarks_pose_batch(np.full((3, 8, 8, 3), 7, np.uint8), device_frames=None, pose_pad=0.1)
        assert poses is None and len(lm) == 3
        assert co.landmarks_batch(np.zeros((0, 8, 8, 3), np.uint8)) == []
    finally:
        co.close()


@pytest.mark.parametrize("device_frames", [False, True])
def test_detector_coalesce_and_split(device_frames):
    inner = FakeDeviceDetector() if device_frames else FakeDetector()
    co = CoalescingDetector(inner, bucket_frames=16, max_wait_ms=80.0)
    try:
        a = np.full((3, 8, 8, 3), 1, np.uint8)
        b = np.full((5, 8, 8, 3), 2, np.uint8)
        if device_frames:
            a, b = torch.from_numpy(a), torch.from_numpy(b)
        (ra, rb), errs = _submit_concurrently([lambda: co.detect_batch(a), lambda: co.detect_batch(b)])
        assert not errs
        assert inner.calls == [16]
        assert inner.kinds == ["Tensor" if device_frames else "ndarray"]
        assert [d[0][1] for d in ra] == [1.0] * 3
        assert [d[0][1] for d in rb] == [2.0] * 5
        assert co.accepts_device_frames == device_frames
    finally:
        co.close()


def test_oversized_request_runs_alone():
    inner = FakeLandmarks()
    co = CoalescingLandmarks(inner, bucket_frames=8, max_wait_ms=10.0)
    try:
        res = co.landmarks_batch(np.full((20, 8, 8, 3), 3, np.uint8))
        assert len(res) == 20
        assert inner.calls == [20]  # no padding past an oversized request
    finally:
        co.close()


def test_group_error_propagates_to_all_callers():
    class Exploding(FakeLandmarks):
        def landmarks_batch(self, frames, device_frames=None):
            raise RuntimeError("forward failed")

    co = CoalescingLandmarks(Exploding(), bucket_frames=16, max_wait_ms=50.0)
    try:
        a = np.zeros((2, 8, 8, 3), np.uint8)
        _, errs = _submit_concurrently([lambda: co.landmarks_batch(a), lambda: co.landmarks_batch(a)])
        assert len(errs) == 2 and all("forward failed" in str(e) for e in errs)
    finally:
        co.close()


def test_incompatible_shapes_group_separately():
    inner = FakeLandmarks()
    co = CoalescingLandmarks(inner, bucket_frames=64, max_wait_ms=80.0)
    try:
        a = np.full((4, 8, 8, 3), 1, np.uint8)
        b = np.full((4, 16, 16, 3), 2, np.uint8)
        (ra, rb), errs = _submit_concurrently([lambda: co.landmarks_batch(a), lambda: co.landmarks_batch(b)])
        assert not errs
        assert sorted(inner.calls) == [32, 32]  # two groups, each at the ladder floor
        assert all(lm[0][0, 0] == 1.0 for lm in ra) and all(lm[0][0, 0] == 2.0 for lm in rb)
    finally:
        co.close()


def test_closed_wrapper_fails_its_callers():
    co = CoalescingDetector(FakeDetector(), bucket_frames=16)
    co.close()
    with pytest.raises(RuntimeError, match="closed"):
        co.detect_batch(np.zeros((2, 8, 8, 3), np.uint8))


def test_coalesce_providers_wraps_only_device_models():
    host = Providers(landmarks=FakeLandmarks(), face_detector=FakeDetector())
    same, close = coalesce_providers(host)
    assert same is host
    assert coalesce.program_coalescing_active()  # the program coalescer runs for fixture bundles too
    close()
    assert not coalesce.program_coalescing_active()

    dev = Providers(landmarks=FakeDeviceLandmarks(), face_detector=FakeDeviceDetector(), ocr=FakeOCR(),
                    clip=FakeClip())
    for p in (dev.landmarks, dev.face_detector, dev.ocr, dev.clip):
        p.device = "fake-device"
    wrapped, close = coalesce_providers(dev)
    try:
        assert isinstance(wrapped.landmarks, CoalescingLandmarks)
        assert isinstance(wrapped.face_detector, CoalescingDetector)
        assert isinstance(wrapped.ocr, CoalescingOCR) and isinstance(wrapped.clip, CoalescingClip)
        assert wrapped.landmarks.inner is dev.landmarks and wrapped.llm is dev.llm
        # the nodes put frame tensors on the provider's device: the wrappers pass it on
        assert [w.device for w in (wrapped.landmarks, wrapped.face_detector, wrapped.ocr, wrapped.clip)] == \
            ["fake-device"] * 4
        # idempotent: re-wrapping returns the same bundle
        again, close2 = coalesce_providers(wrapped)
        assert again is wrapped
        close2()
        assert coalesce.program_coalescing_active()
    finally:
        close()
    assert not coalesce.program_coalescing_active()


def test_coalesce_env_overrides(monkeypatch):
    monkeypatch.setenv("FVD_TPU_COALESCE_WAIT_MS", "25")
    wrapped, close = coalesce_providers(Providers(landmarks=FakeDeviceLandmarks()))
    try:
        assert abs(wrapped.landmarks._co.max_wait_s - 0.025) < 1e-9
    finally:
        close()
    monkeypatch.setenv("FVD_TPU_NO_COALESCE", "1")
    bundle = Providers(landmarks=FakeDeviceLandmarks(), clip=FakeClip())
    same, close = coalesce_providers(bundle)
    assert same is bundle and not coalesce.program_coalescing_active()
    close()


def test_coalesce_window_adapts_to_slow_groups():
    import time

    class SlowLandmarks(FakeLandmarks):
        def landmarks_batch(self, frames, device_frames=None):
            time.sleep(0.12)
            return super().landmarks_batch(frames)

    co = CoalescingLandmarks(SlowLandmarks(), bucket_frames=8, max_wait_ms=6.0)
    try:
        assert co._co.max_wait_s == pytest.approx(0.006)
        for _ in range(4):
            co.landmarks_batch(np.zeros((1, 8, 8, 3), np.uint8))
        assert 0.010 < co._co.max_wait_s <= 0.050
    finally:
        co.close()


def test_ocr_coalesce_pads_and_splits():
    inner = FakeOCR()
    co = CoalescingOCR(inner, bucket_images=32, max_wait_ms=80.0)
    try:
        a = [np.full((8, 8, 3), 3, np.uint8)] * 4
        b = [np.full((8, 8, 3), 7, np.uint8)] * 6
        (ra, rb), errs = _submit_concurrently([lambda: co.read_text_batch(a), lambda: co.read_text_batch(b)])
        assert not errs
        assert inner.calls == [32]
        assert [d[0]["text"] for d in ra] == ["3"] * 4 and [d[0]["text"] for d in rb] == ["7"] * 6
        assert co.read_text(np.full((8, 8, 3), 9, np.uint8))[0]["text"] == "9"
        # no device entry point on the inner provider: the host path serves it
        assert co.read_text_batch_device(torch.zeros((1, 8, 8, 3), dtype=torch.uint8),
                                         [np.full((8, 8, 3), 5, np.uint8)])[0][0]["text"] == "5"
    finally:
        co.close()


def test_ocr_coalesce_device_path():
    inner = FakeDeviceOCR()
    co = CoalescingOCR(inner, bucket_images=64, max_wait_ms=80.0)
    try:
        ims_a = [np.full((8, 8, 3), 3, np.uint8)] * 4
        ims_b = [np.full((8, 8, 3), 7, np.uint8)] * 5
        dev_a, dev_b = torch.from_numpy(np.stack(ims_a)), torch.from_numpy(np.stack(ims_b))
        (ra, rb), errs = _submit_concurrently([lambda: co.read_text_batch_device(dev_a, ims_a),
                                               lambda: co.read_text_batch_device(dev_b, ims_b)])
        assert not errs
        assert inner.calls == [(32, 32)]  # one device group, images padded with the frames
        assert [d[0]["text"] for d in ra] == ["3"] * 4 and [d[0]["text"] for d in rb] == ["7"] * 5
    finally:
        co.close()


def test_clip_coalesce_pairs():
    inner = FakeClip()
    co = CoalescingClip(inner, bucket_pairs=16, max_wait_ms=80.0)
    try:
        a_imgs = [np.full((4, 4, 3), 50, np.uint8)] * 3
        b_imgs = [np.full((4, 4, 3), 80, np.uint8)] * 2
        (ra, rb), errs = _submit_concurrently([
            lambda: co.image_text_similarity_batch(a_imgs, ["x"] * 3),
            lambda: co.image_text_similarity_batch(b_imgs, ["y"] * 2),
        ])
        assert not errs
        assert inner.calls == [16]
        np.testing.assert_allclose(ra, [0.5] * 3)
        np.testing.assert_allclose(rb, [0.8] * 2)
        assert co.image_text_similarity(a_imgs[0], "z") == 0.5
        assert co.image_text_similarity_batch([], []).shape == (0,)
    finally:
        co.close()


def test_pose_boxes_attr_none_when_inner_lacks_it():
    co = CoalescingLandmarks(FakeLandmarks(), bucket_frames=8)
    try:
        assert getattr(co, "pose_boxes_batch", None) is None
    finally:
        co.close()


def _jax_clip():
    from fvd_tpu_torch.models.encoders import JaxClip

    with open(os.path.join(CKPT, "clip.json")) as f:
        meta = json.load(f)
    keep = {"dim", "depth", "out_dim", "cal_offset", "cal_scale"}
    return JaxClip(checkpoint=os.path.join(CKPT, "clip.npz"), device="cpu",
                   **{k: v for k, v in meta.items() if k in keep})


def _hf_clip():
    """The port's HF CLIP at a small geometry with seeded weights and a
    stand-in tokenizer (ids from the bytes, eos 0 pooling)."""
    from fvd_tpu_torch.models.hf_clip import CLIPModel
    from fvd_tpu_torch.providers.hf_models import HFClip

    common = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                  hidden_act="quick_gelu", layer_norm_eps=1e-5)
    cfg = {"text_config": dict(common, vocab_size=100, max_position_embeddings=16, eos_token_id=0),
           "vision_config": dict(common, image_size=64, patch_size=16), "projection_dim": 32}
    model = CLIPModel(cfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen) * 0.1)

    def tokenize(texts):
        ids = np.zeros((len(texts), 16), np.int64)
        mask = np.zeros((len(texts), 16), np.int64)
        for i, t in enumerate(texts):
            toks = [1 + b % 98 for b in t.encode()][:15] + [0]
            ids[i, :len(toks)], mask[i, :len(toks)] = toks, 1
        return {"input_ids": ids, "attention_mask": mask}

    return HFClip(model, tokenize, 64, cal_offset=-0.2, cal_scale=0.5, device="cpu")


@pytest.mark.parametrize("make", [_jax_clip, _hf_clip], ids=["JaxClip", "HFClip"])
def test_coalescing_clip_over_port_clips(make):
    """Three callers' keyframe sets in one padded group give each caller what
    the unwrapped CLIP gives it alone."""
    inner = make()
    assert getattr(inner, "coalescable", False)
    rng = np.random.RandomState(0)
    sets = [([rng.randint(0, 256, (40 + 8 * k, 56, 3)).astype(np.uint8) for _ in range(n)],
             [f"caption {k} {i} of a face on screen" for i in range(n)]) for k, n in enumerate((3, 2, 4))]
    alone = [inner.image_text_similarity_batch(ims, txt) for ims, txt in sets]
    wrapped, close = coalesce_providers(Providers(clip=inner))
    try:
        assert isinstance(wrapped.clip, CoalescingClip)
        got, errs = _submit_concurrently([lambda s=s: wrapped.clip.image_text_similarity_batch(*s) for s in sets])
        assert not errs
        for g, a in zip(got, alone):
            assert g.shape == a.shape
            np.testing.assert_allclose(g, a, rtol=0, atol=CLIP_TOL)
    finally:
        close()
