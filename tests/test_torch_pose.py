"""V4's pose half and smoothing stage of the port against
``fvd_tpu/models/landmarks_fan.py`` and ``fvd_tpu/ops/filters.py``: the pose
head on the shipped ``pose.npz``, the 6D -> rotation -> euler chain (the
gimbal-lock branch included), the fused landmark+pose program with its pose
crop boxes derived on the device, and ``v4_smooth_chunk``.  Inputs from seeds;
float32 on both sides."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvd_tpu.models import landmarks_fan as jlmk
from fvd_tpu.ops import filters as jfilt
from fvd_tpu_torch import weights
from fvd_tpu_torch.models import landmarks_fan as tlmk
from fvd_tpu_torch.nodes._tracking import landmark_box
from fvd_tpu_torch.ops import filters as tfilt
from fvd_tpu_torch.synthetic import make_face_video
from fvd_tpu_torch.providers.media import VideoReader

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
#: d6 -> degrees, f32 on both sides: the chain is a few dozen float32 ops on
#: unit vectors, so it agrees within ~1e-5 of a degree away from gimbal lock
EULER_TOL_DEG = 1e-4
#: the pose head on the same crops: four convs, a mean and two Dense layers
#: summing in other orders; measured (``python tests/test_torch_pose.py``
#: prints it) max 1.45e-3 degree on angles up to 40
#: degrees (3.6e-5 relative) with the landmarks within 4.9e-6 of the crop
POSE_TOL_DEG = 5e-3
#: the fused program end to end (landmarks, derived boxes, crops, pose head)
LANDMARK_TOL = 1e-5   # crop [0, 1] units
#: EAR against the JAX scan at frame coordinates ~160 px: the two OneEuro
#: loops differ by about one float32 ulp per step (1.5e-5 px at 160 px,
#: ``tests/test_torch_tracking.py``), and over a 12 px eye that moves the EAR
#: by ~5e-7 per ulp (measured max 1.25e-6 on this track); chunked against one
#: scan the port is exact
EAR_TOL = 5e-6


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
def pose_params():
    return weights.read_npz(os.path.join(CKPT, "pose.npz"))


def test_dense_kernels_load_as_linear_weights(pose_params):
    sd = weights.to_state_dict(pose_params)
    k = pose_params["['params']['Dense_0']['kernel']"]
    assert sd["Dense_0.weight"].shape == (128, 128) and torch.equal(sd["Dense_0.weight"], torch.from_numpy(k.T))
    assert sd["Dense_1.weight"].shape == (6, 128)
    with pytest.raises(ValueError, match="Dense"):
        weights.to_state_dict({"params": {"X_0": {"kernel": np.zeros((2, 2, 2), np.float32)}}})


def test_pose_head_matches_flax_on_pose_npz(pose_params):
    with open(os.path.join(CKPT, "pose.json")) as f:
        assert '"width": 32' in f.read()
    x = np.random.RandomState(0).rand(3, 128, 128, 3).astype(np.float32)
    ref = np.asarray(jlmk.PoseHead(width=32).apply(_nest(pose_params), jnp.asarray(x)))
    model = tlmk.pose_from_params(pose_params, "cpu")
    assert model.width == 32
    assert sum(p.numel() for p in model.parameters()) == sum(v.size for v in pose_params.values())
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 6)
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(1.0, np.abs(ref).max()), rtol=0)


def _d6_cases():
    d6 = np.random.RandomState(1).randn(64, 6).astype(np.float32)
    d6[0] = [0, 0, 1, 0, 1, 0]    # b1 = z, b2 = y: R[0,0] = R[1,0] = 0, sy = 0 (gimbal lock)
    d6[1] = [0, 0, 2, 0, -3, 0.5]  # the same branch, b2 = -y after Gram-Schmidt
    return d6


def test_rotation_and_euler_match_jax_including_gimbal_lock():
    d6 = _d6_cases()
    ref_R = np.asarray(jlmk.rotation_6d_to_matrix(jnp.asarray(d6)))
    got_R = tlmk.rotation_6d_to_matrix(torch.from_numpy(d6)).numpy()
    np.testing.assert_allclose(got_R, ref_R, atol=1e-6, rtol=0)
    # a right-handed frame: b3 = b1 x b2 as jnp.cross orients it
    np.testing.assert_allclose(np.linalg.det(got_R.astype(np.float64)), 1.0, atol=1e-5)
    ref = np.asarray(jlmk.euler_from_matrix_deg(jnp.asarray(ref_R)))
    got = tlmk.euler_from_matrix_deg(torch.from_numpy(got_R)).numpy()
    sy = np.sqrt(got_R[:, 0, 0] ** 2 + got_R[:, 1, 0] ** 2)
    assert (sy < 1e-6)[:2].all() and (sy >= 1e-6)[2:].all()
    assert got[0, 2] == 0.0 and got[1, 2] == 0.0  # roll 0 on the singular branch
    np.testing.assert_allclose(got, ref, atol=EULER_TOL_DEG, rtol=0)


def _face_frames(root):
    path = make_face_video(root, "face", duration=1.6, fps=10.0, seed=5)
    frames, kept = VideoReader(use_cache=False).sample(path, range(16))
    assert len(kept) == 16
    return frames


@pytest.fixture(scope="module")
def face_frames(tmp_path_factory):
    return _face_frames(str(tmp_path_factory.mktemp("pose")))


@pytest.mark.parametrize("size", [96, 160])
def test_pose_batch_on_host_crops_matches_jax(pose_params, size):
    """``FANLandmarks.pose_batch``: uint8 crops resized to 128 as
    ``jax.image.resize`` does (antialiased when shrinking), then the head."""
    crops = np.random.RandomState(size).randint(0, 256, (4, size, size, 3)).astype(np.uint8)
    ref = np.asarray(jlmk.pose_forward(_nest(pose_params), jnp.asarray(crops), width=32))
    prov = tlmk.FANLandmarks(None, checkpoint=os.path.join(CKPT, "landmarks.npz"),
                             pose_checkpoint=os.path.join(CKPT, "pose.npz"), device="cpu")
    got = prov.pose_batch(crops)
    assert got.shape == (4, 3) and prov.pose_batch(crops[:0]).shape == (0, 3)
    np.testing.assert_allclose(got, ref, atol=POSE_TOL_DEG, rtol=0)


def _jax_pose_boxes(coords, boxes, frame_w, frame_h, pad_frac):
    """``landmarks_pose_from_frames``'s box lines (:384-396), jitted alone."""
    @jax.jit
    def f(coords, boxes, pad_frac):
        x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        px = x1[:, None] + coords[:, :, 0] * (x2 - x1)[:, None]
        py = y1[:, None] + coords[:, :, 1] * (y2 - y1)[:, None]
        bx1, bx2 = jnp.trunc(jnp.min(px, axis=1)), jnp.trunc(jnp.max(px, axis=1))
        by1, by2 = jnp.trunc(jnp.min(py, axis=1)), jnp.trunc(jnp.max(py, axis=1))
        pad_w = jnp.trunc((bx2 - bx1) * pad_frac)
        pad_h = jnp.trunc((by2 - by1) * pad_frac)
        return jnp.stack([jnp.maximum(0.0, bx1 - pad_w), jnp.maximum(0.0, by1 - pad_h),
                          jnp.minimum(jnp.float32(frame_w), bx2 + pad_w),
                          jnp.minimum(jnp.float32(frame_h), by2 + pad_h)], axis=1)
    return np.asarray(f(jnp.asarray(coords), jnp.asarray(boxes), float(pad_frac)))


def fused_program_both(face_frames, pose_params):
    """The fused landmark+pose program of both packages, f32, on the same
    frames and seeded integer boxes: (boxes, coords, poses, pose boxes) per
    package."""
    T, H, W = face_frames.shape[:3]
    rng = np.random.RandomState(2)
    x1, y1 = rng.randint(60, 110, T), rng.randint(20, 50, T)
    boxes = np.stack([x1, y1, x1 + rng.randint(100, 140, T), y1 + rng.randint(130, 170, T)], 1)
    owners = np.arange(T)
    lmk_flat = weights.read_npz(os.path.join(CKPT, "landmarks.npz"))
    jb, jo, n = jlmk._marshal_boxes(boxes.tolist(), owners)
    coords_j, poses_j = jlmk.landmarks_pose_from_frames(
        _nest(lmk_flat), _nest(pose_params), jnp.asarray(face_frames), jb, jo, float(W), float(H), 0.1,
        width=32, pose_width=32, compute_dtype=jnp.float32)
    coords_j, poses_j = np.asarray(coords_j)[:n], np.asarray(poses_j)[:n]

    model = tlmk.from_params(lmk_flat, "cpu")
    pose_model = tlmk.pose_from_params(pose_params, "cpu")
    tb, to, _ = tlmk._marshal_boxes(boxes.tolist(), owners, "cpu")
    coords_t, poses_t = tlmk.landmarks_pose_from_frames(
        model, pose_model, torch.from_numpy(face_frames), tb, to, float(W), float(H), 0.1,
        compute_dtype=torch.float32)
    coords_t, poses_t = coords_t[:n].numpy(), poses_t[:n].numpy()
    boxes_t = tlmk.pose_crop_boxes(torch.from_numpy(coords_t), tb[:n], float(W), float(H), 0.1).numpy()
    boxes_j = _jax_pose_boxes(coords_j, np.asarray(jb)[:n], W, H, 0.1)
    return boxes, {"torch": (coords_t, poses_t, boxes_t), "jax": (coords_j, poses_j, boxes_j)}


def test_landmarks_pose_program_matches_jax(face_frames, pose_params):
    """The fused program on the same frames and integer boxes, f32 on both
    sides: landmarks within LANDMARK_TOL of the crop, every derived pose box
    equal to the JAX package's and to the host tracker's rule (landmark box
    truncated, padded by int(extent * 0.1), clipped), poses within
    POSE_TOL_DEG."""
    H, W = face_frames.shape[1:3]
    boxes, out = fused_program_both(face_frames, pose_params)
    (coords_t, poses_t, boxes_t), (coords_j, poses_j, boxes_j) = out["torch"], out["jax"]
    np.testing.assert_allclose(coords_t, coords_j, atol=LANDMARK_TOL, rtol=0)
    np.testing.assert_array_equal(boxes_t, boxes_j)
    for (bx1, by1, bx2, by2), c, b in zip(boxes, coords_t, boxes_t):
        pts = np.stack([np.float32(bx1) + c[:, 0] * np.float32(bx2 - bx1),
                        np.float32(by1) + c[:, 1] * np.float32(by2 - by1)], 1)
        lx1, ly1, lx2, ly2 = landmark_box(pts)
        pw, ph = int((lx2 - lx1) * 0.1), int((ly2 - ly1) * 0.1)
        assert list(b) == [max(0, lx1 - pw), max(0, ly1 - ph), min(W, lx2 + pw), min(H, ly2 + ph)]
    np.testing.assert_allclose(poses_t, poses_j, atol=POSE_TOL_DEG, rtol=0)


def test_pose_head_runs_in_f32_under_a_bf16_provider(face_frames):
    """The landmarks in bf16, the pose head in float32 on the same
    parameters: the bf16 bundle's poses are the f32 pose head's on the bf16
    landmarks' boxes."""
    from fvd_tpu_torch.models.face_ssd import SSDFaceDetector

    det = SSDFaceDetector(checkpoint=os.path.join(CKPT, "face_ssd.npz"), device="cpu")
    prov = tlmk.FANLandmarks(det, checkpoint=os.path.join(CKPT, "landmarks.npz"),
                             pose_checkpoint=os.path.join(CKPT, "pose.npz"), compute_dtype=torch.bfloat16,
                             device="cpu")
    assert next(prov.pose_model.parameters()).dtype == torch.float32
    lm, poses = prov.landmarks_pose_batch(face_frames, pose_pad=0.1)
    assert sum(len(p) for p in poses) >= 14
    assert next(prov.pose_model.parameters()).dtype == torch.float32
    frames = torch.from_numpy(face_frames)
    boxes, owners, got = [], [], []
    for i, (lms, ps) in enumerate(zip(lm, poses)):
        for pts, p in zip(lms, ps):
            x1, y1, x2, y2 = landmark_box(pts)
            pw, ph = int((x2 - x1) * 0.1), int((y2 - y1) * 0.1)
            boxes.append((max(0, x1 - pw), max(0, y1 - ph), min(320, x2 + pw), min(240, y2 + ph)))
            owners.append(i)
            got.append(p)
    ref = prov.pose_boxes_batch(frames, boxes, owners)
    assert np.asarray(got).dtype == np.float32
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-3, rtol=0)


def _v4_track(T, seed):
    """A face drifting around (160, 120) px with eyes of the synthetic
    provider's geometry (12 px wide, 4 px open: EAR ~0.33) and 0.5 px of
    landmark noise."""
    r = np.random.RandomState(seed)
    times = np.arange(T) / 5.0
    eye = np.array([[-6, 0], [-2, -2], [2, -2], [6, 0], [2, 2], [-2, 2]], np.float64)
    lm = np.zeros((T, 68, 3))
    center = np.array([160.0, 120.0]) + np.cumsum(r.randn(T, 2), axis=0)
    lm[:, :, :2] = center[:, None] + 30 * r.randn(1, 68, 2)
    lm[:, 36:42, :2] = center[:, None] + [-15, -10] + eye
    lm[:, 42:48, :2] = center[:, None] + [15, -10] + eye
    lm[:, :, :2] += 0.5 * r.randn(T, 68, 2)  # z stays 0: a 2D provider, zero-extended
    valid = r.rand(T) > 0.2
    pose = 10 * r.randn(T, 3)
    pose_valid = valid & (r.rand(T) > 0.1)
    return times, lm, valid, pose, pose_valid


def test_v4_smooth_chunk_matches_jax_and_chunks_equal_one_scan():
    times, lm, valid, pose, pose_valid = _v4_track(40, 3)
    args = (times, lm, valid, pose, pose_valid)
    one_lm, one_ears, one_pose = tfilt.v4_smooth_program(*args)
    ref_lm, ref_ears, ref_pose = (np.asarray(a) for a in jfilt.v4_smooth_program(
        *(jnp.asarray(a) for a in args)))
    assert np.array_equal(np.isnan(one_lm), np.isnan(ref_lm))
    np.testing.assert_allclose(one_ears, ref_ears, atol=EAR_TOL, rtol=0)
    np.testing.assert_allclose(np.nan_to_num(one_pose), np.nan_to_num(ref_pose), atol=1e-4, rtol=0)
    assert (one_ears[~valid] == 0.0).all() and (one_ears[valid] > 0).all()

    for split in (1, 7, 16):
        lm_c, pose_c = tfilt.one_euro_init_carry((68, 3)), tfilt.one_euro_init_carry((3,))
        ears, poses = [], []
        for s in range(0, 40, split):
            sl = slice(s, s + split)
            _, e, p, lm_c, pose_c = tfilt.v4_smooth_chunk(lm_c, pose_c, times[sl], lm[sl], valid[sl],
                                                          pose[sl], pose_valid[sl])
            ears.append(e)
            poses.append(p)
        np.testing.assert_array_equal(np.concatenate(ears), one_ears)
        np.testing.assert_array_equal(np.concatenate(poses), one_pose)


def test_eye_aspect_ratio_and_filter_match_jax():
    eye = np.random.RandomState(4).rand(6, 3) * 10
    assert tfilt.eye_aspect_ratio(eye) == jfilt.eye_aspect_ratio(eye)
    assert tfilt.eye_aspect_ratio(np.zeros((6, 2))) == 0.0
    a, b = tfilt.OneEuroFilter(0.0, [1.0, 2.0], beta=0.1), jfilt.OneEuroFilter(0.0, [1.0, 2.0], beta=0.1)
    for t, x in ((0.2, [1.5, 2.5]), (0.4, [0.5, 1.0]), (0.6, [3.0, -1.0])):
        np.testing.assert_array_equal(a(t, x), b(t, x))


if __name__ == "__main__":  # print the gaps the bars above come from
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        _, out = fused_program_both(_face_frames(tmp), weights.read_npz(os.path.join(CKPT, "pose.npz")))
    (ct, pt, bt), (cj, pj, bj) = out["torch"], out["jax"]
    args = _v4_track(40, 3)
    ears = tfilt.v4_smooth_program(*args)[1]
    ref = np.asarray(jfilt.v4_smooth_program(*(jnp.asarray(a) for a in args))[1])
    print({"coords": float(np.abs(ct - cj).max()), "pose_deg": float(np.abs(pt - pj).max()),
           "largest_angle_deg": float(np.abs(pj).max()), "pose_boxes_equal": bool(np.array_equal(bt, bj)),
           "ear": float(np.abs(ears - ref).max())})
