"""The port's training data against the JAX package's on the CPU: the same
``RandomState`` seeds through ``detector_batch``, ``landmark_batch`` (clean
and augmented), ``pose_batch`` (clean and augmented) and
``pose_batch_paired`` give bit-equal labels (boxes, landmark targets, anchor
labels, loc targets, rotations, Euler angles) and leave the generator in the
same state, and the pixels are bit-equal; so do the calls with a realism
lever (``tests/test_torch_realism_levers.py`` holds the levers in full).
The JAX package draws with
OpenCV, the port with numpy (``fvd_tpu_torch/utils/draw.py``, OpenCV's
rasterisation); the port's warps and resize (``fvd_tpu_torch/utils/cv.py``)
and its drawing are held to OpenCV here too (a 300-wide affine warp may
differ by one level in its last 12 columns, and a thick line or an arc fill
cut by the image border by a few pixels: none of that shows at these
seeds).  Also the anchor matching and box encoding of
``fvd_tpu_torch/ops/detection.py``.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from fvd_tpu.models import synthetic_faces as jsf  # noqa: E402
from fvd_tpu.models import synthetic_pose as jsp  # noqa: E402
from fvd_tpu_torch.models import synthetic_faces as psf  # noqa: E402
from fvd_tpu_torch.models import synthetic_pose as psp  # noqa: E402
from fvd_tpu_torch.ops import detection  # noqa: E402
from fvd_tpu_torch.utils import cv, draw  # noqa: E402

BATCH = 4
SEEDS = (0, 1, 2)

#: name -> (JAX generator, port generator, kwargs, index of the pixels, indices of the labels)
GENERATORS = {
    "detector": (jsf.detector_batch, psf.detector_batch, {}, (0,), (1, 2, 3)),
    "detector_augment": (jsf.detector_batch, psf.detector_batch, {"augment": True}, (0,), (1, 2, 3)),
    "landmark": (jsf.landmark_batch, psf.landmark_batch, {}, (0,), (1,)),
    "landmark_augment": (jsf.landmark_batch, psf.landmark_batch, {"augment": True, "hard_half": True}, (0,), (1,)),
    "pose": (jsp.pose_batch, psp.pose_batch, {}, (0,), (1, 2)),
    "pose_augment": (jsp.pose_batch, psp.pose_batch, {"augment": True, "hard_half": True}, (0,), (1, 2)),
    "pose_paired": (jsp.pose_batch_paired, psp.pose_batch_paired, {}, (0, 1), (2,)),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", GENERATORS)
def test_generator_matches_jax(name, seed):
    jax_fn, port_fn, kw, pix, lab = GENERATORS[name]
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    ref, got = jax_fn(rj, BATCH, **kw), port_fn(rp, BATCH, **kw)
    for a, b in zip(rj.get_state(), rp.get_state()):
        np.testing.assert_array_equal(a, b)
    for i in lab:
        assert got[i].dtype == ref[i].dtype and got[i].shape == ref[i].shape
        np.testing.assert_array_equal(got[i], ref[i])
    for i in pix:  # measured: bit-equal on every generator at these seeds
        np.testing.assert_array_equal(got[i], ref[i])


#: the calls that raised while the realism levers were not ported, each
#: held against the JAX package's as ``test_generator_matches_jax`` holds them
LEVER_CALLS = {
    "detector_photometric": (jsf.detector_batch, psf.detector_batch, {"augment": True, "photometric": True}),
    "detector_dense": (jsf.detector_batch, psf.detector_batch, {"augment": True, "dense": True}),
    "landmark_shaded": (jsf.landmark_batch, psf.landmark_batch, {"shaded": True}),
    "pose_portrait": (jsp.pose_batch, psp.pose_batch, {"augment": True, "portrait": True}),
    "pose_paired_shaded": (jsp.pose_batch_paired, psp.pose_batch_paired, {"shaded": True}),
}


@pytest.mark.parametrize("name", LEVER_CALLS)
def test_lever_calls_match_jax(name):
    jax_fn, port_fn, kw = LEVER_CALLS[name]
    rj, rp = np.random.RandomState(0), np.random.RandomState(0)
    ref, got = jax_fn(rj, 2, **kw), port_fn(rp, 2, **kw)
    for a, b in zip(rj.get_state(), rp.get_state()):
        np.testing.assert_array_equal(a, b)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_match_anchors_force_match():
    anchors = detection.make_anchors([(4, 4)], [[0.25]], [[1.0]])
    gt = np.asarray([[0.0, 0.0, 0.05, 0.05]], np.float32)  # tiny: no anchor passes 0.5 IoU
    labels, matched = detection.match_anchors(gt, anchors)
    assert labels.sum() == 1  # its best anchor got force-matched
    np.testing.assert_allclose(matched[labels > 0][0], gt[0])


def test_encode_decode_roundtrip():
    anchors = detection.make_anchors([(4, 4)], [[0.3]], [[1.0]])
    rng = np.random.RandomState(0)
    boxes = []
    for _ in range(16):
        cx, cy = rng.uniform(0.2, 0.8, 2)
        w, h = rng.uniform(0.1, 0.3, 2)
        boxes.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
    boxes = np.asarray(boxes, np.float32)
    deltas = detection.encode_boxes(boxes, anchors)
    recovered = detection.decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors))
    np.testing.assert_allclose(recovered.numpy(), boxes, atol=1e-5)


def test_rotation_matrix_is_opencvs():
    rng = np.random.RandomState(0)
    for _ in range(20):
        center, angle = tuple(rng.uniform(0, 300, 2)), rng.uniform(-20, 20)
        np.testing.assert_array_equal(cv.rotation_matrix_2d(center, angle, 1.0),
                                      cv2.getRotationMatrix2D(center, angle, 1.0))


@pytest.mark.parametrize("size", [300, 256, 192])
def test_warp_affine_matches_opencv(size):
    rng = np.random.RandomState(size)
    img = rng.randint(0, 256, (size, size, 3)).astype(np.uint8)
    M = cv2.getRotationMatrix2D(tuple(rng.uniform(50, 150, 2)), rng.uniform(-20, 20), 1.0)
    d = np.abs(cv.warp_affine_u8(img, M, size, size).astype(int)
               - cv2.warpAffine(img, M, (size, size), flags=cv2.INTER_LINEAR))
    # OpenCV computes the last columns past its 16-lane loop apart (see utils/cv.py)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4
    if size % 16 == 0:
        assert d.max() == 0


def test_warp_perspective_matches_opencv():
    rng = np.random.RandomState(0)
    for _ in range(4):
        img = rng.randint(0, 256, (128, 128, 3)).astype(np.uint8)
        R = psp.euler_to_matrix(*rng.uniform(-40, 40, 3))
        np.testing.assert_array_equal(psp.warp_by_rotation(img, R), jsp.warp_by_rotation(img, R))


DRAW_CALLS = {
    "filled ellipse": (lambda im, r: cv2.ellipse(im, r["c"], r["ax"], 0, 0, 360, r["col"], -1),
                       lambda im, r: draw.fill_ellipse(im, r["c"], r["ax"], r["col"])),
    "rotated ellipse": (lambda im, r: cv2.ellipse(im, r["c"], r["ax"], r["ang"], 0, 360, r["col"], -1),
                        lambda im, r: draw.fill_ellipse(im, r["c"], r["ax"], r["col"], r["ang"])),
    "upper half ellipse": (lambda im, r: cv2.ellipse(im, r["c"], r["ax"], 0, 180, 360, r["col"], -1),
                           lambda im, r: draw.fill_ellipse(im, r["c"], r["ax"], r["col"], 0, 180, 360)),
    "circle": (lambda im, r: cv2.circle(im, r["c"], r["rad"], r["col"], r["th"]),
               lambda im, r: draw.circle(im, r["c"], r["rad"], r["col"], r["th"])),
    "line": (lambda im, r: cv2.line(im, r["p0"], r["p1"], r["col"], r["th"]),
             lambda im, r: draw.line(im, r["p0"], r["p1"], r["th"], r["col"])),
    "polyline": (lambda im, r: cv2.polylines(im, [r["pts"]], False, r["col"], r["th"]),
                 lambda im, r: draw.polyline(im, r["pts"], r["th"], r["col"])),
    "filled rectangle": (lambda im, r: cv2.rectangle(im, r["p0"], r["p1"], r["col"], -1),
                         lambda im, r: draw.fill_rectangle(im, r["p0"], r["p1"], r["col"])),
}


@pytest.mark.parametrize("name", DRAW_CALLS)
def test_drawing_matches_opencv_inside_the_image(name):
    """100 random shapes of each kind that lie inside a 120x160 image (the
    training images' shapes do), drawn by OpenCV and by the port."""
    rng = np.random.RandomState(len(name))
    ref_fn, port_fn = DRAW_CALLS[name]
    for _ in range(100):
        ax = (int(rng.randint(0, 40)), int(rng.randint(0, 40)))
        r = {"c": (int(rng.randint(40, 120)), int(rng.randint(40, 80))), "ax": ax, "ang": float(rng.uniform(0, 180)),
             "rad": int(rng.randint(1, 38)), "th": int(rng.randint(1, 4)), "col": (200, 100, 50),
             "p0": (int(rng.randint(2, 158)), int(rng.randint(2, 118))),
             "p1": (int(rng.randint(2, 158)), int(rng.randint(2, 118))),
             "pts": rng.randint(2, 118, (5, 2)).astype(np.int32)}
        ref, got = np.zeros((120, 160, 3), np.uint8), np.zeros((120, 160, 3), np.uint8)
        ref_fn(ref, r)
        port_fn(got, r)
        np.testing.assert_array_equal(got, ref)
