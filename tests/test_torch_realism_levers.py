"""The realism levers of the port's face data (``photometric``, ``shaded``,
``portrait`` and ``detector_batch``'s ``dense`` mixture) against the JAX
package's on the CPU: for seeds 0-2 and small batches, ``render_face``,
``detector_batch`` (``dense`` with every lever), ``landmark_batch`` (the FAN
trainer's recipe at ``crop=256``, and with ``portrait``), ``pose_batch`` and
``pose_batch_paired`` with the levers give bit-equal labels (boxes, landmark
targets, anchor labels, loc targets, rotations, Euler angles), leave the
``RandomState`` in the same state, and give bit-equal pixels.  The JAX
package draws, blurs, filters and JPEG-codes with OpenCV; the port with
``fvd_tpu_torch/utils/{draw,cv,jpeg}.py`` (held to OpenCV in
``tests/test_torch_cv_realism_ops.py``).  Also the JAX package's own lever
tests, mirrored on the port: ``tests/test_models.py::
test_photometric_domain_randomization``, the three of
``tests/test_shading_realism.py`` and ``tests/test_pose_consistency.py::
test_paired_batch_shares_rotation_differs_in_appearance``.
"""

import numpy as np
import pytest

pytest.importorskip("cv2")

from fvd_tpu.models import synthetic_faces as jsf  # noqa: E402
from fvd_tpu.models import synthetic_pose as jsp  # noqa: E402
from fvd_tpu_torch.models import synthetic_faces as psf  # noqa: E402
from fvd_tpu_torch.models import synthetic_pose as psp  # noqa: E402
from test_torch_train_losses import one_torch_thread  # noqa: E402,F401

SEEDS = (0, 1, 2)
BATCH = 4
ALL = dict(photometric=True, shaded=True, portrait=True)

#: name -> (JAX function, port function, args, kwargs)
CALLS = {
    "render_photometric": (jsf.render_face, psf.render_face, (300,), dict(augment=True, photometric=True)),
    "render_shaded": (jsf.render_face, psf.render_face, (256,), dict(shaded=True, aperture=0.5)),
    "render_portrait": (jsf.render_face, psf.render_face, (300,), dict(portrait=True)),
    "render_all_hard": (jsf.render_face, psf.render_face, (300,), dict(hard=True, **ALL)),
    "detector_dense": (jsf.detector_batch, psf.detector_batch, (BATCH,), dict(augment=True, dense=True, **ALL)),
    "detector_levers": (jsf.detector_batch, psf.detector_batch, (BATCH,), dict(augment=True, **ALL)),
    "landmark_fan": (jsf.landmark_batch, psf.landmark_batch, (BATCH,),
                     dict(crop=256, augment=True, photometric=True, shaded=True, hard_half=True)),
    "landmark_portrait": (jsf.landmark_batch, psf.landmark_batch, (BATCH,), dict(augment=True, **ALL)),
    "pose_levers": (jsp.pose_batch, psp.pose_batch, (BATCH,), dict(augment=True, hard_half=True, **ALL)),
    "pose_paired": (jsp.pose_batch_paired, psp.pose_batch_paired, (BATCH,), dict(photometric=True, shaded=True)),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CALLS)
def test_levers_match_jax(name, seed):
    jax_fn, port_fn, args, kw = CALLS[name]
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    ref, got = jax_fn(rj, *args, **kw), port_fn(rp, *args, **kw)
    for a, b in zip(rj.get_state(), rp.get_state()):
        np.testing.assert_array_equal(a, b)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):  # pixels and labels alike: bit for bit
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("seed", SEEDS)
def test_each_lever_alone_matches_jax(seed):
    """``face_shading_realism``, ``photometric_randomize`` and
    ``portrait_realism`` on the same image and stream."""
    base = jsf.render_face(np.random.RandomState(seed + 10), 256, augment=True)[0]
    bg = jsf.render_face(np.random.RandomState(seed + 20), 256)[0]
    for jax_fn, port_fn, args in ((jsf.face_shading_realism, psf.face_shading_realism, (120.0, 130.0, 90.0, 120.0)),
                                  (jsf.photometric_randomize, psf.photometric_randomize, ()),
                                  (jsf.portrait_realism, psf.portrait_realism, (bg, 128.5, 120.2, 100.3, 130.7))):
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        ref, got = jax_fn(base.copy(), *args, rj), port_fn(base.copy(), *args, rp)
        np.testing.assert_array_equal(got, ref)
        assert rj.get_state()[2] == rp.get_state()[2]


# ----------------------------------------- the JAX package's tests, on the port
def test_photometric_domain_randomization():
    rng = np.random.RandomState(0)
    img, box, pts = psf.render_face(rng, 300, augment=True, photometric=True)
    assert img.shape == (300, 300, 3) and img.dtype == np.uint8
    assert np.all((0.0 <= box) & (box <= 1.0)) and box[2] > box[0]

    base = psf.render_face(np.random.RandomState(1), 300, augment=True)[0]
    a = psf.photometric_randomize(base, np.random.RandomState(2))
    b = psf.photometric_randomize(base, np.random.RandomState(2))
    assert a.shape == base.shape and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert not np.array_equal(a, base)

    frames, labels, locs, boxes = psf.detector_batch(np.random.RandomState(3), 4, augment=True, photometric=True)
    assert frames.shape[0] == 4 and np.all(np.isfinite(frames))


def test_shading_preserves_gt_box_and_landmarks():
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    img_a, box_a, pts_a = psf.render_face(r1, 256, shaded=False)
    img_b, box_b, pts_b = psf.render_face(r2, 256, shaded=True)
    np.testing.assert_allclose(box_a, box_b)
    np.testing.assert_allclose(pts_a, pts_b)
    assert img_b.dtype == np.uint8
    assert not np.array_equal(img_a, img_b)


def test_shading_changes_are_face_local():
    rng = np.random.RandomState(9)
    img = (np.ones((200, 200, 3)) * 90).astype(np.uint8)
    ref = img.copy()
    cx, cy, fw, fh = 100.0, 100.0, 80.0, 110.0
    out = psf.face_shading_realism(img, cx, cy, fw, fh, rng)
    yy, xx = np.mgrid[0:200, 0:200]
    r2 = ((xx - cx) / (fw / 2)) ** 2 + ((yy - cy) / (fh / 2)) ** 2
    far = r2 > 1.35  # outside the feather band
    np.testing.assert_array_equal(out[far], ref[far])
    inside = r2 < 0.7
    assert np.abs(out[inside].astype(int) - ref[inside].astype(int)).mean() > 1.0


def test_shaded_batches_keep_shapes():
    rng = np.random.RandomState(2)
    frames, labels, locs, boxes = psf.detector_batch(rng, 4, shaded=True)
    assert frames.shape[0] == 4 and np.isfinite(frames).all()
    crops, targets = psf.landmark_batch(rng, 4, shaded=True)
    assert crops.shape == (4, 128, 128, 3)
    assert (targets >= 0).all() and (targets <= 1).all()
    pcrops, Rs, eulers = psp.pose_batch(rng, 4, shaded=True)
    assert pcrops.shape[0] == 4 and np.isfinite(pcrops).all()


def test_paired_batch_shares_rotation_differs_in_appearance():
    rng = np.random.RandomState(3)
    ca, cb, Rs = psp.pose_batch_paired(rng, 6, photometric=True, shaded=True)
    assert ca.shape == cb.shape == (6, 128, 128, 3)
    assert Rs.shape == (6, 3, 3)
    for R in Rs:
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-9)
        assert np.linalg.det(R) > 0.99
    diff = np.abs(ca - cb).mean(axis=(1, 2, 3))
    assert (diff > 0).all()
    assert (diff < 0.5).all()
