"""``fvd_tpu_torch/tools/eval_heldout.py`` against ``tools/eval_heldout.py``
on the CPU, on the shipped checkpoints.

* ``render_face_heldout`` gives the JAX package's image, box and landmarks
  for the same seed: the image bit for bit at 192 and 256 pixels, and at
  300 within one level on at most ``WARP_SHARE`` of the values (OpenCV's
  affine warp computes the last ``300 % 16`` columns outside its vector
  loop; ``utils/cv.py``).
* ``eval_detector``, ``eval_landmarks`` and ``eval_pose`` at ``N`` within
  ``FACE_TOL`` of the JAX tool's numbers: the same renders, the SSD and the
  hourglass in bfloat16 on both sides.
* The OCR gap between the two renderers: the shipped recognizer and
  detector read the port's renders and the JAX package's (the same seeds
  and faces, in-domain and held out) with exact-match rates, character
  accuracies and mask IoUs within ``OCR_GAP`` of each other.  The renders
  are bit-equal, so the measured gap is 0 and so is the bar.
* Mirrors of ``tests/test_models.py::test_clip_heldout_scene_discrimination``
  (at least 7 of 8) and ``::test_ocr_detector_heldout_font_floor`` (IoU at
  least 0.85 at n 16, seed 19) on the port's renders and models.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from fvd_tpu.models import face_ssd as jssd  # noqa: E402
from fvd_tpu.models import landmarks_fan as jlf  # noqa: E402
from fvd_tpu.models import synthetic_text as jst  # noqa: E402
from fvd_tpu_torch.models import encoders, ocr  # noqa: E402
from fvd_tpu_torch.models.encoders import IMAGE_SIZE  # noqa: E402
from fvd_tpu_torch.models.synthetic_text import random_text  # noqa: E402
from fvd_tpu_torch.tools import eval_heldout as P  # noqa: E402
from fvd_tpu_torch.utils import cv  # noqa: E402
from fvd_tpu_torch.utils import text as T  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints")
sys.path.insert(0, os.path.join(ROOT, "tools"))
try:
    import eval_heldout as J  # noqa: E402
finally:
    sys.path.remove(os.path.join(ROOT, "tools"))

#: share of values of a 300-pixel render the warp's tail may move by one level
WARP_SHARE = 1e-4
N = 4
#: the face evaluations, both packages in bfloat16: IoU, % of crop, degrees
#: (measured at N = 4: 7.5e-4, 7.8e-3 and 4.5e-5)
FACE_TOL = {"det": 0.005, "lmk": 0.03, "pose": 0.01}
#: the measured gap of each OCR score between the two renderers
OCR_GAP = 0.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def same_state(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a.get_state(), b.get_state()))


@pytest.mark.parametrize("size", [192, 256, 300])
def test_render_face_heldout_matches_jax(size):
    for seed in range(6):
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        aperture = 0.3 if seed % 2 else None
        ij, bj, pj = J.render_face_heldout(rj, size, aperture)
        ip, bp, pp = P.render_face_heldout(rp, size, aperture)
        np.testing.assert_array_equal(bp, bj)
        np.testing.assert_array_equal(pp, pj)
        assert same_state(rp, rj)
        d = np.abs(ip.astype(int) - ij)
        if size % 16 == 0:
            assert d.max() == 0
        else:
            assert d.max() <= 1 and (d > 0).mean() <= WARP_SHARE and not d[:, : size - size % 16].any()


@pytest.fixture(scope="module")
def jax_face_evals():
    """The JAX tool's face evaluations at ``N``; the templates the
    checkpoints load into are shapes only (their eager inits take seconds)."""
    patch = pytest.MonkeyPatch()
    for module, name in ((jlf, "init_landmark_params"), (jlf, "init_pose_params"), (jssd, "init_params")):
        init = getattr(module, name)
        patch.setattr(module, name, lambda rng, width=32, _init=init: jax.eval_shape(
            functools.partial(_init, width=width), rng))
    try:
        return {"det": J.eval_detector(N), "lmk": J.eval_landmarks(N), "pose": J.eval_pose(N)}
    finally:
        patch.undo()


@pytest.mark.parametrize("name", ["det", "lmk", "pose"])
def test_face_evaluations_match_jax(jax_face_evals, name):
    fn = {"det": P.eval_detector, "lmk": P.eval_landmarks, "pose": P.eval_pose}[name]
    got, want = fn(N, device="cpu"), jax_face_evals[name]
    for key in ("in_domain", "held_out"):
        assert abs(got[key] - want[key]) <= FACE_TOL[name], (name, key, got[key], want[key])


def _jax_lines(n, seed, fonts):
    """``eval_ocr``'s lines from the JAX package's renderer."""
    rng = np.random.RandomState(seed)
    lines, texts = np.zeros((n, ocr.LINE_H, ocr.LINE_W, 1), np.float32), []
    for i in range(n):
        text = jst.random_text(rng, 4, 12)
        font = None if fonts is None else fonts[rng.randint(len(fonts))]
        lines[i] = jst.scene_crop_line(rng, text, font=font)
        texts.append(text)
    return lines, texts


def _jax_scenes(n, seed, fonts):
    rng = np.random.RandomState(seed)
    imgs, masks = np.zeros((n, ocr.DET_SIZE, ocr.DET_SIZE, 3), np.float32), np.zeros((n, ocr.DET_SIZE, ocr.DET_SIZE))
    for i in range(n):
        font = None if fonts is None else fonts[rng.randint(len(fonts))]
        img, masks[i] = jst.detector_sample(rng, font=font)
        imgs[i] = img / 255.0
    return imgs, masks


@pytest.mark.parametrize("fonts", [None, P.HELD_OUT_FONTS], ids=["in_domain", "held_out"])
def test_ocr_scores_on_both_renderers(fonts):
    """The shipped models read the port's renders as they read the JAX
    package's: the recognizer's exact-match rate and character accuracy on
    ``eval_ocr``'s lines, the detector's mask IoU on ``eval_ocr_det``'s
    scenes (n 16, the tools' seeds)."""
    rec = ocr.load_recognizer(os.path.join(CKPT, "ocr_rec.npz"), 32, "cpu")
    det, _, _ = ocr.load_detector(os.path.join(CKPT, "ocr_det.npz"), "cpu")
    scores = {}
    for side, lines_fn, scenes_fn in (("port", P.ocr_lines, P.ocr_det_scenes), ("jax", _jax_lines, _jax_scenes)):
        lines, texts = lines_fn(16, 17, fonts)
        exact, chars = P.read_scores(ocr.ctc_greedy_decode(
            ocr.recognize_forward(rec, torch.from_numpy(lines)).numpy()), texts)
        imgs, masks = scenes_fn(16, 19, fonts)
        iou = P.mask_iou(ocr.detect_forward(det, torch.from_numpy(imgs.astype(np.float32))).numpy(), masks)
        scores[side] = np.array([exact, chars, iou])
    assert np.abs(scores["port"] - scores["jax"]).max() <= OCR_GAP, scores
    # the shipped models read what they were trained to read
    assert scores["port"][1] >= 0.9 and scores["port"][2] >= 0.85, scores


def test_clip_heldout_scene_discrimination():
    """``tests/test_models.py``'s check on the port: the shipped CLIP tells a
    held-out face from a background, and a held-out face's text from other
    text, in at least 7 of 8 scenes."""
    import json

    with open(os.path.join(CKPT, "clip.json")) as f:
        meta = json.load(f)
    keys = ("dim", "depth", "out_dim", "cal_offset", "cal_scale")
    clip = encoders.JaxClip(checkpoint=os.path.join(CKPT, "clip.npz"), device="cpu",
                            **{k: meta[k] for k in keys if k in meta})
    rng = np.random.RandomState(9)
    ok = total = 0
    for i in range(8):
        if i % 2 == 0:
            img, _, _ = P.render_face_heldout(rng, IMAGE_SIZE)
            a = clip.image_text_similarity(img, "a person's face looking at the camera")
            b = clip.image_text_similarity(img, "an empty textured background")
        else:
            text = random_text(rng, 3, 10)
            img = cv.blur_u8((rng.rand(IMAGE_SIZE, IMAGE_SIZE, 3) * 70).astype(np.uint8), 3)
            font = [T.FONT_HERSHEY_DUPLEX, T.FONT_HERSHEY_COMPLEX, T.FONT_HERSHEY_TRIPLEX][rng.randint(3)]
            T.put_text(img, text, (4, rng.randint(30, IMAGE_SIZE - 10)), font, rng.uniform(0.45, 0.7),
                       (235, 235, 235), 2)
            a = clip.image_text_similarity(img, f"text saying {text}")
            b = clip.image_text_similarity(img, f"text saying {random_text(rng, 3, 10)}")
        total += 1
        ok += int(a > b)
    assert ok >= 7, f"held-out CLIP discrimination {ok}/{total}"


def test_ocr_detector_heldout_font_floor():
    """``tests/test_models.py``'s floor on the port: the shipped detector
    finds text in faces its training never drew, IoU at least 0.85."""
    model, _, _ = ocr.load_detector(os.path.join(CKPT, "ocr_det.npz"), "cpu")
    rng = np.random.RandomState(19)
    n = 16
    imgs = np.zeros((n, ocr.DET_SIZE, ocr.DET_SIZE, 3), np.float32)
    masks = np.zeros((n, ocr.DET_SIZE, ocr.DET_SIZE), np.float32)
    fonts = [T.FONT_HERSHEY_DUPLEX, T.FONT_HERSHEY_COMPLEX, T.FONT_HERSHEY_TRIPLEX,
             T.FONT_HERSHEY_SIMPLEX | T.FONT_ITALIC]
    for i in range(n):
        img, masks[i] = P.detector_sample(rng, font=fonts[rng.randint(len(fonts))])
        imgs[i] = img.astype(np.float32) / 255.0
    iou = P.mask_iou(ocr.detect_forward(model, torch.from_numpy(imgs)).numpy(), masks)
    assert iou >= 0.85, f"held-out-font OCR detection IoU regressed: {iou}"


def test_main_runs_every_mode(tmp_path):
    out = str(tmp_path / "r.json")
    res = P.main(["--n", "2", "--cpu", "--json", out])
    assert set(res) == {"det", "lmk", "pose", "ocr", "ocr_det"}
    assert all(np.isfinite([r["in_domain"], r["held_out"]]).all() for r in res.values())
    assert os.path.getsize(out) > 0
