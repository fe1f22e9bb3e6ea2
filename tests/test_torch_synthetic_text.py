"""``fvd_tpu_torch/models/synthetic_text.py`` against
``fvd_tpu/models/synthetic_text.py`` on the CPU: the same ``RandomState``
gives the same texts, CTC labels, detector masks and RNG state after every
batch, and the same pixels.  The pixel gap is measured and held: none (the
text is OpenCV 5's, bit for bit, and so are the blurs, warps, morphology,
resize and grey conversion), at every seed, face and augment setting here."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from fvd_tpu.models import synthetic_text as J  # noqa: E402
from fvd_tpu_torch.models import synthetic_text as P  # noqa: E402

#: the measured max |d| of the port's pixels to the JAX package's (lines in
#: 0..1, scenes in uint8 levels)
LINE_GAP, SCENE_GAP = 0.0, 0
SEEDS = (0, 1, 2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def same_state(a: np.random.RandomState, b: np.random.RandomState) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a.get_state(), b.get_state()))


def test_alphabet_and_train_fonts_are_jax():
    assert P.ALPHABET == J.ALPHABET
    faces = {J._train_font(np.random.RandomState(s)) for s in range(200)}
    assert faces == set(P.TRAIN_FONTS)
    for s in range(20):
        assert P._train_font(np.random.RandomState(s)) == J._train_font(np.random.RandomState(s))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("augment", [False, True])
def test_recognizer_batch_matches_jax(seed, augment):
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):
        lj, labj, tj = J.recognizer_batch(rj, 12, augment=augment)
        lp, labp, tp = P.recognizer_batch(rp, 12, augment=augment)
        assert tp == tj
        np.testing.assert_array_equal(labp, labj)
        assert same_state(rp, rj)
        assert np.abs(lp - lj).max() <= LINE_GAP


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("augment", [False, True])
def test_detector_batch_matches_jax(seed, augment):
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    ij, mj = J.detector_batch(rj, 6, augment=augment)
    ip, mp = P.detector_batch(rp, 6, augment=augment)
    np.testing.assert_array_equal(mp, mj)
    assert same_state(rp, rj)
    assert np.abs(ip - ij).max() * 255 <= SCENE_GAP


@pytest.mark.parametrize("font", [None, 0, 1, 2, 3, 4, 5, 6, 7, 16, 17, 21])
def test_detector_sample_every_font_override_matches_jax(font):
    for seed in SEEDS:
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        for augment in (False, True):
            img_j, mask_j = J.detector_sample(rj, augment=augment, font=font)
            img_p, mask_p = P.detector_sample(rp, augment=augment, font=font)
            np.testing.assert_array_equal(mask_p, mask_j)
            assert same_state(rp, rj)
            assert np.abs(img_p.astype(int) - img_j).max() <= SCENE_GAP


@pytest.mark.parametrize("font", [None, cv2.FONT_HERSHEY_DUPLEX, cv2.FONT_HERSHEY_COMPLEX,
                                  cv2.FONT_HERSHEY_TRIPLEX, cv2.FONT_HERSHEY_SIMPLEX | cv2.FONT_ITALIC])
def test_scene_crop_line_and_render_line_match_jax(font):
    for seed in SEEDS:
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        for lo, hi in ((3, 12), (4, 18)):
            text = J.random_text(rj, lo, hi)
            assert P.random_text(rp, lo, hi) == text
            assert np.abs(P.scene_crop_line(rp, text, font) - J.scene_crop_line(rj, text, font)).max() <= LINE_GAP
            assert np.abs(P.render_line(rp, text, font) - J.render_line(rj, text, font)).max() <= LINE_GAP
            line = J.render_line(rj, text)
            assert np.abs(P._augment_line(rp, P.render_line(rp, text)) - J._augment_line(rj, line)).max() <= LINE_GAP
            assert same_state(rp, rj)


def test_scene_crop_labels_fit_the_ctc_frames():
    """``scene_crop_line`` strings stay within 18 characters, well inside
    the recognizer's 64 frames: ``ctc_loss`` never meets an impossible
    label."""
    rng = np.random.RandomState(5)
    _, labels, texts = P.recognizer_batch(rng, 64, augment=True)
    assert max(len(t) for t in texts) <= 18 and ((labels != 0).sum(1) <= 18).all()
