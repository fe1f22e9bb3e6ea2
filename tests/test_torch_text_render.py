"""``fvd_tpu_torch/utils/text.py`` against OpenCV 5's ``cv2.getTextSize``
and ``cv2.putText`` on the CPU, and the committed glyph atlas against a fresh
measurement by ``python -m fvd_tpu_torch.tools.make_text_atlas``.

The sizes are held equal on every draw; the pixels are held to the measured
gap, which is none: mean and max |d| of 0 over every draw, on 1 and 3
channels, with text crossing every edge of the image."""

import os
import string

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from fvd_tpu_torch.tools import make_text_atlas  # noqa: E402
from fvd_tpu_torch.utils import text as T  # noqa: E402

#: the measured pixel gap of put_text to cv2.putText (mean and max |d|)
PIXEL_MEAN_GAP, PIXEL_MAX_GAP = 0.0, 0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _text(rng, lo=1, hi=18):
    return "".join(T.ALPHABET[j] for j in rng.randint(0, len(T.ALPHABET), rng.randint(lo, hi + 1)))


def test_alphabet_is_the_ocr_alphabet_and_constants_are_cv2s():
    assert T.ALPHABET == string.ascii_uppercase + string.digits + " "
    for name in ("SIMPLEX", "PLAIN", "DUPLEX", "COMPLEX", "TRIPLEX", "COMPLEX_SMALL", "SCRIPT_SIMPLEX",
                 "SCRIPT_COMPLEX"):
        assert getattr(T, f"FONT_HERSHEY_{name}") == getattr(cv2, f"FONT_HERSHEY_{name}")
    assert T.FONT_ITALIC == cv2.FONT_ITALIC


@pytest.mark.parametrize("part", range(4))
def test_get_text_size_equals_cv2(part):
    """1 500 draws a part, 6 000 in all: faces 0-7 with and without ITALIC,
    thickness 1-3, scales over the generators' range and the detector's
    rescale to fit ``DET_SIZE - 8``."""
    rng = np.random.RandomState(100 + part)
    for _ in range(1500):
        face = int(rng.randint(8)) | (T.FONT_ITALIC if rng.rand() < 0.5 else 0)
        thickness = int(rng.randint(1, 4))
        text = _text(rng)
        scale = rng.uniform(0.4, 1.6)
        if rng.rand() < 0.3:  # the rescale of scene_crop_line and detector_sample
            (tw, _), _ = cv2.getTextSize(text, face, scale, thickness)
            scale *= 248 / max(tw, 1)
            if T._pixel_size(face, scale) >= T.METRIC_SIZES:
                continue
        assert T.get_text_size(text, face, scale, thickness) == cv2.getTextSize(text, face, scale, thickness), \
            (text, face, scale, thickness)


@pytest.mark.parametrize("channels", [1, 3])
def test_put_text_pixels_match_cv2(channels):
    rng = np.random.RandomState(channels)
    gaps = []
    for _ in range(300):
        face = int(rng.randint(8)) | (T.FONT_ITALIC if rng.rand() < 0.3 else 0)
        thickness = int(rng.randint(1, 4))
        scale = rng.uniform(0.4, 1.6)
        shape = (int(rng.randint(16, 96)), int(rng.randint(16, 260))) + ((3,) if channels == 3 else ())
        img = rng.randint(0, 256, shape).astype(np.uint8)
        color = int(rng.randint(256)) if channels == 1 else tuple(int(c) for c in rng.randint(0, 256, 3))
        org = (int(rng.randint(-20, shape[1])), int(rng.randint(-4, shape[0] + 20)))
        text = _text(rng)
        got = T.put_text(img.copy(), text, org, face, scale, color, thickness)
        want = cv2.putText(img.copy(), text, org, face, scale, color, thickness)
        gaps.append(np.abs(got.astype(int) - want))
    assert np.mean([g.mean() for g in gaps]) <= PIXEL_MEAN_GAP
    assert max(int(g.max()) for g in gaps) <= PIXEL_MAX_GAP


def test_put_text_number_colour_on_three_channels_is_cv2s_scalar():
    """A bare number is ``Scalar(n, 0, 0, 0)``: the other channels get 0."""
    img = np.full((40, 120, 3), 77, np.uint8)
    got = T.put_text(img.copy(), "AB 12", (4, 30), T.FONT_HERSHEY_SIMPLEX, 0.9, 200, 2)
    np.testing.assert_array_equal(got, cv2.putText(img.copy(), "AB 12", (4, 30), 0, 0.9, 200, 2))


def test_refuses_what_the_atlas_does_not_hold():
    with pytest.raises(ValueError, match="not in the atlas"):
        T.get_text_size("abc", 0, 1.0, 1)
    with pytest.raises(ValueError, match="glyphs are measured"):  # size 54
        T.put_text(np.zeros((10, 10), np.uint8), "A", (0, 9), 0, 2.0, 255, 1)
    with pytest.raises(TypeError):
        T.put_text(np.zeros((10, 10), np.float32), "A", (0, 9), 0, 0.5, 255, 1)


def test_committed_atlas_regenerates_byte_equal(tmp_path):
    out = str(tmp_path / "atlas.npz")
    assert make_text_atlas.main(["--out", out]) == 0
    with open(out, "rb") as a, open(T.ATLAS_PATH, "rb") as b:
        assert a.read() == b.read()
    assert os.path.getsize(T.ATLAS_PATH) < 2 * 1024 * 1024
