"""The OpenCV calls of the OCR and CLIP data generators, from
``fvd_tpu_torch/utils/cv.py``, against ``cv2`` on the CPU: ``blur`` on uint8
(3x3, 5x5, 7x7, three channels), ``GaussianBlur`` 3x3 on float32 with sigma
in [0.3, 1), ``erode`` and ``dilate`` with a 2x2 kernel of ones on float32,
and ``warpAffine`` on float32 with ``BORDER_REPLICATE`` (the recognizer
lines' shear).  Every one is held bit for bit (0 ulps) at the shapes the
generators use."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from fvd_tpu_torch.utils import cv  # noqa: E402

#: the largest float32 gap, in units in the last place, at the lines' [32, 256]
F32_ULPS = 0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


def _line(rng):
    """A recognizer line as ``render_line`` leaves it: float32 in 0..1."""
    return (rng.randint(0, 256, (32, 256)).astype(np.float32) / 255.0).astype(np.float32)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("shape", [(112, 112, 3), (256, 256, 3), (300, 300, 3), (37, 53, 3), (20, 31)])
def test_blur_u8_is_cv2s(k, shape):
    rng = np.random.RandomState(k * 100 + shape[0])
    img = (rng.rand(*shape) * rng.randint(40, 256)).astype(np.uint8)
    np.testing.assert_array_equal(cv.blur_u8(img, k), cv2.blur(img, (k, k)))


def test_gaussian_kernel_is_cv2s():
    for sigma in np.random.RandomState(1).uniform(0.3, 1.0, 2000):
        np.testing.assert_array_equal(cv.gaussian_kernel_f32(3, sigma),
                                      cv2.getGaussianKernel(3, sigma, cv2.CV_32F).ravel())


@pytest.mark.parametrize("seed", range(3))
def test_gaussian_blur3_f32_is_cv2s(seed):
    rng = np.random.RandomState(seed)
    for _ in range(10):
        img, sigma = _line(rng), rng.uniform(0.3, 1.0)
        assert ulps(cv.gaussian_blur_f32(img, 3, sigma), cv2.GaussianBlur(img, (3, 3), sigma)) <= F32_ULPS


@pytest.mark.parametrize("seed", range(3))
def test_erode_dilate_2x2_are_cv2s(seed):
    rng = np.random.RandomState(seed)
    k = np.ones((2, 2), np.uint8)
    for img in (_line(rng), rng.rand(17, 23).astype(np.float32)):
        np.testing.assert_array_equal(cv.dilate2_f32(img), cv2.dilate(img, k))
        np.testing.assert_array_equal(cv.erode2_f32(img), cv2.erode(img, k))


@pytest.mark.parametrize("seed", range(3))
def test_warp_affine_f32_replicate_is_cv2s(seed):
    """The shear of ``_augment_line``: ``[[1, s, -s h / 2], [0, 1, 0]]``."""
    rng = np.random.RandomState(seed)
    for _ in range(10):
        img, s = _line(rng), rng.uniform(-0.25, 0.25)
        m = np.float32([[1, s, -s * 32 / 2], [0, 1, 0]])
        got = cv.warp_affine_f32(img, m, 256, 32)
        assert ulps(got, cv2.warpAffine(img, m, (256, 32), borderMode=cv2.BORDER_REPLICATE)) <= F32_ULPS
