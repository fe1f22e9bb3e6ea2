"""The OpenCV calls of the realism levers, held to this machine's OpenCV on
the CPU: ``cv.gaussian_blur_f32`` (``cv2.GaussianBlur(x, (k, k), 0)`` on
float32 for odd ``k`` from 3 to 95), ``cv.filter2d``
(``cv2.filter2D(x, -1, kernel)`` on float32 and float64 with the motion-blur
kernels of ``photometric_randomize``, warped by ``cv.warp_affine_zero_f32``),
``cv.resize_linear_f32`` (``cv2.resize`` on float32),
``jpeg.encode_jpeg(..., quality=q)`` (``cv2.imencode``'s bytes) and
``jpeg.decode_jpeg_color`` (``cv2.imdecode(..., IMREAD_COLOR)``), and the
one-pixel elliptic arcs ``portrait_realism`` draws.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from fvd_tpu_torch.utils import cv, draw, jpeg  # noqa: E402
from test_torch_train_losses import one_torch_thread  # noqa: E402,F401

#: the levers' images: 300 (detector), 256 (landmarks) and 192 (pose) wide,
#: grey (the mottle noise, the face mask) and 3-channel (the feathered face)
LEVER_SHAPES = ((300, 300), (300, 300, 3), (256, 256, 3), (192, 192))
#: the widths at which a row's last one to three values (pixels times
#: channels past a multiple of 4) go through OpenCV's scalar C++, whose
#: summation order for ``k >= 7`` is not ported
ODD_SHAPES = ((61, 67, 3), (40, 77))
#: |d| there, relative to the image's largest |value| (measured 2.4e-7)
ODD_RTOL = 2e-6


def _noise(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 40).astype(np.float32)


@pytest.mark.parametrize("k", range(3, 97, 2))
def test_gaussian_blur_is_opencvs(k):
    np.testing.assert_array_equal(cv.gaussian_kernel_f32(k), cv2.getGaussianKernel(k, 0, cv2.CV_32F).ravel())
    for i, shape in enumerate(LEVER_SHAPES):
        x = _noise(shape, k + i)
        np.testing.assert_array_equal(cv.gaussian_blur_f32(x, k), cv2.GaussianBlur(x, (k, k), 0))
    for i, shape in enumerate(ODD_SHAPES):
        if k // 2 < min(shape[:2]):
            x = _noise(shape, 100 + k + i)
            np.testing.assert_allclose(cv.gaussian_blur_f32(x, k), cv2.GaussianBlur(x, (k, k), 0),
                                       rtol=0, atol=ODD_RTOL * np.abs(x).max())


def test_gaussian_blur_feather_sizes_on_a_mask():
    """The feathered edge blurs a 0/1 face mask at 3, 5 and 7 taps."""
    for k in (3, 5, 7):
        mask = np.zeros((256, 256), np.float32)
        cv2.ellipse(mask, (120, 130), (70, 90), 0, 0, 360, 1.0, -1)
        np.testing.assert_array_equal(cv.gaussian_blur_f32(mask, k), cv2.GaussianBlur(mask, (k, k), 0))


def _motion_kernel(rng, k):
    """``photometric_randomize``'s kernel: one row of ones rotated about the
    centre, normalised; the port's warp against OpenCV's."""
    kern = np.zeros((k, k), np.float32)
    kern[k // 2, :] = 1.0
    rot = cv.rotation_matrix_2d((k / 2 - 0.5, k / 2 - 0.5), float(rng.uniform(0, 180)), 1.0)
    got = cv.warp_affine_zero_f32(kern, rot, k, k)
    np.testing.assert_array_equal(got, cv2.warpAffine(kern, rot, (k, k)))
    return got / max(float(got.sum()), 1e-6)


@pytest.mark.parametrize("k", range(3, 10))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_filter2d_is_opencvs(k, dtype):
    rng = np.random.RandomState(k)
    for shape in ((300, 300, 3), (97, 101, 3), (64, 77)):
        kern = _motion_kernel(rng, k)
        x = (rng.rand(*shape) * 255).astype(dtype)
        got, ref = cv.filter2d(x, kern), cv2.filter2D(x, -1, kern)
        assert got.dtype == ref.dtype == dtype
        if dtype == np.float64 and k * k >= 50:
            # OpenCV filters float64 with 50 taps or more through the DFT
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
        else:
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape,size", [((256, 256, 3), 128), ((256, 256), 128), ((91, 77, 3), 128)])
def test_resize_linear_f32_is_opencvs(shape, size):
    """Bit for bit where ``src / dst`` is exact in float32: the paired
    evaluation's 256 -> 128 shrink among them."""
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    np.testing.assert_array_equal(cv.resize_linear_f32(x, size, size), cv2.resize(x, (size, size)))


def test_resize_linear_f32_at_other_ratios():
    """OpenCV rounds the source coordinates of other ratios apart from
    ``fma(src / dst, x, (src / dst - 1) / 2)``: within 1e-3 at 255."""
    x = np.random.RandomState(1).rand(100, 90, 3).astype(np.float32) * 255
    np.testing.assert_allclose(cv.resize_linear_f32(x, 37, 53), cv2.resize(x, (37, 53)), rtol=0, atol=2e-3)


def _jpeg_image(shape, seed):
    rng = np.random.RandomState(seed)
    return cv2.GaussianBlur((rng.rand(*shape) * 255).astype(np.uint8), (5, 5), 0)


@pytest.mark.parametrize("quality", [30, 55, 91, 95])
@pytest.mark.parametrize("shape", [(255, 257, 3), (300, 300, 3), (17, 9, 3), (192, 192, 3)])
def test_jpeg_encode_and_colour_decode_are_opencvs(quality, shape):
    rgb = _jpeg_image(shape, quality)
    ref = cv2.imencode(".jpg", rgb[..., ::-1], [int(cv2.IMWRITE_JPEG_QUALITY), quality])[1].tobytes()
    assert jpeg.encode_jpeg(rgb, quality=quality) == ref
    np.testing.assert_array_equal(jpeg.decode_jpeg_color(ref),
                                  cv2.imdecode(np.frombuffer(ref, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])


def test_jpeg_default_quality_is_95():
    rgb = _jpeg_image((64, 80, 3), 0)
    assert jpeg.encode_jpeg(rgb) == jpeg.encode_jpeg(rgb, quality=95)


def test_jpeg_colour_decode_of_a_grey_file():
    grey = _jpeg_image((33, 47, 3), 1)[..., 0]
    data = cv2.imencode(".jpg", grey)[1].tobytes()
    np.testing.assert_array_equal(jpeg.decode_jpeg_color(data),
                                  cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])
    assert jpeg.decode_jpeg_color(b"not a jpeg") is None


@pytest.mark.parametrize("start,end", [(180, 360), (0, 360)])
def test_one_pixel_arcs_are_opencvs(start, end):
    """The socket arcs: OpenCV 5 draws a one-pixel line of a polyline with
    fraction bits between its rounded end points."""
    rng = np.random.RandomState(end)
    for _ in range(200):
        center = (int(rng.randint(20, 280)), int(rng.randint(20, 280)))
        axes = (int(rng.randint(1, 30)), int(rng.randint(1, 20)))
        a = np.zeros((300, 300, 3), np.uint8)
        b = a.copy()
        cv2.ellipse(a, center, axes, 0, start, end, (60, 45, 40), 1)
        draw.ellipse(b, center, axes, 0, start, end, (60, 45, 40), 1)
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("size", [300, 97, 9])
def test_warp_affine_u8_is_opencvs_in_every_column(size):
    """Past the 16-pixel vector loop the source coordinates are OpenCV's
    scalar ``fma(x, m0, y * m1) + m2``."""
    rng = np.random.RandomState(size)
    for _ in range(5):
        img = rng.randint(0, 256, (size, size, 3)).astype(np.uint8)
        M = cv2.getRotationMatrix2D(tuple(rng.uniform(0, size, 2)), rng.uniform(-20, 20), 1.0)
        np.testing.assert_array_equal(cv.warp_affine_u8(img, M, size, size),
                                      cv2.warpAffine(img, M, (size, size), flags=cv2.INTER_LINEAR))
