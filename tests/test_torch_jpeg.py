"""The port's JPEG codec and Laplacian (``fvd_tpu_torch/utils/{jpeg,cv}.py``)
against OpenCV, which the JAX package's V5, C2 and recorded LLM call:
``encode_jpeg`` must give the bytes of ``cv2.imencode(".jpg")`` with its
defaults, ``decode_jpeg_gray`` the pixels of ``cv2.imdecode(...,
IMREAD_GRAYSCALE)`` and ``laplacian_f32`` the values of ``cv2.Laplacian``,
exactly, on odd sizes and on the images V5 and C2 send: a V1-sized face crop,
its ELA map and its 3-channel spectrum, and a keyframe."""

import cv2
import numpy as np
import pytest

from fvd_tpu_torch.ops import forensics
from fvd_tpu_torch.synthetic import draw_face
from fvd_tpu_torch.utils.cv import laplacian_f32
from fvd_tpu_torch.utils.jpeg import decode_jpeg_gray, encode_jpeg

SIZES = [(1, 1), (7, 13), (8, 8), (15, 17), (16, 16), (120, 160), (2, 3), (17, 1), (1, 40), (33, 47)]


def _image(h, w, kind, seed=0):
    rng = np.random.RandomState(seed + 7 * h + w)
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    return np.stack([(yy * 7 + xx * 3) % 256, (xx * 5) % 256, (yy * 11) % 256], -1).astype(np.uint8)


def _keyframe(height=240, width=320):
    """A frame of the port's synthetic face clip and V1's crop box of it."""
    rng = np.random.RandomState(3)
    frame = (rng.rand(height, width, 3) * 60 + 90).astype(np.uint8)
    fh = 0.62 * height
    fw = fh / 1.25
    draw_face(frame, width / 2, height / 2, fw, fh, np.array([200, 150, 130]), aperture=0.6)
    x1, y1 = int(width / 2 - fw / 2), int(height / 2 - fh / 2)
    return frame, frame[y1: y1 + int(fh), x1: x1 + int(fw)]


def _v5_images():
    """(crop, ELA map, 3-channel spectrum) as V5 makes them, at the
    crop sizes of a 320x240 and a 96x72 clip."""
    out = {}
    for height, width in ((240, 320), (72, 96)):
        _, crop = _keyframe(height, width)
        crop = np.ascontiguousarray(crop)
        ela = np.asarray(forensics.ela_batch([crop], 90, device="cpu")[0]).astype(np.uint8)
        spectrum = forensics.fft_spectrum_host(forensics.rgb_to_gray_host(crop)).astype(np.uint8)
        out[f"crop_{height}"] = crop
        out[f"ela_{height}"] = ela
        out[f"spectrum_{height}"] = np.stack([spectrum] * 3, axis=-1)
    out["keyframe"] = _keyframe()[0]
    return out


V5_NAMES = ["crop_240", "crop_72", "ela_240", "ela_72", "keyframe", "spectrum_240", "spectrum_72"]


@pytest.fixture(scope="module")
def v5_images():
    images = _v5_images()
    assert sorted(images) == V5_NAMES
    return images


def _cv2_jpeg(rgb, params=()):
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR), list(params))
    assert ok
    return buf.tobytes()


def _first_difference(a, b):
    return next((i for i in range(min(len(a), len(b))) if a[i] != b[i]), min(len(a), len(b)))


@pytest.mark.parametrize("kind", ["noise", "ramp"])
@pytest.mark.parametrize("h,w", SIZES)
def test_encode_equals_cv2_imencode(h, w, kind):
    img = _image(h, w, kind)
    ours, theirs = encode_jpeg(img), _cv2_jpeg(img)
    assert ours == theirs, f"first differing byte at {_first_difference(ours, theirs)} of {len(theirs)}"


@pytest.mark.parametrize("name", V5_NAMES)
def test_encode_equals_cv2_on_v5_and_c2_images(v5_images, name):
    img = v5_images[name]
    ours, theirs = encode_jpeg(img), _cv2_jpeg(img)
    assert img.shape[0] > 16 and img.shape[1] > 16
    assert ours == theirs, f"first differing byte at {_first_difference(ours, theirs)} of {len(theirs)}"


def test_encode_saturated_and_flat_images():
    rng = np.random.RandomState(5)
    for img in (np.zeros((9, 11, 3), np.uint8), np.full((9, 11, 3), 255, np.uint8),
                rng.choice([0, 255], (23, 29, 3)).astype(np.uint8)):
        assert encode_jpeg(img) == _cv2_jpeg(img)


@pytest.mark.parametrize("h,w", SIZES)
def test_decode_gray_equals_cv2_imdecode(h, w):
    img = _image(h, w, "noise", seed=1)
    data = encode_jpeg(img)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    got = decode_jpeg_gray(data)
    assert got.dtype == np.uint8 and got.shape == (h, w)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params", [
    (), (cv2.IMWRITE_JPEG_QUALITY, 50), (cv2.IMWRITE_JPEG_QUALITY, 100), (cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
    (cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
    (cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422), (cv2.IMWRITE_JPEG_OPTIMIZE, 1),
], ids=["default", "q50", "q100", "restart3", "444", "422", "optimized"])
def test_decode_gray_equals_cv2_on_cv2_bytes(v5_images, params):
    """OpenCV's own files, with settings other than the encoder's too."""
    for name in ("crop_240", "keyframe"):
        data = _cv2_jpeg(v5_images[name], params)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(decode_jpeg_gray(data), want)


def test_decode_gray_of_grayscale_file_and_non_jpeg(v5_images):
    gray = np.random.RandomState(2).randint(0, 256, (37, 53)).astype(np.uint8)
    data = cv2.imencode(".jpg", gray)[1].tobytes()
    np.testing.assert_array_equal(decode_jpeg_gray(data),
                                  cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE))
    for junk in (b"not a jpeg", b"\x89PNG\r\n\x1a\n"):
        assert cv2.imdecode(np.frombuffer(junk, np.uint8), cv2.IMREAD_GRAYSCALE) is None
        assert decode_jpeg_gray(junk) is None
    assert decode_jpeg_gray(b"") is None
    progressive = _cv2_jpeg(v5_images["crop_72"], (cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    with pytest.raises(ValueError, match="unsupported frame type"):
        decode_jpeg_gray(progressive)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 9), (9, 1), (2, 2), (2, 1), (13, 17), (120, 160)])
def test_laplacian_equals_cv2(h, w):
    img = np.random.RandomState(h * 31 + w).randint(0, 256, (h, w)).astype(np.uint8)
    want = cv2.Laplacian(img.astype(np.float32), cv2.CV_32F)
    got = laplacian_f32(img)
    assert got.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)
    assert float(np.mean(np.abs(got))) == float(np.mean(np.abs(want)))


def test_texture_statistic_of_decoded_crop_equals_cv2(v5_images):
    """The recorded LLM's statistic, end to end: mean |Laplacian| of the
    decoded crop, ours against OpenCV's on OpenCV's bytes."""
    for name in ("crop_240", "crop_72", "ela_240", "spectrum_240"):
        data = encode_jpeg(v5_images[name])
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
        want = float(np.mean(np.abs(cv2.Laplacian(ref.astype(np.float32), cv2.CV_32F))))
        assert float(np.mean(np.abs(laplacian_f32(decode_jpeg_gray(data))))) == want
