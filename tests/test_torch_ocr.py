"""``fvd_tpu_torch/models/ocr.py`` and ``utils/cv.py`` against
``fvd_tpu/models/ocr.py`` and OpenCV on the CPU.

* The ``utils/cv.py`` helpers equal ``cv2`` bit for bit (resize, grey,
  connected components in cv2's label order) on seeded random inputs.
* The v1 detector and the recognizer at float32 from the same params: logits
  within ``TOL``.  The v2 detector computes in bfloat16 on both sides, so its
  masks are held to a share of equal pixels.
* ``JaxOCR`` on the shipped ``ocr_det.npz`` (v2, width 128) and
  ``ocr_rec.npz`` reads ``tests/test_factory.py``'s "MOON LANDING 1969" image
  as the JAX package does, on the host path and on the device path.
* V2 reads the frame tensor V1 put on the device, with no second upload.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvd_tpu.models import encoders as jenc
from fvd_tpu.models import ocr as jocr
from fvd_tpu.providers.factory import _build_ocr
from fvd_tpu_torch import weights
from fvd_tpu_torch.models import ocr as tocr
from fvd_tpu_torch.nodes import v2_ocr
from fvd_tpu_torch.providers import Providers, media
from fvd_tpu_torch.utils import cv

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
#: float32 on both sides; only the summation order differs
TOL = 1e-4
#: the share of mask pixels on which two bfloat16 runs of the v2 detector
#: must agree: bf16 keeps 8 mantissa bits, so logits within a few bf16 ulps
#: of the threshold may fall either side
MASK_AGREE = 0.999


# ----------------------------------------------------------------- utils/cv.py
RESIZES = [((240, 320), (112, 112)), ((240, 320), (256, 256)), ((256, 256), (112, 112)),
           ((1, 1), (32, 256)), ((2, 3), (32, 256)), ((3, 1), (32, 256)), ((1, 2), (32, 256)),
           ((3, 3), (32, 256)), ((37, 100), (32, 256)), ((120, 160), (240, 320)), ((64, 64), (32, 32)),
           ((7, 300), (32, 256))]


@pytest.mark.parametrize("src,dst", RESIZES)
@pytest.mark.parametrize("channels", [None, 3])
def test_resize_linear_u8_equals_cv2(src, dst, channels):
    shape = src if channels is None else src + (channels,)
    img = np.random.RandomState(src[0] * 1000 + src[1]).randint(0, 256, shape).astype(np.uint8)
    got = cv.resize_linear_u8(img, dst[1], dst[0])
    np.testing.assert_array_equal(got, cv2.resize(img, (dst[1], dst[0])))


def test_resize_linear_u8_equals_cv2_on_random_shapes():
    rng = np.random.RandomState(7)
    for _ in range(40):
        h, w, oh, ow = rng.randint(1, 300, 4)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(cv.resize_linear_u8(img, ow, oh), cv2.resize(img, (ow, oh)))


def test_rgb_to_gray_u8_equals_cv2_on_every_colour():
    v = np.arange(256)
    r, g, b = np.meshgrid(v, v, v, indexing="ij")
    img = np.stack([r, g, b], -1).reshape(4096, 4096, 3).astype(np.uint8)
    np.testing.assert_array_equal(cv.rgb_to_gray_u8(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    crop = img[:3, :5]
    np.testing.assert_array_equal(cv.rgb_to_gray_u8(crop),
                                  cv2.cvtColor(np.ascontiguousarray(crop), cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("density", [0.02, 0.1, 0.3, 0.5])
def test_component_boxes_equal_cv2_in_its_label_order(density):
    rng = np.random.RandomState(int(density * 100))
    masks = [(rng.rand(256, 256) < density)] + [rng.rand(*rng.randint(1, 60, 2)) < density for _ in range(30)]
    for m in masks:
        m = m.astype(np.uint8)
        n, _, stats, _ = cv2.connectedComponentsWithStats(m)
        assert cv.component_boxes(m) == [tuple(int(v) for v in stats[i]) for i in range(1, n)]


def test_component_order_follows_cv2_blocks_not_scipy_pixels():
    """A component starting on the second row of a 2x2 block row comes
    before one starting further right on its first row, as in cv2."""
    m = np.zeros((4, 8), np.uint8)
    m[1, 0] = m[0, 5] = 1
    n, _, stats, _ = cv2.connectedComponentsWithStats(m)
    assert cv.component_boxes(m) == [tuple(int(v) for v in stats[i]) for i in range(1, n)] == \
        [(0, 1, 1, 1, 1), (5, 0, 1, 1, 1)]


# ----------------------------------------------------------------- the models
def _load(model, params):
    model.load_state_dict(weights.to_state_dict(params), strict=True)
    return model.eval()


def test_v1_detector_matches_flax():
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    params = jocr.init_detector(jax.random.PRNGKey(0), width=16, arch="v1")
    want = np.asarray(jocr.TextRegionNet(width=16).apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _load(tocr.TextRegionNet(16), params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_shipped_recognizer_matches_flax():
    """(h, c) flattening per time step from NHWC: the Dense reads the
    features in flax's order."""
    params = weights.read_npz(os.path.join(CKPT, "ocr_rec.npz"))
    lines = np.random.RandomState(1).randint(0, 256, (3, tocr.LINE_H, tocr.LINE_W, 1)).astype(np.uint8)
    jparams = jenc.load_params(os.path.join(CKPT, "ocr_rec.npz"),
                               jocr.init_recognizer(jax.random.PRNGKey(0), width=32))
    want = np.asarray(jocr.recognize_forward(jparams, jnp.asarray(lines), width=32))
    got = tocr.recognize_forward(_load(tocr.CTCRecognizer(32), params), torch.from_numpy(lines)).numpy()
    assert got.shape == (3, 64, tocr.CTC_CLASSES)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def ocrs():
    return (_build_ocr(os.path.join(CKPT, "ocr_det.npz"), os.path.join(CKPT, "ocr_rec.npz")),
            tocr.JaxOCR.from_checkpoints(os.path.join(CKPT, "ocr_det.npz"), os.path.join(CKPT, "ocr_rec.npz"),
                                         device="cpu"))


def _moon_image():
    img = (np.random.RandomState(0).rand(256, 256, 3) * 80).astype(np.uint8)
    img = cv2.blur(img, (5, 5))
    cv2.putText(img, "MOON LANDING 1969", (20, 100), cv2.FONT_HERSHEY_SIMPLEX, 0.7, (230, 230, 230), 2)
    return img


def _frames():
    """Three 240x320 frames with text, as V1's keyframes are shaped."""
    rng = np.random.RandomState(1)
    frames = (rng.rand(3, 240, 320, 3) * 80).astype(np.uint8)
    for i, f in enumerate(frames):
        cv2.putText(f, f"EAR 0.2{i}", (30, 120), cv2.FONT_HERSHEY_SIMPLEX, 1.0, (230, 230, 230), 2)
    return frames


def _texts(out):
    return [[(d["text"], d["bbox"]) for d in frame] for frame in out]


def test_shipped_detector_masks_match_jax(ocrs):
    """The device path's masks (resize on the device with jax.image's linear
    rule, logit threshold) against the JAX package's unpacked bits."""
    j, t = ocrs
    assert t.det_arch == j.det_arch == "v2" and t.det_width == 128
    for frames in (_moon_image()[None], _frames()):
        got = tocr.detect_packed_mask(t.detector, torch.from_numpy(frames)).numpy()
        packed = np.asarray(jocr.detect_packed_mask(j.det_params, jnp.asarray(frames), width=128, arch="v2"))
        want = np.unpackbits(packed, axis=1)[:, : 256 * 256].reshape(-1, 256, 256).astype(bool)
        assert want.sum() > 1000
        assert (got == want).mean() >= MASK_AGREE


def test_shipped_ocr_reads_the_moon_image_as_jax(ocrs):
    j, t = ocrs
    img = _moon_image()
    want = j.read_text(img)
    got = t.read_text(img)
    assert _texts([got]) == _texts([want])
    assert any("MOON" in d["text"] and "1969" in d["text"] for d in got), got
    np.testing.assert_allclose([d["confidence"] for d in got], [d["confidence"] for d in want], atol=TOL)
    dev = t.read_text_batch_device(torch.from_numpy(img[None]), [img])
    assert _texts(dev) == _texts([got])


def test_shipped_ocr_reads_frames_as_jax_on_both_paths(ocrs):
    j, t = ocrs
    frames = list(_frames())
    host = t.read_text_batch(frames)
    assert _texts(host) == _texts(j.read_text_batch(frames))
    dev = t.read_text_batch_device(torch.from_numpy(np.stack(frames)), frames)
    assert _texts(dev) == _texts(j.read_text_batch_device(jnp.asarray(np.stack(frames)), frames))
    assert all(any("EAR" in d["text"] for d in frame) for frame in dev), _texts(dev)


def test_region_boxes_match_jax():
    probs = np.random.RandomState(4).rand(256, 256).astype(np.float32)
    probs = cv2.blur(probs, (9, 9))
    assert tocr.region_boxes(probs, 0.52) == jocr.region_boxes(probs, 0.52) != []


def test_ctc_greedy_decode_matches_jax():
    logits = np.random.RandomState(5).randn(4, 64, tocr.CTC_CLASSES).astype(np.float32)
    logits[0, :, 0] += 10  # all blank
    assert tocr.ctc_greedy_decode(logits) == jocr.ctc_greedy_decode(logits)


# ----------------------------------------------------------------- V2's device path
def _v1_state(tmp_path, frames, ids):
    """What V1 leaves behind: keyframe paths under ``<run>/keyframes`` next
    to the run's ``video.mp4``, and the union grid's frames uploaded once."""
    run = tmp_path / "video_0"
    (run / "keyframes").mkdir(parents=True)
    video = str(run / "video.mp4")
    media.write_video(video, frames, 30.0)
    media.clear_frame_cache()
    media.VideoReader().sample(video, ids)
    media.device_frames_for(video, ids, frames, device="cpu")
    return [str(run / "keyframes" / f"frame_{i:06d}.png") for i in ids]


def test_v2_reads_the_frames_v1_uploaded(tmp_path, ocrs, monkeypatch):
    _, t = ocrs
    frames = _frames()
    keyframes = _v1_state(tmp_path, frames, [0, 1, 2])
    assert media._device_frames.uploads == 1
    monkeypatch.setattr(t, "read_text_batch", None)  # the host path must not run
    delta = v2_ocr.run({"keyframes": keyframes}, providers=Providers(ocr=t))
    assert media._device_frames.uploads == 1
    got = [[d["text"] for d in r["detections"]] for r in delta["ocr_results"]]
    assert got == [[d["text"] for d in f] for f in t.read_text_batch_device(torch.from_numpy(frames),
                                                                            list(frames))]
    assert delta["metadata"]["ocr_model"] == "fvd_tpu_ocr"
    media.clear_frame_cache()


def test_v2_takes_the_host_path_when_no_video_is_cached(tmp_path, ocrs, monkeypatch):
    _, t = ocrs
    frames = _frames()
    keyframes = _v1_state(tmp_path, frames, [0, 1, 2])
    media._device_frames.clear()
    monkeypatch.setattr(t, "read_text_batch_device", None)
    delta = v2_ocr.run({"keyframes": keyframes}, providers=Providers(ocr=t))
    assert media._device_frames.uploads == 0
    assert [[d["text"] for d in r["detections"]] for r in delta["ocr_results"]] == \
        [[d["text"] for d in f] for f in t.read_text_batch(list(frames)) if f]
    media.clear_frame_cache()
