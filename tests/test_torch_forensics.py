"""V5 forensics of the port: mirrors ``tests/test_forensics_ops.py`` on
``fvd_tpu_torch/ops/forensics.py`` and ``fvd_tpu_torch/nodes/v5_forensics.py``,
and holds the ELA against ``fvd_tpu/ops/forensics.py`` on the same crops.

ELA quantisation ties: ``round(coeffs / Q)`` flips where a coefficient lands
on k + 0.5, and the DCT rows 0 and 4 make the coefficients (0|4, 0|4) of an
integer block rational multiples of 1/8, so exact ties are common; two
float32 implementations that sum the 8-term products in other orders (XLA's
and torch's matmul) then round some of them apart.  One flipped coefficient
moves its block's reconstruction by at most Q * max|D|^2 = 24 * 0.49^2 = 5.8
at quality 90.  So the ELA is held by the share of exactly equal pixels and
the largest difference, before and after the global 255 / max_diff rescale,
on crops chosen from seeds without regard to ties."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvd_tpu.ops import forensics as jf
from fvd_tpu_torch.nodes import v5_forensics
from fvd_tpu_torch.ops import forensics
from fvd_tpu_torch.providers import Providers, ScriptedLLM
from fvd_tpu_torch.providers.media import VideoReader
from fvd_tpu_torch.state import State
from fvd_tpu_torch.synthetic import make_face_video

#: measured on these crops (``python tests/test_torch_forensics.py`` prints
#: them): pre-rescale diff equal 0.9890 (faces) and 0.9812
#: (noise), largest |d| 2 and 3; final image equal 0.9890 and 0.9223, largest
#: |d| 34.0 and 40.3 (the rescale multiplies a step by 255 / max_diff)
DIFF_EQUAL_MIN = 0.97
IMAGE_EQUAL_MIN = 0.90
DIFF_MAX = 6.0  # one flip of the largest quantisation step at quality 90


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_quant_table_and_dct_matrix_equal_jax():
    for q in (1, 10, 50, 75, 90, 100):
        np.testing.assert_array_equal(forensics.quant_table(q), jf.quant_table(q))
    np.testing.assert_array_equal(forensics.dct_matrix(), jf.dct_matrix())


def test_quant_table_quality_scaling():
    q90 = forensics.quant_table(90)
    q50 = forensics.quant_table(50)
    q10 = forensics.quant_table(10)
    assert (q90 <= q50).all() and (q50 <= q10).all()
    assert q90.min() >= 1
    np.testing.assert_array_equal(q50, forensics._BASE_QUANT)


def test_dct_matrix_orthonormal():
    D = forensics.dct_matrix()
    np.testing.assert_allclose(D @ D.T, np.eye(8), atol=1e-6)


def test_jpeg_roundtrip_smooth_image_nearly_lossless():
    x = np.tile(np.linspace(50, 200, 64, dtype=np.float32), (64, 1))
    y = forensics.jpeg_roundtrip_channel(_t(x), 90).numpy()
    assert np.abs(y - x).max() < 6.0


def test_jpeg_roundtrip_attenuates_noise():
    rng = np.random.RandomState(0)
    x = np.clip(128 + 40 * rng.randn(64, 64).astype(np.float32), 0, 255)
    y = forensics.jpeg_roundtrip_channel(_t(x), 90).numpy()
    assert np.abs(y - x).mean() > 0.5


def test_jpeg_roundtrip_of_odd_sizes_matches_jax():
    x = np.random.RandomState(7).randint(0, 256, (37, 45)).astype(np.float32)
    got = forensics.jpeg_roundtrip_channel(_t(x), 90).numpy()
    ref = np.asarray(jf.jpeg_roundtrip_channel(jnp.asarray(x), 90))
    assert got.shape == ref.shape == (37, 45)
    assert np.abs(got - ref).max() <= DIFF_MAX


def test_ela_highlights_noisy_region():
    rng = np.random.RandomState(0)
    img = np.full((64, 64, 3), 128, np.uint8)
    img[16:32, 16:32] = rng.randint(0, 255, (16, 16, 3)).astype(np.uint8)
    ela = forensics.ela_image(_t(img), 90).numpy()
    assert ela[16:32, 16:32].mean() > 5 * (ela[48:, 48:].mean() + 1e-6)
    assert ela.max() <= 255.0 and ela.min() >= 0.0


def test_fft_spectrum_dc_peak_centered():
    spec = forensics.fft_spectrum(_t(np.full((64, 64), 100.0, np.float32))).numpy()
    assert spec.shape == (64, 64)
    assert spec[32, 32] == spec.max()


def test_rgb_to_gray_bt601():
    rgb = np.zeros((2, 2, 3), np.uint8)
    rgb[..., 1] = 255
    assert forensics.rgb_to_gray(_t(rgb)).numpy()[0, 0] == pytest.approx(0.587 * 255, rel=1e-5)
    assert forensics.rgb_to_gray_host(rgb)[0, 0] == pytest.approx(0.587 * 255, rel=1e-5)


def test_fft_spectrum_host_matches_device_and_jax():
    gray = np.random.RandomState(3).randint(0, 255, (48, 72)).astype(np.float32)
    host = forensics.fft_spectrum_host(gray)
    np.testing.assert_allclose(host, forensics.fft_spectrum(_t(gray)).numpy(), atol=2e-2)
    np.testing.assert_array_equal(host, jf.fft_spectrum_host(gray))
    assert forensics.fft_spectrum_host(np.zeros((16, 16), np.float32)).max() == 0.0
    rgb = np.random.RandomState(4).randint(0, 256, (20, 30, 3)).astype(np.uint8)
    ela, spec = forensics.forensics_program(_t(rgb))
    assert ela.shape == (20, 30, 3) and spec.shape == (20, 30)


def test_ela_batch_matches_per_crop_for_mixed_shapes():
    rng = np.random.RandomState(1)
    crops = [rng.randint(0, 255, (33, 47, 3)).astype(np.uint8),
             rng.randint(0, 255, (64, 64, 3)).astype(np.uint8),
             rng.randint(0, 255, (50, 21, 3)).astype(np.uint8)]
    batched = forensics.ela_batch(crops, 90, device="cpu")
    for crop, got in zip(crops, batched):
        want = forensics.ela_image(_t(crop), 90).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_ela_batch_overflow_runs_per_crop():
    rng = np.random.RandomState(2)
    crops = [rng.randint(0, 255, (24, 24, 3)).astype(np.uint8) for _ in range(6)]
    batched = forensics.ela_batch(crops, 90, device="cpu")
    assert len(batched) == 6 and forensics._ELA_BATCH_N == 4
    np.testing.assert_allclose(batched[5], forensics.ela_image(_t(crops[5]), 90).numpy(), atol=1e-3)
    np.testing.assert_allclose(batched[1], forensics.ela_image(_t(crops[1]), 90).numpy(), atol=1e-3)


def test_ela_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        forensics.ela_batch([np.zeros((8, 8, 3), np.uint8)])


def _tie_crops(root):
    """Face crops of a synthetic clip (flat fills and edges) and noise
    crops, sizes from a seed."""
    path = make_face_video(root, "face", duration=1.0, fps=10.0, seed=5)
    frames, _ = VideoReader(use_cache=False).sample(path, range(10))
    rng = np.random.RandomState(0)
    faces = [frames[i, 40:40 + rng.randint(90, 150), 100:100 + rng.randint(80, 130)] for i in range(10)]
    noise = [rng.randint(0, 256, (rng.randint(20, 130), rng.randint(20, 130), 3)).astype(np.uint8)
             for _ in range(10)]
    return {"faces": faces, "noise": noise}


@pytest.fixture(scope="module")
def crops(tmp_path_factory):
    return _tie_crops(str(tmp_path_factory.mktemp("ela")))


@jax.jit
def _jax_ela_diff(rgb):
    """``ela_image``'s diff before the rescale (its lines, jitted alone)."""
    x = rgb.astype(jnp.float32)
    recon = jnp.stack([jf.jpeg_roundtrip_channel(x[..., c], 90) for c in range(3)], axis=-1)
    return jnp.abs(x - jnp.round(recon))


def tie_statistics(crops):
    """The port's ELA against the JAX package's on ``crops``: per crop the
    pre-rescale diffs' and final images' max |d| and both sides' max diff,
    and over all crops the share of exactly equal pixels."""
    per_crop, diff_eq, img_eq, total = [], 0, 0, 0
    for c in crops:
        h, w = c.shape[:2]
        padded = np.pad(c, ((0, -(-h // 64) * 64 - h), (0, -(-w // 64) * 64 - w), (0, 0)), mode="edge")
        got_diff = forensics.ela_diff_batch(_t(padded[None]), torch.tensor([[h, w]]), 90)[0, :h, :w].numpy()
        ref_diff = np.asarray(_jax_ela_diff(jnp.asarray(c)))
        got_img = forensics.ela_image(_t(c), 90).numpy()
        ref_img = np.asarray(jf.ela_image(jnp.asarray(c), 90))
        per_crop.append({"max_diff": (float(got_diff.max()), float(ref_diff.max())),
                         "diff_gap": float(np.abs(got_diff - ref_diff).max()),
                         "image_gap": float(np.abs(got_img - ref_img).max())})
        diff_eq += int((got_diff == ref_diff).sum())
        img_eq += int((got_img == ref_img).sum())
        total += got_diff.size
    return {"crops": per_crop, "diff_equal_share": diff_eq / total, "image_equal_share": img_eq / total,
            "diff_gap": max(c["diff_gap"] for c in per_crop), "image_gap": max(c["image_gap"] for c in per_crop)}


@pytest.mark.parametrize("kind", ["faces", "noise"])
def test_ela_tie_statistics_against_jax(crops, kind):
    stats = tie_statistics(crops[kind])
    for c in stats["crops"]:
        assert c["max_diff"][0] == c["max_diff"][1]  # the same rescale on both sides
        assert c["diff_gap"] <= DIFF_MAX
        assert c["image_gap"] <= DIFF_MAX * 255.0 / c["max_diff"][1] + 1e-3
    assert stats["diff_equal_share"] >= DIFF_EQUAL_MIN, stats
    assert stats["image_equal_share"] >= IMAGE_EQUAL_MIN, stats


# ---------------------------------------------------------------------------
# V5 node behavior (reference tests/test_v5_texture_ela.py semantics)
# ---------------------------------------------------------------------------
def _detections(crop):
    return [{"frame_id": 0, "timestamp": 0.0,
             "faces": [{"bbox": {"x": 0, "y": 0, "w": 32, "h": 32}, "confidence": 0.9,
                        "is_main": True, "crop": crop}],
             "keyframe_path": "x"}]


def test_v5_no_faces_zero():
    delta = v5_forensics.run(State(face_detections=[]), providers=Providers(), device="cpu")
    assert delta["texture_ela_score"] == 0.0
    assert delta["texture_ela_details"]["reason"] == "No faces found"


def test_v5_no_crops_zero():
    delta = v5_forensics.run(State(face_detections=[{"frame_id": 0, "faces": []}]), providers=Providers(),
                             device="cpu")
    assert delta["texture_ela_details"]["reason"] == "No face crops available"


def test_v5_no_llm_zero_with_reason(tmp_path):
    crop = np.random.RandomState(0).randint(0, 255, (32, 32, 3)).astype(np.uint8)
    delta = v5_forensics.run(State(face_detections=_detections(crop), data_dir=str(tmp_path)),
                             providers=Providers(), device="cpu")
    assert delta["texture_ela_score"] == 0.0
    assert delta["texture_ela_details"]["reason"] == "Analysis failed or no keys"


def test_v5_scores_mean_of_llm_results(tmp_path):
    from fvd_tpu_torch.utils.png import decode_png

    crop = np.random.RandomState(0).randint(0, 255, (32, 32, 3)).astype(np.uint8)
    dets = _detections(crop) + [{"frame_id": 1, "timestamp": 1.0,
                                 "faces": [{"bbox": {"x": 0, "y": 0, "w": 40, "h": 40}, "confidence": 0.8,
                                            "is_main": True, "crop": crop}],
                                 "keyframe_path": "y"}]
    llm = ScriptedLLM(queue=[{"fake_probability": 0.8, "reasoning": "a"},
                             {"fake_probability": 0.4, "reasoning": "b"}])
    delta = v5_forensics.run(State(face_detections=dets, data_dir=str(tmp_path)), providers=Providers(llm=llm),
                             device="cpu")
    assert delta["texture_ela_score"] == pytest.approx(0.6)
    ela_png = os.path.join(str(tmp_path), "ela_analysis", "ela_0.png")
    assert os.path.exists(os.path.join(str(tmp_path), "ela_analysis", "fft_0.png"))
    with open(ela_png, "rb") as f:
        saved = decode_png(f.read())
    np.testing.assert_array_equal(saved, forensics.ela_image(_t(crop), 90).numpy().astype(np.uint8))


def test_v5_top3_selection_by_confidence_area(tmp_path):
    crop = np.zeros((8, 8, 3), np.uint8)

    def det(fid, conf, wh):
        return {"frame_id": fid, "timestamp": float(fid),
                "faces": [{"bbox": {"x": 0, "y": 0, "w": wh, "h": wh}, "confidence": conf,
                           "is_main": True, "crop": crop}],
                "keyframe_path": "k"}

    dets = [det(0, 0.9, 10), det(1, 0.9, 100), det(2, 0.9, 50), det(3, 0.9, 80)]
    llm = ScriptedLLM(default={"fake_probability": 0.5, "reasoning": "r"})
    delta = v5_forensics.run(State(face_detections=dets, data_dir=str(tmp_path)), providers=Providers(llm=llm),
                             device="cpu")
    assert len(delta["texture_ela_details"]) == 3


def test_v5_reads_the_crop_png_when_no_crop_is_in_memory(tmp_path):
    from fvd_tpu_torch.utils.png import encode_png

    crop = np.random.RandomState(5).randint(0, 255, (24, 40, 3)).astype(np.uint8)
    path = os.path.join(str(tmp_path), "face_0_0.png")
    with open(path, "wb") as f:
        f.write(encode_png(crop))
    face = {"bbox": {"x": 0, "y": 0, "w": 40, "h": 24}, "confidence": 0.9, "crop_path": path}
    np.testing.assert_array_equal(v5_forensics._load_crop(face), crop)
    seen = []

    class Vision(ScriptedLLM):
        def vision_json(self, system, prompt, images):
            seen.extend(images)
            return super().vision_json(system, prompt, images)

    delta = v5_forensics.run(
        State(face_detections=[{"frame_id": 0, "timestamp": 0.0, "faces": [face]}], data_dir=str(tmp_path)),
        providers=Providers(llm=Vision(default={"fake_probability": 0.25})), device="cpu")
    assert delta["texture_ela_score"] == 0.25
    # crop, ELA map and spectrum go to the LLM as the JPEG bytes OpenCV gives
    # the JAX package (its ``_encode_jpeg``); the crop is read from the PNG file
    from fvd_tpu.nodes.v5_forensics import _encode_jpeg

    assert len(seen) == 3 and all(img[:4] == b"\xff\xd8\xff\xe0" for img in seen)
    assert seen[0] == _encode_jpeg(crop)


if __name__ == "__main__":  # print the tie statistics the bars above come from
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for kind, cs in _tie_crops(tmp).items():
            st = tie_statistics(cs)
            print(kind, {k: v for k, v in st.items() if k != "crops"})
