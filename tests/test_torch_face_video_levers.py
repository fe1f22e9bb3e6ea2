"""``fvd_tpu_torch/synthetic.py`` ``make_face_video``'s manipulation levers
against ``fvd_tpu/synthetic.py`` on the CPU: with ``opencv=True`` the port's
frames equal the JAX function's before its (lossy) mp4 encoding byte for
byte, and the wav samples are equal, for every lever alone, the levers
together, every recipe of the labeled corpus and both speech renderers;
the default clip (pixel-centre shapes) is unchanged; and the levers do to
the pipeline's inputs what ``tests/test_face_video_models.py`` checks of
the JAX package's."""

import hashlib
import os

import numpy as np
import pytest
import torch

import fvd_tpu.synthetic as jsyn
from fvd_tpu_torch.synthetic import make_face_video
from fvd_tpu_torch.utils import avi
from fvd_tpu_torch.utils.wav import read_wav
from tools.make_labeled_corpus import AMBIGUOUS_RECIPES, FAKE_RECIPES, HARD_REAL_RECIPES

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
TEXT = "the mayor said the city will cut taxes next year"

#: (id, make_face_video kwargs, speech_text, JAX speech renderer)
CASES = (
    [("none", {}, None, "tone"),
     ("audio_offset", {"audio_offset_s": 0.3}, None, "tone"),
     ("texture", {"texture_noise": 14.0}, None, "tone"),
     ("sensor", {"sensor_noise": 20.0}, None, "tone"),
     ("pose", {"pose_jitter": 2.5}, None, "tone"),
     ("heldout", {"heldout": True}, None, "tone"),
     ("heldout_texture_sensor_pose", {"heldout": True, "texture_noise": 10.0, "sensor_noise": 6.0,
                                      "pose_jitter": 3.0}, None, "tone"),
     # a face box pushed past the right and bottom edges: the noise region
     # is whatever numpy's slice clipping leaves
     ("texture_at_the_edges", {"pose_jitter": 60.0, "texture_noise": 5.0}, None, "tone"),
     ("tone_speech", {}, TEXT, "tone"),
     ("formant_speech", {"audio_offset_s": 0.25}, TEXT, "formant")]
    + [(f"fake_{i}", r, TEXT, "formant") for i, r in enumerate(FAKE_RECIPES)]
    + [(f"ambiguous_{i}", r, TEXT, "formant") for i, r in enumerate(AMBIGUOUS_RECIPES)]
    + [(f"hard_real_{i}", r, text, "formant") for i, (r, text) in enumerate(HARD_REAL_RECIPES)]
)
SIZES = {"heldout_texture_sensor_pose": (320, 240)}

#: the default clip (seed 0, 1 s at 5 fps, 160x120, gated tone) as the
#: parent of the levers drew it: sha256 of its frames and of its wav file
DEFAULT_FRAMES_SHA256 = "1a11b7379d146ce31d12c281c43fc54ad38b32cb9565f1e64ec0f994baae3859"
DEFAULT_WAV_SHA256 = "fea365f5dd185fc6cad03c397cf2ebb6248c684c310a25a1793956d7dce15dca"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_frames(monkeypatch, *args, **kwargs):
    """JAX's ``make_face_video`` -> (its frames before the mp4 encoding,
    its wav path)."""
    captured = {}
    monkeypatch.setattr(jsyn, "write_video", lambda path, frames, fps: captured.update(frames=frames.copy()))
    path = jsyn.make_face_video(*args, **kwargs)
    return captured["frames"], os.path.splitext(path)[0] + ".wav"


def read_clip(path):
    n = avi.probe(path)[1]
    frames, kept = avi.read_frames(path, range(n))
    assert kept == list(range(n))
    return frames


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_frames_and_audio_equal_jax(tmp_path, monkeypatch, case):
    name, levers, text, renderer = case
    width, height = SIZES.get(name, (160, 120))
    seed = CASES.index(case)
    common = dict(duration=1.0, fps=5.0, width=width, height=height, seed=seed, speech_text=text, **levers)
    want, jwav = jax_frames(monkeypatch, str(tmp_path / "jax"), "clip", speech_renderer=renderer, **common)
    got = make_face_video(str(tmp_path / "port"), "clip", opencv=True,
                          speech="formant_gated" if renderer == "formant" else "tone", **common)
    frames = read_clip(got)
    assert frames.shape == want.shape == (5, height, width, 3)
    assert np.array_equal(frames, want), f"{int((frames != want).sum())} bytes differ"
    (a, sr_a), (b, sr_b) = read_wav(jwav), read_wav(os.path.splitext(got)[0] + ".wav")
    assert sr_a == sr_b == 16000 and np.array_equal(a, b)


def test_default_clip_is_unchanged(tmp_path):
    path = make_face_video(str(tmp_path), "default", duration=1.0, fps=5.0, width=160, height=120, seed=0)
    assert hashlib.sha256(np.ascontiguousarray(read_clip(path)).tobytes()).hexdigest() == DEFAULT_FRAMES_SHA256
    with open(os.path.join(tmp_path, "default.wav"), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == DEFAULT_WAV_SHA256


def test_sensor_noise_degrades_whole_frame(tmp_path):
    """``tests/test_face_video_models.py``'s check on the port: sensor noise
    moves the background, not just the face region, and the clip reads."""
    clean = read_clip(make_face_video(str(tmp_path), "clean", duration=1.0, fps=5.0, seed=3))
    noisy = read_clip(make_face_video(str(tmp_path), "noisy", duration=1.0, fps=5.0, seed=3, sensor_noise=24.0))
    # the corner patch is pure background in both renders
    corner_delta = clean[0, :40, :40].astype(int) - noisy[0, :40, :40].astype(int)
    assert float(np.abs(corner_delta).mean()) > 5.0


def test_trained_detector_handles_heldout_video(tmp_path):
    """``tests/test_face_video_models.py``'s held-out check on the port's SSD
    on the CPU: striped background, out-of-range eccentricity and skin,
    glasses and hair; the shipped detector finds the face on most frames."""
    from fvd_tpu_torch.models.face_ssd import SSDFaceDetector

    path = make_face_video(str(tmp_path), "ho", duration=2.0, fps=10.0, gate_hz=1.0, seed=7, heldout=True,
                           opencv=True)
    frames = read_clip(path)
    assert len(frames) == 20
    det = SSDFaceDetector(os.path.join(CKPT, "face_ssd.npz"), compute_dtype=torch.float32, device="cpu")
    dets = det.detect_batch(frames)
    det_rate = sum(1 for d in dets if d) / len(dets)
    assert det_rate >= 0.6, f"held-out detection rate {det_rate}"
