"""Progressive analysis (``fvd_tpu_torch/streaming.py``) on the CPU: the five
tests of ``tests/test_streaming.py`` on the port, then the port against the
JAX package on one raw-RGBA AVI and its wav, with synthetic landmarks and
with the shipped face_ssd and landmarks checkpoints in f32 on both sides.

The JAX package reads the port's AVI through OpenCV.  It is set to f32 as
``tests/test_torch_video_dag.py`` sets it, by passing
``compute_dtype=jnp.float32`` to ``detect_batch_jit`` and to
``landmarks_from_frames`` (the program a landmark forward without pose
takes), in this file only."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvd_tpu.providers as jprov
import fvd_tpu.streaming as jstream
import fvd_tpu.synthetic as jsyn
from fvd_tpu.models import face_ssd as jssd
from fvd_tpu.models import landmarks_fan as jlmk
from fvd_tpu_torch import _kernels
from fvd_tpu_torch.models import face_ssd as tssd
from fvd_tpu_torch.models import landmarks_fan as tlmk
from fvd_tpu_torch.providers import Providers
from fvd_tpu_torch.providers import media as tmedia
from fvd_tpu_torch.streaming import ProgressiveAnalyzer, _load_envelope, analyze_progressive
from fvd_tpu_torch.synthetic import SyntheticLandmarks, make_face_video, make_synthetic_video

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
FEATURES = {"speech_rate", "pause_ratio", "lip_sync", "gesture_score", "blink_rate", "headpose_jerk",
            "texture", "claim_reliability", "evidence_reliability"}
#: chunk boundaries must not move the final prefix score: the OneEuro carry
#: hands the same float32 state on, so only the summation is shared
CHUNK_TOL = 1e-9
#: the port against the JAX package, every feature and the probability, per
#: update (synthetic landmarks, and the shipped checkpoints in f32)
PARITY_TOL = 1e-6
#: the float32 RMS envelope of the two packages (``rms_envelope`` + ``interp``)
ENVELOPE_TOL = 1e-5


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    # 6 s at 10 fps with a gate-matched sibling wav
    return make_synthetic_video(str(tmp_path_factory.mktemp("stream")), name="stream", duration=6.0,
                                fps=10.0, width=160, height=120)


@pytest.fixture(autouse=True)
def _cwd(tmp_path, monkeypatch):
    """LR reads ``lr_weights.json`` from the cwd (else the shipped weights)."""
    monkeypatch.chdir(tmp_path)
    yield
    tmedia.clear_frame_cache()


def _providers():
    return Providers(landmarks=SyntheticLandmarks(fps=10.0, gate_hz=1.0))


def _run(video, chunk_seconds=2.0, providers=None):
    return list(analyze_progressive(video, providers=providers or _providers(), chunk_seconds=chunk_seconds,
                                    device="cpu"))


@pytest.fixture(scope="module")
def updates_2s(video):
    return _run(video)


def test_progressive_updates_cover_video(updates_2s):
    updates = updates_2s
    # 6 s sampled at 5 fps = 30 samples; 2 s chunks of 10 -> 3 updates
    assert len(updates) == 3
    fractions = [u.fraction for u in updates]
    assert fractions == sorted(fractions)
    assert fractions[-1] == pytest.approx(1.0, abs=0.05)
    assert updates[-1].mouth_samples == 30
    assert [u.chunk_index for u in updates] == [0, 1, 2]
    for u in updates:
        assert 0.0 <= u.fake_probability <= 1.0
        assert set(u.features) == FEATURES


def test_progressive_lipsync_converges_positive(updates_2s):
    """Synced synthetic media: the running lip-sync signal is positive once
    enough prefix has accumulated, and blink_rate reflects the accumulated
    samples (reference quirk: it counts samples)."""
    final = updates_2s[-1]
    assert final.features["lip_sync"] > 0.3
    assert final.features["blink_rate"] == 1.0  # 30 samples over 6 s, capped
    assert updates_2s[0].features["lip_sync"] >= 0.0


def test_progressive_no_landmark_provider_yields_nothing(video):
    assert list(analyze_progressive(video, providers=Providers(), device="cpu")) == []


def test_progressive_no_audio_still_streams(tmp_path):
    video = make_synthetic_video(str(tmp_path), name="mute", duration=4.0, fps=10.0, width=160, height=120)
    os.remove(os.path.splitext(video)[0] + ".wav")
    updates = _run(video)
    assert len(updates) == 2
    assert all(u.features["lip_sync"] == 0.0 for u in updates)
    assert all(0.0 <= u.fake_probability <= 1.0 for u in updates)


def test_progressive_chunking_invariance(video):
    """Different chunk sizes accumulate identical landmark tracks: the final
    prefix score does not depend on chunk boundaries."""
    a = _run(video, chunk_seconds=1.0)
    b = _run(video, chunk_seconds=3.0)
    assert (len(a), len(b)) == (6, 2)
    assert a[-1].mouth_samples == b[-1].mouth_samples
    assert a[-1].features["lip_sync"] == pytest.approx(b[-1].features["lip_sync"], abs=CHUNK_TOL)
    assert a[-1].fake_probability == pytest.approx(b[-1].fake_probability, abs=CHUNK_TOL)


def test_progressive_runs_c1_once_per_update_and_needs_a_device(video):
    """C1 is called once per update on the analyzer's device (no kernel
    launch on the CPU); the card is the default and raises without one."""
    _kernels.reset_launches()
    assert len(_run(video, chunk_seconds=3.0)) == 2
    assert _kernels.LAUNCHES["lipsync_score"] == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            next(iter(ProgressiveAnalyzer(video, providers=_providers()).updates()))


def test_progressive_multi_chunk_caches_hold_no_stale_chunk(video, monkeypatch):
    """Past one chunk the sampler reads uncached: no chunk's frames enter the
    host frame cache, each chunk's device upload is its own grid, and the
    device cache stays within its byte budget."""
    calls = []

    class Spy(SyntheticLandmarks):
        accepts_device_frames = True
        device = torch.device("cpu")

        def landmarks_batch(self, frames, device_frames=None):
            assert device_frames is not None and torch.equal(device_frames, torch.from_numpy(frames))
            calls.append(len(frames))
            return super().landmarks_batch(frames)

    frame_bytes = 120 * 160 * 3
    monkeypatch.setattr(tmedia._device_frames, "max_bytes", 12 * frame_bytes)
    tmedia.clear_frame_cache()
    updates = _run(video, chunk_seconds=1.0, providers=Providers(landmarks=Spy(fps=10.0, gate_hz=1.0)))
    assert calls == [5] * 6 and len(updates) == 6
    assert tmedia._frame_cache.lookup(video, range(60))[0] == {}
    entries = [ids for es in tmedia._device_frames._entries.values() for ids, _ in es]
    assert len(entries) == 2 and entries == [tuple(range(40, 50, 2)), tuple(range(50, 60, 2))]
    assert tmedia._device_frames.uploads == 6
    assert updates[-1].features == _run(video, chunk_seconds=1.0)[-1].features


# ------------------------------------------------------------ against JAX
def _jax_run(path, providers, chunk_seconds):
    return list(jstream.analyze_progressive(path, providers=providers, chunk_seconds=chunk_seconds))


def _assert_parity(t_updates, j_updates):
    assert len(t_updates) == len(j_updates) > 1
    for t, j in zip(t_updates, j_updates):
        assert (t.chunk_index, t.t_end, t.fraction, t.mouth_samples) == (
            j.chunk_index, j.t_end, j.fraction, j.mouth_samples)
        assert set(t.features) == set(j.features) == FEATURES
        for k in FEATURES:
            assert t.features[k] == pytest.approx(j.features[k], abs=PARITY_TOL), k
        assert t.fake_probability == pytest.approx(j.fake_probability, abs=PARITY_TOL)


def test_progressive_matches_jax_with_synthetic_landmarks(video):
    t = _run(video)
    j = _jax_run(video, jprov.Providers(landmarks=jsyn.SyntheticLandmarks(fps=10.0, gate_hz=1.0)), 2.0)
    _assert_parity(t, j)
    assert t[-1].features["lip_sync"] > 0.3


def test_progressive_matches_jax_on_the_shipped_checkpoints(tmp_path):
    """6 s at 10 fps, 320x240, 1 s chunks: 6 updates through the uncached
    multi-chunk branch, the detector and hourglass in f32 on both sides."""
    clip = make_face_video(str(tmp_path / "clip"), "clip", duration=6.0, fps=10.0)
    env_t = _load_envelope(clip, 10.0, 6.0, "cpu")
    env_j = jstream._load_envelope(clip, 10.0, 6.0)
    assert env_t.dtype == env_j.dtype == np.float64 and env_t.shape == env_j.shape == (60,)
    np.testing.assert_allclose(env_t, env_j, rtol=0, atol=ENVELOPE_TOL)

    det = tssd.SSDFaceDetector(checkpoint=os.path.join(CKPT, "face_ssd.npz"), compute_dtype=torch.float32,
                               device="cpu")
    lmk = tlmk.FANLandmarks(det, checkpoint=os.path.join(CKPT, "landmarks.npz"), compute_dtype=torch.float32,
                            device="cpu")
    tmedia.clear_frame_cache()
    t = _run(clip, chunk_seconds=1.0, providers=Providers(face_detector=det, landmarks=lmk))

    jdet = jssd.SSDFaceDetector(params=jssd.load_params(os.path.join(CKPT, "face_ssd.npz"), 32), width=32)
    tpl = jax.jit(jlmk.LandmarkHourglass(width=32).init)(jax.random.PRNGKey(1), jnp.zeros((1, 128, 128, 3)))
    jlm = jlmk.FANLandmarks(jdet, landmark_params=jlmk.load_params(os.path.join(CKPT, "landmarks.npz"), tpl),
                            width=32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssd, "detect_batch_jit", functools.partial(jssd.detect_batch_jit, compute_dtype=jnp.float32))
        mp.setattr(jlmk, "landmarks_from_frames",
                   functools.partial(jlmk.landmarks_from_frames, compute_dtype=jnp.float32))
        j = _jax_run(clip, jprov.Providers(face_detector=jdet, landmarks=jlm), 1.0)
    assert len(t) == 6 and t[-1].mouth_samples == 30
    assert t[-1].features["lip_sync"] > 0.0
    _assert_parity(t, j)
