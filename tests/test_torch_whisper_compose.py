"""The composed Whisper canvas of ``fvd_tpu_torch/ops/whisper_frontend.py``
(``phrase_power_mel``, ``compose_canvas``, ``compose_canvas_batch``) against
the JAX package's, and the port's counterparts of
``tests/test_whisper_frontend.py::test_composed_canvas_matches_monolithic``
and ``::test_unused_slots_are_noops``."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fvd_tpu.ops import whisper_frontend as J  # noqa: E402
from fvd_tpu_torch.ops import whisper_frontend as T  # noqa: E402
from test_torch_train_losses import one_torch_thread  # noqa: E402,F401

F = T.TILE_FRAMES_DEFAULT
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def mel():
    return T.mel_filter_bank().astype(np.float32)


def _speech(n, seed=0):
    """``tests/test_whisper_frontend.py``'s gated tone with noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    sig = 0.3 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 3 * t) > 0)
    return (sig + 0.01 * rng.randn(n)).astype(np.float32)


def _tile_audio(lengths_seeds):
    bufs, phrases = [], []
    for seed, n in lengths_seeds:
        a = _speech(n, seed=seed)
        phrases.append(a)
        buf = np.zeros(F * 160, np.float32)
        buf[:n] = a
        bufs.append(buf)
    return np.stack(bufs), phrases


def test_phrase_power_mel_matches_jax(mel):
    audio, _ = _tile_audio(((1, 14000), (2, 9000), (3, F * 160)))
    ref = np.stack([np.asarray(J.phrase_power_mel(jnp.asarray(a), jnp.asarray(mel), F)) for a in audio])
    out = T.phrase_power_mel(torch.from_numpy(audio), torch.from_numpy(mel), F).numpy()
    assert out.shape == (3, F, 80)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_composed_canvas_matches_monolithic(mel):
    """Tiles summed onto the canvas equal the log-mel of the assembled audio
    (hop-aligned offsets, phrases under 1 s on a grid of at least 1 s), by
    the port's ``whisper_log_mel`` and by JAX's."""
    audio, phrases = _tile_audio(((1, 14000), (2, 9000), (3, 15000)))
    pool = T.phrase_power_mel(torch.from_numpy(audio), torch.from_numpy(mel), F)
    offsets = [10, 110, 240]
    window = np.zeros(480000, np.float32)
    for a, off in zip(phrases, offsets):
        window[off * 160: off * 160 + len(a)] = a
    out = T.compose_canvas(pool, torch.tensor([0, 1, 2]), torch.tensor(offsets)).numpy()
    port_ref = T.whisper_log_mel(torch.from_numpy(window), torch.from_numpy(mel)).numpy()
    jax_ref = np.asarray(J.whisper_log_mel(jnp.asarray(window), jnp.asarray(mel)))
    assert out.shape == (80, 3000)
    np.testing.assert_allclose(out, port_ref, atol=1e-3)
    np.testing.assert_allclose(out, jax_ref, atol=1e-3)


def test_unused_slots_are_noops(mel):
    audio, _ = _tile_audio(((5, 12000),))
    pool = T.phrase_power_mel(torch.from_numpy(audio), torch.from_numpy(mel), F)
    one = T.compose_canvas(pool, torch.tensor([0]), torch.tensor([50]))
    padded = T.compose_canvas(pool, torch.tensor([0, -1, -1]), torch.tensor([50, 0, 700]))
    np.testing.assert_allclose(one.numpy(), padded.numpy(), atol=1e-6)


def test_batch_matches_jax_on_the_same_pool(mel):
    """The scatter-add batch against JAX's loop of ``dynamic_update_slice``
    on one pool: unused slots, offsets past both ends (clipped to [0,
    3000]), tiles that overlap, an empty canvas, and each canvas clamped at
    its own max."""
    rng = np.random.RandomState(0)
    audio = (rng.randn(6, F * 160) * rng.uniform(0.01, 0.5, (6, 1))).astype(np.float32)
    pool = np.stack([np.asarray(J.phrase_power_mel(jnp.asarray(a), jnp.asarray(mel), F)) for a in audio])
    idx = np.array([[0, 1, 2, -1, 5], [3, 4, -1, -1, -1], [-1, -1, -1, -1, -1], [5, 5, 0, 1, 2]], np.int32)
    off = np.array([[0, 100, 3100, 5, 2999], [-5, 2990, 0, 0, 0], [0, 0, 0, 0, 0], [7, 87, 180, 260, 3000]],
                   np.int32)
    ref = np.asarray(J.compose_canvas_batch(jnp.asarray(pool), jnp.asarray(idx), jnp.asarray(off)))
    out = T.compose_canvas_batch(torch.from_numpy(pool), torch.from_numpy(idx).long(),
                                 torch.from_numpy(off).long()).numpy()
    assert out.shape == ref.shape == (4, 80, 3000)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    single = T.compose_canvas(torch.from_numpy(pool), torch.from_numpy(idx[3]).long(),
                              torch.from_numpy(off[3]).long()).numpy()
    np.testing.assert_array_equal(single, out[3])


def test_tile_that_does_not_fit_raises(mel):
    with pytest.raises(ValueError, match="does not fit"):
        T.phrase_power_mel(torch.zeros(F * 160 + 401), torch.from_numpy(mel), F)
