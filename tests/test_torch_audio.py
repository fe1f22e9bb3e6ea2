"""The audio path of the port against the JAX package: the polyphase
resampler against the dilated-conv one, the A3 front-end (STFT, mel, onset
strength, peak picking, RMS envelope) and the A1 and A3 nodes, alone and
coalesced.  Mirrors ``tests/test_audio_ops.py``; inputs from seeds."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvd_tpu.nodes import a1_standardize as ja1
from fvd_tpu.nodes import a3_onsets as ja3
from fvd_tpu.ops import resample as jres
from fvd_tpu.ops import spectral as jspec
from fvd_tpu.state import State as JState
from fvd_tpu_torch.nodes import a1_standardize as ta1
from fvd_tpu_torch.nodes import a3_onsets as ta3
from fvd_tpu_torch.ops import resample as tres
from fvd_tpu_torch.ops import spectral as tspec
from fvd_tpu_torch.providers import coalesce
from fvd_tpu_torch.state import State as TState
from fvd_tpu_torch.utils import wav

#: float32 on both sides; the polyphase sum and the conv add the same products
#: in different orders
RESAMPLE_TOL = 1e-5
#: the RMS envelope after the same float32 framing; the onset mask must be identical
ENVELOPE_TOL = 1e-5


def _speechlike(sr, seconds, seed=0, gate_hz=1.0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(sr * seconds)) / sr
    gate = (np.sin(2 * np.pi * gate_hz * t) > 0).astype(np.float32)
    return (0.5 * np.sin(2 * np.pi * 330 * t) * gate + 0.02 * rng.randn(len(t))).astype(np.float32)


@pytest.mark.parametrize("orig_sr,target_sr,n", [(44100, 16000, 44100 * 2 + 17), (48000, 16000, 4801),
                                                 (22050, 16000, 5000), (8000, 16000, 999),
                                                 (16000, 16000, 300), (44100, 16000, 3)])
def test_resample_matches_jax(orig_sr, target_sr, n):
    x = (np.random.RandomState(n).rand(n) - 0.5).astype(np.float32)
    ref = np.asarray(jres.resample(x, orig_sr, target_sr))
    got = tres.resample(x, orig_sr, target_sr, device="cpu").numpy()
    assert got.shape == ref.shape == (-(-n * target_sr // orig_sr),)
    np.testing.assert_allclose(got, ref, atol=RESAMPLE_TOL, rtol=0)


def test_resample_batch_matches_jax():
    xs = (np.random.RandomState(3).rand(3, 4410) - 0.5).astype(np.float32)
    ref = np.asarray(jres.resample_batch(xs, 44100, 16000))
    got = tres.resample_batch(xs, 44100, 16000).numpy()
    np.testing.assert_allclose(got, ref, atol=RESAMPLE_TOL, rtol=0)
    for i in range(3):  # a row of the batch is the single-signal call
        assert torch.equal(tres.resample(xs[i], 44100, 16000), torch.from_numpy(got[i]))


def test_phase_bank_holds_every_tap_once():
    h = tres._design_lowpass(160, 441)
    bank, _ = tres._phase_bank(160, 441)
    assert np.count_nonzero(bank) == np.count_nonzero(h)
    np.testing.assert_array_equal(np.sort(bank[bank != 0]), np.sort(h[h != 0]))
    assert bank.shape[1] == 160 and (bank != 0).sum(0).max() == -(-len(h) // 160)


def test_spectral_ops_match_jax():
    x = _speechlike(16000, 2.0)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(tspec.stft_power(tx).numpy(), np.asarray(jspec.stft_power(jx)), rtol=2e-4, atol=1e-3)
    np.testing.assert_array_equal(tspec.mel_filterbank(16000, 2048), jspec.mel_filterbank(16000, 2048))
    np.testing.assert_allclose(tspec.onset_strength(tx, 16000).numpy(),
                               np.asarray(jspec.onset_strength(jx, 16000)), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tspec.fps_aligned_envelope(tx, 16000, 30.0, 2.0).numpy(),
                               np.asarray(jspec.fps_aligned_envelope(jx, 16000, 30.0, 2.0)),
                               atol=ENVELOPE_TOL, rtol=0)
    np.testing.assert_array_equal(tspec.detect_onsets(tx, 16000), jspec.detect_onsets(jx, 16000))


@pytest.mark.parametrize("seed", range(4))
def test_peak_pick_matches_jax(seed):
    env = np.random.RandomState(seed).rand(200).astype(np.float32)
    kw = dict(pre_max=1, post_max=1, pre_avg=3, post_avg=4, delta=0.07, wait=2 + seed)
    ref = np.asarray(jspec.peak_pick_mask(jnp.asarray(env), **kw))
    np.testing.assert_array_equal(tspec.peak_pick_mask(torch.from_numpy(env), **kw), ref)


FRONTEND = dict(sr=16000, n_fft=2048, hop=512, n_mels=128, pre_max=1, post_max=1, pre_avg=3,
                post_avg=4, wait=1, delta=0.07, env_frame=1066, env_hop=533, env_target=180)


def test_frontend_program_and_batch_match_jax():
    xs = np.stack([_speechlike(16000, 6.0, seed=s, gate_hz=g) for s, g in ((0, 1.0), (1, 1.7))])
    jm, je = jspec.audio_frontend_program_batch(jnp.asarray(xs), **FRONTEND)
    tm, te = tspec.audio_frontend_program(torch.from_numpy(xs), **FRONTEND)
    np.testing.assert_array_equal(tm, np.asarray(jm))
    np.testing.assert_allclose(te, np.asarray(je), atol=ENVELOPE_TOL, rtol=0)
    assert tm.sum(1).min() >= 5  # each gated signal has its onsets
    m0, e0 = tspec.audio_frontend_program(torch.from_numpy(xs[0]), **FRONTEND)
    np.testing.assert_array_equal(m0, tm[0])
    np.testing.assert_allclose(e0, te[0], atol=1e-7, rtol=0)


def _data_dir(root, sr, seconds=6.0, seed=0, gate_hz=1.0, stereo=False):
    d = root / f"run_{sr}_{seed}"
    d.mkdir()
    x = _speechlike(sr, seconds, seed, gate_hz)
    wav.write_wav(str(d / "audio.wav"), np.stack([x, 0.5 * x], 1) if stereo else x, sr)
    return str(d)


@pytest.mark.parametrize("sr,stereo", [(44100, False), (16000, True)])
def test_a1_a3_nodes_match_jax(tmp_path, sr, stereo):
    d = _data_dir(tmp_path, sr, stereo=stereo)
    meta = {"fps": 10.0, "duration": 6.0}
    j1 = ja1.run(JState(data_dir=d, metadata=meta))
    jwav16 = open(os.path.join(d, "audio_16k.wav"), "rb").read()
    t1 = ta1.run(TState(data_dir=d, metadata=meta), device="cpu")
    twav16 = open(os.path.join(d, "audio_16k.wav"), "rb").read()
    assert t1["metadata"] == j1["metadata"]
    np.testing.assert_allclose(t1["audio_16k"].numpy(), np.asarray(j1["audio_16k"]), atol=RESAMPLE_TOL, rtol=0)
    a, b = (np.frombuffer(w[44:], "<i2").astype(int) for w in (twav16, jwav16))
    assert len(a) == len(b) and np.abs(a - b).max() <= 1  # s16 rounding of values within 1e-5
    j3 = ja3.run(JState(data_dir=d, metadata=j1["metadata"], audio_16k=j1["audio_16k"]))
    t3 = ta3.run(TState(data_dir=d, metadata=t1["metadata"], audio_16k=t1["audio_16k"]), device="cpu")
    assert t3["audio_onsets"] == j3["audio_onsets"] and t3["onset_count"] == j3["onset_count"] > 0
    assert len(t3["audio_envelope"]) == len(j3["audio_envelope"]) == 60
    np.testing.assert_allclose(t3["audio_envelope"], j3["audio_envelope"], atol=ENVELOPE_TOL, rtol=0)
    assert t3["metadata"] == j3["metadata"]
    # from the file, without A1's tensor
    t3f = ta3.run(TState(data_dir=d, metadata=t1["metadata"]), device="cpu")
    assert t3f["audio_onsets"] == t3["audio_onsets"]


def test_nodes_missing_audio_are_noops(tmp_path):
    assert ta1.run(TState(data_dir=str(tmp_path)), device="cpu") == {}
    assert ta1.run(TState(data_dir=str(tmp_path / "nope")), device="cpu") == {}
    assert ta3.run(TState(data_dir=str(tmp_path)), device="cpu") == {}


def test_a1_a3_coalesced_groups_match_alone(tmp_path, monkeypatch):
    dirs = [_data_dir(tmp_path, 44100, seed=s, gate_hz=g) for s, g in ((0, 1.0), (1, 1.3), (2, 0.7))]
    meta = {"fps": 10.0, "duration": 6.0}

    def run(d):
        t1 = ta1.run(TState(data_dir=d, metadata=meta), device="cpu")
        return t1, ta3.run(TState(data_dir=d, metadata=t1["metadata"], audio_16k=t1["audio_16k"]), device="cpu")

    alone = [run(d) for d in dirs]
    monkeypatch.setenv("FVD_TPU_NO_ADAPTIVE_WINDOW", "1")  # a fixed window: the videos meet under load
    deactivate = coalesce._activate_program_coalescer(max_wait_ms=500.0)
    co = coalesce._program_co
    try:
        with ThreadPoolExecutor(3) as pool:
            together = list(pool.map(run, dirs))
        groups, served = co.groups_run, co.items_served
    finally:
        deactivate()
    assert served == 6 and groups < 6  # three videos, two programs each, grouped
    for (a1, a3), (b1, b3) in zip(alone, together):
        assert torch.equal(a1["audio_16k"], b1["audio_16k"])
        assert a3["audio_onsets"] == b3["audio_onsets"]
        np.testing.assert_allclose(a3["audio_envelope"], b3["audio_envelope"], atol=1e-7, rtol=0)
