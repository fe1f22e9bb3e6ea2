"""The C1 lip-sync node of the port (``fvd_tpu_torch/nodes/c1_lipsync.py``, on
``device="cpu"``) against the JAX package's node on the same states.

The JAX node runs its stage as its own tests run it on the CPU, through
``lip_sync_score_xla``, which ``tests/test_c1_lipsync.py`` holds equal to the
Pallas kernel in interpret mode; the port runs the plain version of its stage
kernel.  Both score float32 signals cast from the same float64
interpolations, so only the summation order differs."""

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from fvd_tpu.nodes import c1_lipsync as jc1
from fvd_tpu.providers import coalesce as jco
from fvd_tpu.state import State as JState
from fvd_tpu_torch import _kernels
from fvd_tpu_torch.nodes import c1_lipsync as tc1
from fvd_tpu_torch.providers import coalesce as tco
from fvd_tpu_torch.state import State as TState

#: f32 on both sides, different summation orders (the JAX package's own bar
#: between its XLA and Pallas paths)
TOL = 1e-5
#: the port's coalesced group against its own single-video call: the same
#: plain ops on a [B, N] batch and on one [N] row
GROUP_TOL = 1e-6


def generate_signals(duration, fps, sync_type="perfect", seed=42):
    """Copy of the reference generator in ``tests/test_c1_lipsync.py``."""
    rng = np.random.RandomState(seed)
    num_frames = int(duration * fps)
    t = np.linspace(0, duration, num_frames)
    envelope = np.clip(0.5 * (1 + np.sin(2 * np.pi * 2 * t)) + 0.1 * rng.rand(len(t)), 0, 1)
    audio, mouth = envelope, envelope
    if sync_type == "delayed":
        mouth = np.roll(envelope, int(0.1 * fps))
    elif sync_type == "random":
        mouth = rng.rand(len(t))
    elif sync_type == "silence":
        audio = np.zeros_like(t)
    elif sync_type == "static_face":
        mouth = np.zeros_like(t)
    landmarks = [{"timestamp": t[i], "mar": v * 0.5 + 0.1} for i, v in enumerate(mouth)]
    return audio, landmarks, mouth


def _fields(audio, landmarks, duration=5.0, fps=30.0, **extra):
    fields = dict(input_path="dummy.mp4", metadata={"duration": duration, "fps": fps},
                  mouth_landmarks=landmarks, face_detections=[{"box": [0, 0, 100, 100]}],
                  test_audio_signal=audio)
    fields.update(extra)
    return fields


def _mouth_points(mar, rng):
    """20 mouth points whose MAR is ``mar``: corners 6 apart, three vertical
    pairs whose mean gap is ``2 * mar * 3``, jittered by rotation."""
    pts = rng.rand(20, 2) * 0.1
    pts[0], pts[6] = [0.0, 0.0], [6.0, 0.0]
    gaps = 3 * mar * np.array([0.8, 1.4, 0.8])
    for (i, j), g, x in zip([(2, 10), (3, 9), (4, 8)], gaps, [2.0, 3.0, 4.0]):
        pts[i], pts[j] = [x, g / 2], [x, -g / 2]
    th = rng.rand() * 0.3
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return (pts @ rot.T + 50.0).tolist()


def _state_fields(case):
    if case in ("perfect", "delayed", "random", "silence", "static_face"):
        audio, landmarks, _ = generate_signals(5.0, 30.0, case)
        return _fields(audio, landmarks)
    if case == "half_silence":
        audio, landmarks, _ = generate_signals(10.0, 30.0, "perfect")
        n = len(audio)
        audio = audio.copy()
        audio[n // 2:] = 0.0
        for lm in landmarks[n // 2:]:
            lm["mar"] = 0.1
        return _fields(audio, landmarks, 10.0, 30.0)
    if case == "length_mismatch":
        audio, landmarks, _ = generate_signals(5.0, 30.0, "perfect")
        return _fields(audio[::2], landmarks)
    if case == "landmarks_20pt":
        # V3's rate: 5 fps points, a 30 fps A3 envelope; every 7th sample has
        # no points or too few, and one has neither key
        audio, _, mouth = generate_signals(8.0, 30.0, "delayed")
        rng = np.random.RandomState(7)
        t = np.linspace(0, 8.0, 40)
        marks = []
        for i, ts in enumerate(t):
            m = float(np.interp(ts, np.linspace(0, 8.0, len(mouth)), mouth)) * 0.5 + 0.1
            pts = _mouth_points(m, rng) if i % 7 else ([] if i % 14 else [[0.0, 0.0]] * 19)
            marks.append({"timestamp": ts, "landmarks": pts} if i != 5 else {"timestamp": ts})
        return _fields(None, marks, 8.0, 30.0, audio_envelope=audio)
    if case == "envelope_not_hook":
        audio, landmarks, _ = generate_signals(5.0, 30.0, "perfect")
        return _fields(None, landmarks, audio_envelope=audio)
    if case == "hook_before_envelope":
        audio, landmarks, _ = generate_signals(5.0, 30.0, "perfect")
        noise = np.random.RandomState(3).rand(len(audio))
        return _fields(noise, landmarks, audio_envelope=audio)
    if case == "sixty_s_30fps":
        audio, landmarks, _ = generate_signals(60.0, 30.0, "delayed")
        return _fields(None, landmarks[::6], 60.0, 30.0, audio_envelope=audio)
    if case == "short_clip":
        audio, landmarks, _ = generate_signals(2.0, 30.0, "perfect")
        return _fields(audio, landmarks, 2.0, 30.0)
    audio, landmarks, _ = generate_signals(5.0, 30.0, "perfect")
    early = {  # each early-out of c1:35-97
        "no_faces": dict(face_detections=[]),
        "no_landmarks": dict(mouth_landmarks=[]),
        "no_fps": dict(metadata={"duration": 5.0}),
        "no_duration": dict(metadata={"fps": 30.0}),
        "no_audio": dict(test_audio_signal=None, audio_envelope=None),
    }[case]
    return {**_fields(audio, landmarks), **early}


SCORED = ["perfect", "delayed", "random", "silence", "static_face", "half_silence",
          "length_mismatch", "landmarks_20pt", "envelope_not_hook", "hook_before_envelope",
          "sixty_s_30fps", "short_clip"]
EARLY_OUTS = ["no_faces", "no_landmarks", "no_fps", "no_duration", "no_audio"]
#: the reference's golden bands (tests/test_c1_lipsync.py)
BANDS = {"perfect": lambda s: s > 0.8, "delayed": lambda s: s > 0.7, "random": lambda s: s < 0.4,
         "silence": lambda s: s == 0.0, "static_face": lambda s: s == 0.0,
         "half_silence": lambda s: s > 0.5, "length_mismatch": lambda s: s > 0.7}


@pytest.mark.parametrize("case", SCORED + EARLY_OUTS)
def test_node_matches_jax(case, tmp_path):
    fields = _state_fields(case)
    dirs = {k: tmp_path / k for k in ("jax", "torch")}
    for d in dirs.values():
        d.mkdir()
    ref = jc1.run(JState(**fields, data_dir=str(dirs["jax"])))
    got = tc1.run(TState(**fields, data_dir=str(dirs["torch"])), device="cpu")
    assert set(got) == set(ref) == {"lip_sync_score"}
    assert isinstance(got["lip_sync_score"], float)
    assert abs(got["lip_sync_score"] - ref["lip_sync_score"]) <= TOL
    if case in EARLY_OUTS:
        assert got["lip_sync_score"] == 0.0
        assert not (dirs["torch"] / "C1_debug.json").exists()
        return
    if case in BANDS:
        assert BANDS[case](got["lip_sync_score"]), got
    dbg = {k: json.loads((d / "C1_debug.json").read_text()) for k, d in dirs.items()}
    assert abs(dbg["torch"].pop("lip_sync_score") - dbg["jax"].pop("lip_sync_score")) <= TOL
    assert dbg["torch"] == dbg["jax"]


def _geometries():
    rng = np.random.RandomState(0)
    known = np.zeros((20, 2))
    known[0], known[6] = [0, 0], [6, 0]
    known[2], known[10] = [2, 1], [2, -1]
    known[3], known[9] = [3, 2], [3, -2]
    known[4], known[8] = [4, 1.5], [4, -1.5]
    return {
        "known": known,
        "known_as_lists": known.tolist(),
        "random_f32": (rng.rand(20, 2) * 100).astype(np.float32),
        "random_f64": rng.rand(20, 2) * 100,
        "more_than_20": rng.rand(68, 2),
        "too_few": np.zeros((19, 2)),
        "zero_width": np.zeros((20, 2)),
        "none": None,
        "empty": [],
    }


@pytest.mark.parametrize("name", sorted(_geometries()))
def test_calculate_mar_exactly_equal(name):
    pts = _geometries()[name]
    got, ref = tc1.calculate_mar(pts), jc1.calculate_mar(pts)
    assert type(got) is type(ref) is float
    assert got == ref
    if name == "known":
        assert got == pytest.approx((2 + 4 + 3) / (3 * 6))


def test_node_on_the_card_raises_without_one(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    fields = _state_fields("perfect")
    with pytest.raises(RuntimeError, match="cuda"):
        tc1.run(TState(**fields))


#: 8 videos of 10 s at 30 fps, one signal length, so one coalescer key
GROUP = [("perfect", 0), ("delayed", 1), ("random", 2), ("silence", 3), ("perfect", 4),
         ("random", 5), ("static_face", 6), ("delayed", 7)]


def _group_states():
    out = []
    for kind, seed in GROUP:
        audio, landmarks, _ = generate_signals(10.0, 30.0, kind, seed=seed)
        out.append(_fields(None, landmarks[::6], 10.0, 30.0, audio_envelope=audio))
    return out


def _run_concurrently(run, states, coalesce):
    deactivate = coalesce._activate_program_coalescer(max_wait_ms=30.0)
    co = coalesce._program_co
    try:
        with ThreadPoolExecutor(len(states)) as pool:
            scores = [d["lip_sync_score"] for d in pool.map(run, states)]
        return scores, co.groups_run, co.items_served
    finally:
        deactivate()


def test_coalesced_group_matches_jax_and_single_calls():
    fields = _group_states()
    ref, _, _ = _run_concurrently(lambda f: jc1.run(JState(**f)), fields, jco)
    _kernels.reset_launches()
    got, groups, served = _run_concurrently(lambda f: tc1.run(TState(**f), device="cpu"), fields, tco)
    assert not tco.program_coalescing_active() and not jco.program_coalescing_active()
    assert _kernels.LAUNCHES["lipsync_score"] == 0  # the CPU runs the plain version
    assert served == len(fields) and groups < len(fields)  # at least one group merged
    single = [tc1.run(TState(**f), device="cpu")["lip_sync_score"] for f in fields]
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, single, atol=GROUP_TOL, rtol=0)
    assert len(set(np.round(got, 4))) >= 4  # the kinds score apart


def test_coalescer_keys_apart_lengths_rates_and_configs():
    """Videos of other lengths, rates or C1 settings never share a group."""
    base = _group_states()[0]
    audio, landmarks, _ = generate_signals(12.0, 30.0, "perfect")
    other_len = _fields(None, landmarks[::6], 12.0, 30.0, audio_envelope=audio)
    audio, landmarks, _ = generate_signals(10.0, 25.0, "perfect")
    other_fps = _fields(None, landmarks[::5], 10.0, 25.0, audio_envelope=audio)
    from fvd_tpu_torch.config import default_config

    cfg = default_config()
    sharp = dataclasses.replace(cfg, lip_sync=dataclasses.replace(cfg.lip_sync, sharpness_threshold=2.0))
    jobs = [(base, cfg), (other_len, cfg), (other_fps, cfg), (base, sharp)]
    deactivate = tco._activate_program_coalescer(max_wait_ms=30.0)
    co = tco._program_co
    try:
        with ThreadPoolExecutor(len(jobs)) as pool:
            got = list(pool.map(lambda j: tc1.run(TState(**j[0]), config=j[1], device="cpu"), jobs))
        groups = co.groups_run
    finally:
        deactivate()
    assert groups == len(jobs)
    single = [tc1.run(TState(**f), config=c, device="cpu")["lip_sync_score"] for f, c in jobs]
    np.testing.assert_allclose([d["lip_sync_score"] for d in got], single, atol=GROUP_TOL, rtol=0)
