"""C1 lip-sync: the port's plain path against the JAX package's XLA path and
its Pallas kernel (interpret mode on the CPU, as ``tests/test_c1_lipsync.py``
runs it), the batched scorer and the stage wrapper's CPU route, and numpy
models of the CUDA stage kernel's algorithm (the kernel itself runs only on
the card: ``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvd_tpu.ops import lipsync as jlip
from fvd_tpu_torch import _kernels
from fvd_tpu_torch.c1_timing import make_signals
from fvd_tpu_torch.ops import lipsync as tlip
from test_torch_cuda import bessel_gate_signal

#: the bar the JAX package sets between its own XLA and Pallas paths
TOL = 1e-5


def generate_signals(duration, fps, sync_type="perfect", seed=42):
    """The reference's synthetic generator (its test_c1_lip_sync_score.py:22-56)."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0, duration, int(duration * fps))
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
    return audio.astype(np.float32), mouth.astype(np.float32)


def _both_jax(mouth, audio, fps):
    m, a = jnp.asarray(mouth), jnp.asarray(audio)
    return (jlip.lip_sync_score_xla(m, a, fps),
            jlip.lip_sync_score_pallas(m, a, fps, interpret=jax.default_backend() != "tpu"))


def _port(mouth, audio, fps):
    return tlip.lip_sync_score(torch.from_numpy(mouth), torch.from_numpy(audio), fps)


# (sync type, duration s, fps, golden band on the score)
CASES = [
    ("perfect", 5.0, 30.0, lambda s: s > 0.8),
    ("delayed", 5.0, 30.0, lambda s: s > 0.7),
    ("random", 5.0, 30.0, lambda s: s < 0.4),
    ("silence", 5.0, 30.0, lambda s: s == 0.0),
    ("static_face", 5.0, 30.0, lambda s: s == 0.0),
    ("perfect", 12.0, 30.0, lambda s: s > 0.8),
    ("random", 12.0, 30.0, lambda s: s < 0.4),
    ("perfect", 10.0, 5.0, lambda s: s > 0.5),   # the analyzer's 5 fps landmark rate
    ("perfect", 2.0, 30.0, lambda s: 0.25 < s < 0.55),  # short: one 60-sample window / 150
    ("perfect", 20.0, 30.0, lambda s: s > 0.8),
]


@pytest.mark.parametrize("sync,duration,fps,band", CASES,
                         ids=[f"{c[0]}-{c[1]}s-{c[2]}fps" for c in CASES])
def test_port_matches_xla_and_pallas(sync, duration, fps, band):
    audio, mouth = generate_signals(duration, fps, sync)
    r_xla, r_pl = _both_jax(mouth, audio, fps)
    r = _port(mouth, audio, fps)
    assert float(r.score) == pytest.approx(float(r_xla.score), abs=TOL)
    assert float(r.score) == pytest.approx(float(r_pl.score), abs=TOL)
    assert int(r.n_valid) == int(r_xla.n_valid) == int(r_pl.n_valid)
    assert r.n_windows == int(r_xla.n_windows)
    assert band(float(r.score))


def test_window_counts_and_short_signal_normalization():
    audio, mouth = generate_signals(20.0, 30.0, "perfect")
    r = _port(mouth, audio, 30.0)
    assert r.n_windows == 7 and int(r.n_valid) == 7  # (600-150)//75+1
    audio, mouth = generate_signals(2.0, 30.0, "perfect")
    assert tlip.window_params(60, 30.0) == (60, 60, 1)
    # a 60-sample window still divides by int(5*fps) = 150
    assert 0.25 < float(_port(mouth, audio, 30.0).score) < 0.55


def test_half_silent_signal_gates_windows():
    audio, mouth = generate_signals(20.0, 30.0, "perfect")
    audio[: len(audio) // 2] = 0.0
    r_xla, r_pl = _both_jax(mouth, audio, 30.0)
    r = _port(mouth, audio, 30.0)
    assert 0 < int(r.n_valid) < r.n_windows
    assert int(r.n_valid) == int(r_xla.n_valid) == int(r_pl.n_valid)
    assert float(r.score) == pytest.approx(float(r_xla.score), abs=TOL)


def test_stds_population_for_znorm_bessel_for_gate():
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 50).astype(np.float32))
    z = tlip._znorm(x)
    assert float(z.std(correction=0)) == pytest.approx(1.0, abs=1e-5)
    ref = np.asarray(jlip._znorm(jnp.asarray(x.numpy()[0])))
    np.testing.assert_allclose(z.numpy()[0], ref, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_half_mean_matches_jax(seed):
    rng = np.random.RandomState(seed)
    scores = rng.randn(4, 7).astype(np.float32)
    valid = rng.rand(4, 7) > 0.4
    valid[0] = False
    ref = [float(jlip._top_half_mean(jnp.asarray(s), jnp.asarray(v))) for s, v in zip(scores, valid)]
    got = tlip._top_half_mean(torch.from_numpy(scores), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert got[0] == 0.0


def test_mar_matches_jax():
    pts = np.random.RandomState(0).rand(7, 20, 2).astype(np.float32) * 100
    pts[3, 6] = pts[3, 0]  # D == 0
    ref = np.asarray(jlip.mar_from_points(jnp.asarray(pts)))
    got = tlip.mar_from_points(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert got[3] == 0.0


def test_batch_matches_per_video_scores():
    fps, n = 30.0, 300
    rng = np.random.RandomState(3)
    pairs = [generate_signals(10.0, fps, s, seed=i) for i, s in
             enumerate(["perfect", "delayed", "random", "silence", "static_face", "perfect"])]
    audios = np.stack([p[0] for p in pairs])
    mouths = np.stack([p[1] for p in pairs])
    mouths[5] += 0.05 * rng.rand(n).astype(np.float32)
    rb = tlip.lip_sync_score_batch(torch.from_numpy(mouths), torch.from_numpy(audios), fps)
    assert rb.score.shape == (6,) and rb.n_valid.shape == (6,)
    jb = jlip.lip_sync_score_batch(mouths, audios, fps)
    for i in range(6):
        r = _port(mouths[i], audios[i], fps)
        assert float(rb.score[i]) == pytest.approx(float(r.score), abs=TOL)
        assert float(rb.score[i]) == pytest.approx(float(jb[i].score), abs=TOL)
        assert int(rb.n_valid[i]) == int(r.n_valid) == int(jb[i].n_valid)


def test_window_wrapper_takes_the_plain_route_on_cpu_without_counting():
    """The stage wrapper on CPU tensors is the plain stage, and counts no launch."""
    rng = np.random.RandomState(5)
    m = torch.from_numpy(rng.rand(3, 50).astype(np.float32))
    a = torch.from_numpy(rng.rand(3, 50).astype(np.float32))
    before = dict(_kernels.LAUNCHES)
    r = tlip.lip_sync_score_batch(m, a, 5.0)
    r_p = tlip.lip_sync_score_batch_plain(m, a, 5.0)
    for got, want in zip(r, r_p):
        assert got == want if isinstance(got, int) else torch.equal(got, want)
    assert r.score.shape == (3,) and r.n_valid.dtype == torch.int32
    assert r.window_scores.shape == (3, 3) and r.window_valid.dtype == torch.bool
    assert _kernels.LAUNCHES == before


def test_window_plain_matches_pallas_kernel_per_window():
    """The plain window function against ``lip_sync_scores_pallas`` itself,
    fed the padded windows it takes (interpret mode)."""
    fps, n = 30.0, 300
    audio, mouth = generate_signals(10.0, fps, "delayed")
    window, step, n_win = tlip.window_params(n, fps)
    L = int(0.5 * fps)
    m = tlip._znorm(torch.from_numpy(mouth)[None])
    a = tlip._znorm(torch.from_numpy(audio)[None])
    s, v = tlip.lip_sync_window_scores_plain(m, a, window, step, n_win, L, 150.0)
    wm = m[0].unfold(0, window, step).numpy()
    wa = a[0].unfold(0, window, step).numpy()
    wm_p = np.pad(wm, ((0, 0), (0, 128 * 2 - window)))
    wa_p = np.pad(np.pad(wa, ((0, 0), (L, L))), ((0, 0), (0, 128 * 3 - window - 2 * L)))
    s_ref, v_ref = jlip.lip_sync_scores_pallas(jnp.asarray(wm_p), jnp.asarray(wa_p), window, L, 150,
                                               interpret=True)
    np.testing.assert_allclose(s.numpy()[0], np.asarray(s_ref), atol=TOL)
    assert v.numpy()[0].tolist() == np.asarray(v_ref).tolist()


def test_window_wrapper_rejects_mixed_devices():
    m = torch.zeros(1, 50)
    with pytest.raises(ValueError):
        tlip.lip_sync_score_batch(m, torch.zeros(1, 50, device="meta"), 5.0)
    with pytest.raises(ValueError):
        tlip.lip_sync_score_batch(torch.zeros(1, 50, device="meta"), m, 5.0)


def test_window_gate_uses_bessel_std():
    """A window whose population std is just under ``silence_std`` and whose
    Bessel std is just over it is valid, as in the Pallas kernel."""
    W, L = 150, 15
    a = 0.00999  # population std of +-a; Bessel std a * sqrt(150/149) = 0.010023
    sig = torch.tensor([a, -a] * (W // 2), dtype=torch.float32)[None]
    s, v = tlip.lip_sync_window_scores_plain(sig, sig, W, W, 1, L, 150.0)
    wa = np.pad(np.pad(sig.numpy(), ((0, 0), (L, L))), ((0, 0), (0, 384 - W - 2 * L)))
    wm = np.pad(sig.numpy(), ((0, 0), (0, 256 - W)))
    s_ref, v_ref = jlip.lip_sync_scores_pallas(jnp.asarray(wm), jnp.asarray(wa), W, L, 150,
                                               interpret=True)
    assert bool(v[0, 0]) and bool(np.asarray(v_ref)[0])
    assert float(s[0, 0]) == pytest.approx(float(np.asarray(s_ref)[0]), abs=TOL)


# ------------------------------------------------------------- the stage kernel
def test_stage_gate_uses_bessel_std():
    """A raw row whose first z-normalised window has a Bessel std just over
    ``silence_std`` and a population std just under it: the window is valid,
    in the plain stage and in the JAX package's stage."""
    sig = bessel_gate_signal()
    z0 = (sig - sig.mean()) / sig.std()
    assert z0[:150].std() < 0.01 <= z0[:150].std(ddof=1)
    r = tlip.lip_sync_score_batch_plain(torch.from_numpy(sig)[None], torch.from_numpy(sig)[None], 30.0)
    assert r.window_valid[0].tolist() == [True, True, True] and int(r.n_valid[0]) == 3
    r_xla = jlip.lip_sync_score_xla(jnp.asarray(sig), jnp.asarray(sig), 30.0)
    assert int(r_xla.n_valid) == 3
    assert float(r.score[0]) == pytest.approx(float(r_xla.score), abs=TOL)


@pytest.mark.parametrize("jax_path", ["xla", "pallas"])
def test_stage_plain_matches_jax_at_dag_shape(jax_path):
    """The plain stage at the DAG node's shape (60 s at 30 fps, 23 windows),
    four videos with one silent and one static row, against the JAX package's
    batched XLA stage or its Pallas stage (interpret mode), to its own 1e-5
    bar between those two paths."""
    fps, n = 30.0, 1800
    mouths, audios = make_signals(4, n, fps, "speech", np.random.RandomState(11))
    audios[1] = 0.0   # silent
    mouths[2] = 0.5   # static face
    r = tlip.lip_sync_score_batch_plain(torch.from_numpy(mouths), torch.from_numpy(audios), fps)
    assert r.n_windows == 23 and r.window_scores.shape == (4, 23)
    if jax_path == "xla":
        ref = jlip.lip_sync_score_batch(mouths, audios, fps)
    else:
        ref = [jlip.lip_sync_score_pallas(jnp.asarray(mm), jnp.asarray(aa), fps, interpret=True)
               for mm, aa in zip(mouths, audios)]
    for i in range(4):
        assert float(r.score[i]) == pytest.approx(float(ref[i].score), abs=TOL)
        assert int(r.n_valid[i]) == int(ref[i].n_valid)
    assert r.n_valid[1:3].tolist() == [0, 0] and r.score[1:3].tolist() == [0.0, 0.0]
    assert int(r.n_valid[0]) == 23 and float(r.score[0]) > 0.7


def _rank_select_top_half_mean(scores, valid):
    """numpy model of the kernel's phase 3: with invalid windows held as -inf,
    window i is kept iff it is valid and fewer than k = max(1, n_valid // 2)
    windows beat it (a higher score, or the same score at a lower index); mean
    of the kept, clamped at 0."""
    n_valid = int(valid.sum())
    k = max(1, n_valid // 2)
    held = np.where(valid, scores, -np.inf)
    kept = 0.0
    for i in np.flatnonzero(valid):
        beaten_by = sum(1 for j in range(len(held))
                        if held[j] > held[i] or (held[j] == held[i] and j < i))
        kept += held[i] if beaten_by < k else 0.0
    return max(kept / k, 0.0) if n_valid else 0.0


_RANK_CASES = {
    "ties": ([0.5, 0.7, 0.5, 0.7, 0.5, 0.1], [1, 1, 1, 1, 1, 1]),
    "all_tied": ([0.3] * 7, [1] * 7),
    "tie_at_the_cut": ([0.9, 0.4, 0.4, 0.4, 0.2], [1, 1, 1, 1, 1]),
    "all_invalid": ([0.9, 0.8, 0.7], [0, 0, 0]),
    "one_valid": ([0.9, 0.2, 0.8], [0, 1, 0]),
    "one_window": ([0.6], [1]),
    "negative_clamped": ([-0.2, -0.1, -0.3, 0.05], [1, 1, 1, 0]),
    "invalid_beats_valid": ([0.99, 0.1, 0.2, 0.3], [0, 1, 1, 1]),
}


@pytest.mark.parametrize("case", sorted(_RANK_CASES))
def test_kernel_rank_selection_matches_top_half_mean(case):
    scores, valid = (np.asarray(x) for x in _RANK_CASES[case])
    scores, valid = scores.astype(np.float32), valid.astype(bool)
    want = float(jlip._top_half_mean(jnp.asarray(scores), jnp.asarray(valid)))
    assert _rank_select_top_half_mean(scores, valid) == pytest.approx(want, abs=1e-7)
    got = tlip._top_half_mean(torch.from_numpy(scores)[None], torch.from_numpy(valid)[None])
    assert float(got[0]) == pytest.approx(want, abs=1e-7)


def _stage_kernel_model(mouth, audio, fps):
    """numpy (float64) model of ``csrc/lipsync_score.cu`` for one video, in
    its own steps: the rows' z-normalisation, each window staged into a slice
    of round4(W) mouth values (zeros past W) and round4(W) + 2L audio values
    (zero lag padding), the Bessel gate, lag l as dot(wm, wa[l : l + round4(W)])
    and the rank-selection top-half mean."""
    n = len(mouth)
    window, step, n_win = tlip.window_params(n, fps)
    L, norm_div = int(fps * 0.5), float(int(5.0 * fps))
    wp = -(-window // 4) * 4
    zm = (mouth - mouth.mean()) / (mouth.std() + 1e-9)
    za = (audio - audio.mean()) / (audio.std() + 1e-9)
    scores, valid = np.zeros(n_win), np.zeros(n_win, bool)
    for w in range(n_win):
        wm = np.zeros(wp)
        wa = np.zeros(wp + 2 * L)
        wm[:window] = zm[w * step:w * step + window]
        wa[L:L + window] = za[w * step:w * step + window]
        valid[w] = wa[L:L + window].std(ddof=1) >= 0.01 and wm[:window].std(ddof=1) >= 0.01
        cc = np.array([wm @ wa[l:l + wp] for l in range(2 * L + 1)]) / norm_div
        mx = cc.max()
        scores[w] = mx * 0.5 if mx / (np.abs(cc).mean() + 1e-9) < 1.5 else mx
    return _rank_select_top_half_mean(scores, valid), int(valid.sum()), scores, valid


@pytest.mark.parametrize("batch,n,fps,kind", [
    (1, 50, 5.0, "speech"), (1, 300, 30.0, "speech"), (1, 40, 30.0, "speech"),
    (3, 300, 30.0, "silent"), (2, 600, 30.0, "ties"), (2, 611, 25.0, "speech"),
])
def test_stage_kernel_model_matches_plain_stage(batch, n, fps, kind):
    """The kernel's algorithm, modelled in numpy, against the plain stage at
    the chip check's shapes: float64 against float32, so within 1e-5."""
    mouths, audios = make_signals(batch, n, fps, kind, np.random.RandomState(n))
    r = tlip.lip_sync_score_batch_plain(torch.from_numpy(mouths), torch.from_numpy(audios), fps)
    for i in range(batch):
        score, n_valid, scores, valid = _stage_kernel_model(
            mouths[i].astype(np.float64), audios[i].astype(np.float64), fps)
        assert float(r.score[i]) == pytest.approx(score, abs=TOL)
        assert int(r.n_valid[i]) == n_valid
        np.testing.assert_allclose(r.window_scores[i].numpy(), scores, atol=TOL)
        assert r.window_valid[i].tolist() == valid.tolist()


def test_kernel_slices_fit_its_shared_memory():
    """Warps that take windows: one per window up to 16 at the main path's
    shapes; the largest window the earlier per-window kernel took (2W + 2L
    floats = 48 KB) still fits; past the shared memory the check raises."""
    assert tlip.kernel_slices(25, 2, 3) == 3            # the analyzer: 3 windows
    assert tlip.kernel_slices(150, 15, 239) == 16       # 10 min at 30 fps
    assert tlip.kernel_slices(6000, 144, 100) >= 1      # (2*6000 + 2*144) * 4 = 49152 B
    with pytest.raises(ValueError):
        tlip.kernel_slices(30000, 15, 1)
    with pytest.raises(ValueError):
        tlip.kernel_slices(150, 15, 50000)


def test_single_video_view_carries_window_results():
    audio, mouth = generate_signals(12.0, 30.0, "perfect")
    r = _port(mouth, audio, 30.0)
    assert r.window_scores.shape == (r.n_windows,) and r.window_valid.shape == (r.n_windows,)
    assert int(r.window_valid.sum()) == int(r.n_valid) == r.n_windows
