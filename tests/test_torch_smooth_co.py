"""The port's coalesced smoothing (``fvd_tpu_torch/nodes/_smooth.py``) against
its own per-video scans and against ``fvd_tpu/nodes/_smooth.py``: the cases
of ``tests/test_filters_and_tracking.py:149-250``.  Under an active program
coalescer concurrent videos' chunks run as one host loop; each video's
outputs and carries must equal its own scan bit for bit (NaN where a row is
invalid), the carry hand-off and the power-of-two time padding included."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from fvd_tpu.nodes import _smooth as jsmooth
from fvd_tpu.ops import filters as jfilt
from fvd_tpu.providers import coalesce as jcoalesce
from fvd_tpu_torch.nodes import _smooth
from fvd_tpu_torch.ops.filters import one_euro_init_carry, one_euro_scan_chunk, v4_smooth_chunk
from fvd_tpu_torch.providers import coalesce
from fvd_tpu_torch.runtime import Tracer, set_tracer

#: port against JAX, both coalesced: the JAX test's bar (the two OneEuro
#: loops differ by about one float32 ulp a step, ``tests/test_torch_tracking.py``)
JAX_TOL = 1e-5
V4_KW = dict(lm_min_cutoff=0.5, lm_beta=0.1, pose_min_cutoff=0.1, pose_beta=0.1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _v4_inputs(T, seed):
    r = np.random.RandomState(seed)
    return (np.cumsum(0.2 + 0.05 * r.rand(T)), r.randn(T, 68, 3), r.rand(T) > 0.2, r.randn(T, 3), r.rand(T) > 0.3)


def _oe_inputs(T, seed):
    r = np.random.RandomState(seed)
    return np.cumsum(0.2 + 0.05 * r.rand(T)), r.randn(T, 68, 2), r.rand(T) > 0.2


def _v4_two_chunks(fn, args, split=5):
    """Two chained chunks of one video (the carry hand-off): every output
    and both final carries."""
    t, lm, lv, pose, pv = args
    a = fn(one_euro_init_carry((68, 3)), one_euro_init_carry((3,)), t[:split], lm[:split], lv[:split],
           pose[:split], pv[:split], **V4_KW)
    b = fn(a[3], a[4], t[split:], lm[split:], lv[split:], pose[split:], pv[split:], **V4_KW)
    return [np.asarray(x) for x in a[:3] + b[:3]] + [np.asarray(c) for c in b[3] + b[4]]


def _oe_run(fn, args):
    """V3's scan of one chunk from a fresh carry: the output and the carry."""
    out, c = fn(one_euro_init_carry((68, 2)), *args, min_cutoff=0.5, beta=0.1)
    return [np.asarray(out)] + [np.asarray(x) for x in c]


def _concurrently(fn, items):
    """``fn`` over ``items`` on one thread each under an active program
    coalescer with a wide window (the calls meet), and the tracer's
    coalesced smoothing groups."""
    tracer = set_tracer(Tracer())
    deactivate = coalesce._activate_program_coalescer(max_wait_ms=60.0)
    try:
        assert coalesce.program_coalescing_active()
        with ThreadPoolExecutor(len(items)) as pool:
            out = list(pool.map(fn, items))
    finally:
        deactivate()
        set_tracer(None)
    groups = [sp.meta["n"] for sp in tracer.spans if sp.name in ("coalesce/oe_smooth", "coalesce/v4_smooth")]
    return out, groups


def _bit_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_coalesced_v4_smoothing_is_bit_equal_to_each_videos_scan():
    """Three videos whose chunks have different lengths (5 + 6, 5 + 2 and
    5 + 6 samples: buckets 8, 8 and 8) run at once: each video's smoothed
    landmarks, EAR, pose and carries equal its own plain scan's."""
    vids = [_v4_inputs(11, 1), _v4_inputs(7, 2), _v4_inputs(11, 3)]
    ref = [_v4_two_chunks(v4_smooth_chunk, v) for v in vids]
    got, groups = _concurrently(lambda v: _v4_two_chunks(_smooth.v4_smooth_chunk_co, v), vids)
    assert max(groups) >= 2 and sum(groups) == 2 * len(vids)
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            _bit_equal(a, b)


def test_coalesced_one_euro_is_bit_equal_to_each_videos_scan():
    """V3's scan: chunks of 9, 13 and 3 samples (buckets 16, 16 and 8) at
    once; outputs and carries bit-equal, the NaNs of invalid rows in
    place."""
    vids = [_oe_inputs(9, 10), _oe_inputs(13, 11), _oe_inputs(3, 12)]
    ref = [_oe_run(one_euro_scan_chunk, v) for v in vids]
    got, groups = _concurrently(lambda v: _oe_run(_smooth.one_euro_scan_chunk_co, v), vids)
    assert max(groups) >= 2 and sum(groups) == len(vids)
    assert any(np.isnan(r[0]).any() for r in ref)
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            _bit_equal(a, b)


def test_inactive_coalescer_calls_the_plain_scans(monkeypatch):
    assert not coalesce.program_coalescing_active()
    calls = []
    monkeypatch.setattr(coalesce, "run_program", lambda *a: calls.append(a))
    t, lm, lv, pose, pv = _v4_inputs(6, 4)
    got = _smooth.v4_smooth_chunk_co(one_euro_init_carry((68, 3)), one_euro_init_carry((3,)), t, lm, lv, pose, pv,
                                     **V4_KW)
    ref = v4_smooth_chunk(one_euro_init_carry((68, 3)), one_euro_init_carry((3,)), t, lm, lv, pose, pv, **V4_KW)
    assert calls == []
    for a, b in zip(got[:3], ref[:3]):
        _bit_equal(a, b)


def _jax_concurrently(fn, items):
    deactivate = jcoalesce._activate_program_coalescer(max_wait_ms=60.0)
    try:
        with ThreadPoolExecutor(len(items)) as pool:
            return list(pool.map(fn, items))
    finally:
        deactivate()


def _close(a, b):
    np.testing.assert_allclose(np.where(np.isnan(a), -1, a), np.where(np.isnan(b), -1, b), atol=JAX_TOL,
                               rtol=JAX_TOL)


def test_coalesced_v4_smoothing_matches_jax():
    """The port's ``v4_smooth_chunk_co`` against the JAX package's, both
    coalesced over the same three videos, within the JAX test's 1e-5."""
    vids = [_v4_inputs(11, 1), _v4_inputs(7, 2), _v4_inputs(11, 3)]

    def jax_video(args):
        t, lm, lv, pose, pv = args
        a = jsmooth.v4_smooth_chunk_co(jfilt.one_euro_init_carry((68, 3)), jfilt.one_euro_init_carry((3,)),
                                       t[:5], lm[:5], lv[:5], pose[:5], pv[:5], **V4_KW)
        b = jsmooth.v4_smooth_chunk_co(a[3], a[4], t[5:], lm[5:], lv[5:], pose[5:], pv[5:], **V4_KW)
        carries = [np.asarray(c, np.float32) for c in jax.tree_util.tree_leaves((b[3], b[4]))]
        return [np.asarray(x) for x in a[:3] + b[:3]] + carries

    want = _jax_concurrently(jax_video, vids)
    got, _ = _concurrently(lambda v: _v4_two_chunks(_smooth.v4_smooth_chunk_co, v), vids)
    for w, g in zip(want, got):
        assert len(w) == len(g)
        for a, b in zip(w, g):
            _close(a, np.asarray(b, np.float32))


def test_coalesced_one_euro_matches_jax():
    vids = [_oe_inputs(9, 10), _oe_inputs(13, 11)]

    def jax_one(args):
        out, c = jsmooth.one_euro_scan_chunk_co(jfilt.one_euro_init_carry((68, 2)), *args, min_cutoff=0.5, beta=0.1)
        return [np.asarray(out)] + [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(c)]

    want = _jax_concurrently(jax_one, vids)
    got, _ = _concurrently(lambda v: _oe_run(_smooth.one_euro_scan_chunk_co, v), vids)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            _close(a, np.asarray(b, np.float32))
