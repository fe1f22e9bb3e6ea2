"""OneEuro smoothing, IoU and the face tracker of the port against the JAX
package.  Mirrors
``tests/test_filters_and_tracking.py``; inputs from seeds.

The port's OneEuro step is a host float32 loop doing the JAX scan step's
arithmetic in its order; XLA fuses the step and may contract a multiply-add,
so results differ by about one float32 ulp (measured 1.2e-7 at unit scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fvd_tpu.nodes import _tracking as jtrack
from fvd_tpu.ops import filters as jfilt
from fvd_tpu_torch.nodes import _tracking as ttrack
from fvd_tpu_torch.ops import filters as tfilt

ONE_EURO_TOL = 1e-6  # unit-scale values, float32 on both sides


def _track(T, seed, dims=(68, 2), scale=1.0):
    r = np.random.RandomState(seed)
    times = np.cumsum(0.05 + 0.3 * r.rand(T))
    times[3] = times[2]  # a zero time step: the filter takes t_e = 1
    values = scale * r.randn(T, *dims)
    valid = r.rand(T) > 0.3
    valid[0] = False
    return times, values, valid


def _same(a, b, tol):
    assert np.array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), atol=tol, rtol=0)


@pytest.mark.parametrize("seed,params", [(0, dict(min_cutoff=0.5, beta=0.1)),
                                         (1, dict(min_cutoff=1.0, beta=0.0)),
                                         (2, dict(min_cutoff=0.1, beta=0.7, d_cutoff=2.0))])
def test_one_euro_scan_matches_jax(seed, params):
    times, values, valid = _track(40, seed)
    ref = np.asarray(jfilt.one_euro_scan(jnp.asarray(times), jnp.asarray(values), jnp.asarray(valid), **params))
    got = tfilt.one_euro_scan(times, values, valid, **params)
    assert got.dtype == np.float32
    _same(got, ref, ONE_EURO_TOL)
    assert np.isnan(got[0]).all() and not np.isnan(got[valid]).any()
    first = np.argmax(valid)
    np.testing.assert_array_equal(got[first], values[first].astype(np.float32))  # passes through raw


def test_one_euro_chunks_equal_one_scan_and_jax():
    times, values, valid = _track(37, 5)
    whole = tfilt.one_euro_scan(times, values, valid, min_cutoff=0.5, beta=0.1)
    carry, jcarry, outs, jouts = tfilt.one_euro_init_carry((68, 2)), jfilt.one_euro_init_carry((68, 2)), [], []
    for s in range(0, 37, 8):
        sl = slice(s, s + 8)
        o, carry = tfilt.one_euro_scan_chunk(carry, times[sl], values[sl], valid[sl], min_cutoff=0.5, beta=0.1)
        jo, jcarry = jfilt.one_euro_scan_chunk(jcarry, jnp.asarray(times[sl]), jnp.asarray(values[sl]),
                                               jnp.asarray(valid[sl]), min_cutoff=0.5, beta=0.1)
        outs.append(o)
        jouts.append(np.asarray(jo))
    np.testing.assert_array_equal(np.concatenate(outs), whole)  # chunked == whole, exactly
    _same(np.concatenate(outs), np.concatenate(jouts), ONE_EURO_TOL)
    for a, b in zip(carry, jax.device_get(jcarry)):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=ONE_EURO_TOL)


def test_one_euro_batch_rows_equal_single_calls():
    tracks = [_track(16, s) for s in range(3)]
    ref = [tfilt.one_euro_scan(*t, min_cutoff=0.5, beta=0.1) for t in tracks]
    carry = tuple(np.stack(c) for c in zip(*[tfilt.one_euro_init_carry((68, 2))] * 3))
    out, _ = tfilt.one_euro_scan_chunk(carry, *(np.stack(c) for c in zip(*tracks)), min_cutoff=0.5, beta=0.1)
    for i in range(3):
        np.testing.assert_array_equal(out[i], ref[i])


def test_iou_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(200):
        a = sorted(rng.randint(0, 100, 2).tolist())
        b = sorted(rng.randint(0, 100, 2).tolist())
        box_a = [a[0], b[0], a[1], b[1]]
        box_b = (rng.randint(0, 60, 4) + np.array([0, 0, 40, 40])).tolist()
        assert tfilt.iou(box_a, box_b) == jfilt.iou(box_a, box_b)


def _candidates(rng, n):
    out = []
    for _ in range(n):
        x0, y0 = rng.randint(0, 500), rng.randint(0, 380)
        w, h = rng.randint(5, 200), rng.randint(5, 200)
        out.append(np.stack([x0 + w * rng.rand(68), y0 + h * rng.rand(68)], 1))
    return out


@pytest.mark.parametrize("pad_frac,aspect_gate", [(0.0, True), (0.1, False)])
def test_tracker_and_track_chunk_match_jax(pad_frac, aspect_gate):
    """A run of frames with 0-3 candidate faces each, random jumps that lose
    the track, and an empty frame: the same selections and tracks."""
    rng = np.random.RandomState(7)
    frames = [_candidates(rng, rng.randint(0, 4)) for _ in range(60)]
    frames[10] = []
    kw = dict(frame_width=640, frame_height=480, aspect_gate=aspect_gate, pad_frac=pad_frac)
    jt, tt = jtrack.FaceTracker(jtrack.TrackerConfig(**kw)), ttrack.FaceTracker(ttrack.TrackerConfig(**kw))
    ids = list(range(0, 120, 2))
    ref = jtrack.track_chunk(frames, ids, 10.0, jt, collect_boxes=True, collect_sel=True)
    got = ttrack.track_chunk(frames, ids, 10.0, tt, collect_boxes=True, collect_sel=True)
    assert got[4] == ref[4] and got[3] == ref[3]
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert 0 < got[2].sum() < 60 and len(set(got[4])) > 2


@pytest.mark.parametrize("chunk", [1, 3, 5, 64])
def test_one_euro_chunks_of_any_size_equal_one_scan(chunk):
    """V3's chunk size cuts the track anywhere, a gap or a zero time step
    included: the chained chunks equal the whole scan, carry included."""
    times, values, valid = _track(23, 4)
    kw = dict(min_cutoff=0.5, beta=0.1)
    whole = tfilt.one_euro_scan_chunk(tfilt.one_euro_init_carry((68, 2)), times, values, valid, **kw)
    carry, outs = tfilt.one_euro_init_carry((68, 2)), []
    for s in range(0, 23, chunk):
        o, carry = tfilt.one_euro_scan_chunk(carry, times[s:s + chunk], values[s:s + chunk],
                                             valid[s:s + chunk], **kw)
        outs.append(o)
    np.testing.assert_array_equal(np.concatenate(outs), whole[0])
    for a, b in zip(carry, whole[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
