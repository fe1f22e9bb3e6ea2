"""Serving: the port's ``ScoringService`` on the CPU answers concurrent
requests as per-request scoring does, and the JAX package's service agrees;
entry points asked for a card that is not there raise."""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from fvd_tpu.serving import ScoringService as JaxScoringService
from fvd_tpu_torch import entry as tentry
from fvd_tpu_torch import resolve_device
from fvd_tpu_torch.ops import fusion
from fvd_tpu_torch.ops.lipsync import lip_sync_score
from fvd_tpu_torch.serving import MicroBatcher, ScoreRequest, ScoringService

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "lr_parity.json")
with open(FIXTURE) as f:
    WEIGHTS = json.load(f)["weights"]
TOL = 1e-5  # the JAX package's own bar between batched and per-request scoring


def _request(seed, n, fps, sync=True):
    rng = np.random.RandomState(seed)
    t = np.linspace(0, n / fps, n)
    env = np.clip(0.5 * (1 + np.sin(2 * np.pi * 2 * t)) + 0.1 * rng.rand(n), 0, 1)
    mouth = env if sync else rng.rand(n)
    return ScoreRequest(mouth=mouth.astype(np.float32), audio=env.astype(np.float32),
                        other_feats=rng.rand(8).astype(np.float32))


def _expected(r, fps):
    lip = float(lip_sync_score(torch.from_numpy(r.mouth), torch.from_numpy(r.audio), fps).score)
    w, b = fusion.weights_to_vectors(WEIGHTS)
    feats = np.concatenate([r.other_feats[:2], [lip], r.other_feats[2:]]).astype(np.float64)
    return lip, 1.0 / (1.0 + np.exp(-(feats @ w + float(b))))


@pytest.mark.parametrize("n,fps", [(300, 30.0), (50, 5.0)])
def test_concurrent_requests_match_per_request_scoring(n, fps):
    reqs = [_request(i, n, fps, sync=(i % 2 == 0)) for i in range(12)]
    svc = ScoringService(WEIGHTS, n=n, fps=fps, max_batch=8, max_wait_ms=20.0, devices=["cpu"])
    try:
        with ThreadPoolExecutor(6) as pool:
            results = list(pool.map(lambda r: svc.score(r, timeout=60), reqs))
        assert svc.batcher.items_served == 12
        assert 1 <= svc.batcher.batches_run < 12  # concurrent requests were batched
    finally:
        svc.close()
    for r, res in zip(reqs, results):
        lip, prob = _expected(r, fps)
        assert res["lip_sync_score"] == pytest.approx(lip, abs=TOL)
        assert res["fake_probability"] == pytest.approx(prob, abs=TOL)


def test_matches_the_jax_service():
    n, fps = 300, 30.0
    reqs = [_request(10 + i, n, fps, sync=(i % 3 != 0)) for i in range(5)]
    ours = ScoringService(WEIGHTS, n=n, fps=fps, max_batch=8, max_wait_ms=20.0, devices=["cpu"])
    ref = JaxScoringService(WEIGHTS, n=n, fps=fps, max_batch=8, max_wait_ms=20.0)
    try:
        got = [f.result(timeout=60) for f in [ours.submit(r) for r in reqs]]
        want = [f.result(timeout=120) for f in [ref.submit(r) for r in reqs]]
    finally:
        ours.close()
        ref.close()
    for g, w in zip(got, want):
        assert g["lip_sync_score"] == pytest.approx(w["lip_sync_score"], abs=TOL)
        assert g["fake_probability"] == pytest.approx(w["fake_probability"], abs=TOL)


def test_wrong_length_request_fails_its_future():
    svc = ScoringService(WEIGHTS, n=50, fps=5.0, devices=["cpu"])
    try:
        with pytest.raises(ValueError):
            svc.score(_request(0, 40, 5.0), timeout=30)
    finally:
        svc.close()


def test_microbatcher_pads_to_power_of_two_buckets():
    calls = []

    def batch_fn(items):
        calls.append(len(items))
        return [x * 2 for x in items]

    mb = MicroBatcher(batch_fn, max_batch=8, max_wait_ms=50.0)
    try:
        results = [f.result(timeout=5) for f in [mb.submit(i) for i in range(6)]]
    finally:
        mb.close()
    assert results == [0, 2, 4, 6, 8, 10]
    assert mb.items_served == 6 and all(c in (1, 2, 4, 8) for c in calls)
    assert mb.submit(1).exception(timeout=1) is not None  # closed


def test_asking_for_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        ScoringService(WEIGHTS, n=50, fps=5.0)  # default device is the card
    with pytest.raises(RuntimeError):
        tentry.entry()
    assert resolve_device("cpu") == torch.device("cpu")
