"""The slice as a whole: the {C1 -> LR} tail of the DAG on each package's
``Scheduler``, one ``invoke`` per video from a thread pool as
``batch.run_pipeline_many`` overlaps them, with and without the program
coalescer; the port on ``device="cpu"``.

The inputs are what A3 and V3 would have written: face detections, mouth
landmarks at V3's 5 fps (MAR values or 20 points), an A3 envelope of
``duration * fps`` samples (one of another length, which C1 reconciles) and
the clip's fps and duration."""

import functools
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import fvd_tpu.config as jconfig
import fvd_tpu.nodes.c1_lipsync as jc1
import fvd_tpu.nodes.lr_fusion as jlr
import fvd_tpu.providers.coalesce as jco
import fvd_tpu.runtime as jrt
import fvd_tpu.state as jstate
import fvd_tpu_torch.config as tconfig
import fvd_tpu_torch.nodes.c1_lipsync as tc1
import fvd_tpu_torch.nodes.lr_fusion as tlr
import fvd_tpu_torch.providers.coalesce as tco
import fvd_tpu_torch.runtime as trt
import fvd_tpu_torch.state as tstate
from fvd_tpu_torch import _kernels
from test_torch_c1_node import _mouth_points, generate_signals

#: f32 lip-sync scores on both sides, summed in different orders
LIP_TOL = 1e-5
#: fake_probability moves with lip_sync through w[lip_sync] = -0.46 / 4 at most
PROB_TOL = 1e-6

PACKAGES = {
    "jax": (jrt, jstate, jconfig, jc1, jlr, jco, {}),
    "torch": (trt, tstate, tconfig, tc1, tlr, tco, {"device": "cpu"}),
}
#: (kind, seconds, landmark form, envelope length factor)
VIDEOS = [("perfect", 10.0, "mar", 1.0), ("delayed", 10.0, "mar", 0.5),
          ("random", 10.0, "mar", 1.0), ("silence", 10.0, "mar", 1.0),
          ("perfect", 10.0, "points", 1.0), ("delayed", 12.0, "points", 0.75)]


def _fields(i):
    kind, seconds, form, factor = VIDEOS[i]
    fps = 30.0
    audio, marks, mouth = generate_signals(seconds, fps, kind, seed=i)
    marks = marks[::6]  # V3 samples at 5 fps
    if form == "points":
        rng = np.random.RandomState(100 + i)
        marks = [{"timestamp": m["timestamp"], "landmarks": _mouth_points(m["mar"], rng)} for m in marks]
    if factor != 1.0:
        n = int(len(audio) * factor)
        audio = np.interp(np.linspace(0, 1, n), np.linspace(0, 1, len(audio)), audio)
    return dict(input_path=f"video_{i}.mp4", metadata={"fps": fps, "duration": seconds},
                face_detections=[{"timestamp": 0.0, "box": [40, 30, 200, 210], "confidence": 0.9}],
                mouth_landmarks=marks, audio_envelope=audio)


def _run_package(name, root, coalesce):
    """Final states, the program coalescer's groups, and the tracer's span
    counts of every video run through ``name``'s scheduler."""
    runtime, state_mod, config_mod, c1, lr, co_mod, c1_kwargs = PACKAGES[name]
    cfg = config_mod.default_config()
    cfg = cfg.replace(fusion=type(cfg.fusion)(weights_path=str(root / "lr_weights.json"),
                                              features_dir=str(root / "features")))
    dag = runtime.DAG()
    dag.add_node("C1", functools.partial(c1.run, config=cfg, **c1_kwargs))
    dag.add_node("LR", functools.partial(lr.run, config=cfg), deps=["C1"])
    tracer = runtime.set_tracer(runtime.Tracer())
    deactivate = co_mod._activate_program_coalescer(max_wait_ms=30.0) if coalesce else (lambda: None)
    co = co_mod._program_co
    try:
        with ThreadPoolExecutor(len(VIDEOS)) as pool:
            finals = list(pool.map(lambda i: runtime.Scheduler(dag).invoke(state_mod.State(**_fields(i))),
                                   range(len(VIDEOS))))
        groups = co.groups_run if co is not None else None
    finally:
        deactivate()
        runtime.set_tracer(None)
    caches = {p.name: json.loads(p.read_text()) for p in (root / "features").iterdir()}
    return finals, groups, tracer.counts(), caches


@pytest.fixture(scope="module", params=["sequential_calls", "coalesced"])
def runs(request, tmp_path_factory):
    coalesce = request.param == "coalesced"
    root = tmp_path_factory.mktemp(request.param)
    out = {}
    _kernels.reset_launches()
    for name in PACKAGES:
        (root / name).mkdir()
        out[name] = _run_package(name, root / name, coalesce)
    out["launches"] = _kernels.LAUNCHES["lipsync_score"]
    return request.param, out


@pytest.mark.parametrize("i", range(len(VIDEOS)))
def test_video_matches_jax(runs, i):
    _, out = runs
    got, ref = out["torch"][0][i], out["jax"][0][i]
    assert abs(got.lip_sync_score - ref.lip_sync_score) <= LIP_TOL
    assert abs(got.fake_probability - ref.fake_probability) <= PROB_TOL
    assert got.features.keys() == ref.features.keys()
    for k in got.features:
        assert got.features[k] == pytest.approx(ref.features[k], abs=LIP_TOL, rel=0)
    assert 0.0 < got.fake_probability < 1.0
    cache = out["torch"][3][f"video_{i}.mp4.json"]
    assert cache == got.features
    if VIDEOS[i][0] == "silence":
        assert got.lip_sync_score == 0.0


def test_scheduling_and_spans(runs):
    mode, out = runs
    finals, groups, spans, _ = out["torch"]
    n = len(VIDEOS)
    assert out["launches"] == 0  # the CPU runs the stage's plain version
    assert spans["node/C1"] == spans["node/LR"] == n
    if mode == "coalesced":
        # two signal lengths: at least two groups, and at least one merged
        assert 2 <= groups < n and spans["coalesce/c1_lipsync"] == groups
    else:
        assert groups is None and "coalesce/c1_lipsync" not in spans
    scores = [f.lip_sync_score for f in finals]
    assert len(set(np.round(scores, 3))) >= 4  # the kinds score apart
