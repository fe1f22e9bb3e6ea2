"""``python -m fvd_tpu_torch.tools.accuracy_trajectory`` on the CPU with the
hermetic provider bundle, against the JAX package's
``tools/accuracy_trajectory.py``: a baseline run and two ``--train`` runs
over a labeled corpus of one real and one fake clip, from all-zero LR
weights keyed as the JAX package's ``FEATURE_ORDER``.  The JAX tool runs
with ``fvd_tpu.synthetic.hermetic_providers`` on a copy of the clips the
port made (raw-RGBA AVI files named ``*.mp4``, which it reads through
OpenCV); the two trajectories, attempt counts and results tables must
agree, the probabilities to the bar of ``tests/test_torch_batch.py``."""

import contextlib
import io
import json
import os
import re
import shutil
import sys

import pytest
import torch

import fvd_tpu.providers as jprov
import fvd_tpu.providers.factory as jfactory
from fvd_tpu import batch as jbatch
from fvd_tpu.ops.fusion import FEATURE_ORDER as JFEATURE_ORDER
from fvd_tpu.synthetic import hermetic_providers as jhermetic
from fvd_tpu_torch import batch as tbatch
from fvd_tpu_torch import providers as tprov
from fvd_tpu_torch.providers import media
from fvd_tpu_torch.synthetic import hermetic_providers
from fvd_tpu_torch.tools import accuracy_trajectory as traj

#: the two packages one video at a time (tests/test_torch_batch.py)
PROB_TOL = 1e-5
ARGS = ["--runs", "2", "--baseline-eval", "--fresh-weights", "--n-real", "1", "--n-fake", "1",
        "--duration", "1.0"]
CLIPS = ["clip00_real_news.mp4", "clip01_deepfake.mp4"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(main, argv):
    """``main(argv)`` -> (rc, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's tool, then the JAX tool on a copy of the corpus the port
    made, each from its own directory (they change into their workdir; the
    cwd, ``sys.path`` and the process-wide bundles are restored after) ->
    {"torch"|"jax": (rc, stdout, workdir)}."""
    root = tmp_path_factory.mktemp("traj")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setattr(sys, "path", list(sys.path))  # the JAX tool prepends the repo on import
        mp.setattr(tprov, "_default", tprov.Providers())
        mp.setattr(tprov, "_default_is_custom", False)
        mp.setattr(jprov, "_default", jprov.Providers())
        mp.setattr(jprov, "_default_is_custom", False)
        mp.setattr(traj, "production_providers", lambda **kw: hermetic_providers(device="cpu"))
        mp.setattr(jfactory, "production_providers", lambda *a, **kw: jhermetic())
        rc, stdout = _run(traj.main, ["--workdir", str(root / "torch"), "--cpu"] + ARGS)
        out["torch"] = rc, stdout, root / "torch"
        media.clear_frame_cache()
        # the clips in the order they were made, so that both directories list alike
        os.makedirs(root / "jax" / "videos")
        for name in sorted(os.listdir(root / "torch" / "videos")):
            shutil.copy(root / "torch" / "videos" / name, root / "jax" / "videos" / name)
        import tools.accuracy_trajectory as jtraj

        mp.chdir(root)
        # JAX_PLATFORMS=cpu already holds here, which is what the JAX tool's --cpu forces
        rc, stdout = _run(jtraj.main, ["--workdir", str(root / "jax")] + ARGS)
        out["jax"] = rc, stdout, root / "jax"
    return out


def _table(workdir, run_id):
    """``results/batch_results<run_id>.txt`` -> ({clip: (label, p, pred, status)},
    accuracy)."""
    with open(workdir / "results" / f"batch_results{run_id}.txt") as f:
        table = f.read()
    rows = {}
    for ln in table.splitlines():
        if ln.startswith("clip"):
            cells = [c.strip() for c in ln.split("|")]
            rows[cells[0]] = (cells[1], float(cells[2]), cells[3], cells[4])
    return rows, float(re.search(r"Total Accuracy: ([0-9.]+)%", table).group(1))


def test_trajectory_from_zero_weights(runs):
    rc, out, workdir = runs["torch"]
    assert rc == 0
    assert "generating labeled corpus..." in out and "starting from all-zero LR weights" in out
    assert sorted(os.listdir(workdir / "videos")) == ["clip00_real_news.mp4", "clip00_real_news.wav",
                                                      "clip01_deepfake.mp4", "clip01_deepfake.wav"]
    accs = []
    for run_id in range(3):
        rows, acc = _table(workdir, run_id)
        assert set(rows) == set(CLIPS)
        assert all(0.0 <= row[1] <= 1.0 for row in rows.values()), rows
        if run_id == 0:  # all-zero weights score every clip 0.5 exactly: "real"
            assert all(row[1] == 0.5 for row in rows.values()), rows
        accs.append(acc)
    assert accs[0] == 50.0
    # --train retries every clip until it is classified right
    assert accs[1:] == [100.0, 100.0]
    lines = out.strip().splitlines()
    assert lines[-2] == "trajectory: " + " -> ".join(f"{a:.2f}%" for a in accs)
    # one attempt a clip without --train; the fake needs a second SGD step in
    # run 1, and each clip one more in run 2 (the hermetic bundle's features)
    assert lines[-1] == "attempts:   2 -> 3 -> 4"
    with open(workdir / "lr_weights.json") as f:
        weights = json.load(f)
    assert set(weights) == {"bias", *JFEATURE_ORDER}


def test_trajectory_equals_jax(runs):
    (trc, tout, tdir), (jrc, jout, jdir) = runs["torch"], runs["jax"]
    assert trc == jrc == 0
    assert "generating labeled corpus..." not in jout  # the JAX tool scored the port's clips
    # both harnesses train over the clips in one order
    assert [os.path.basename(p) for p in tbatch.get_videos(str(tdir / "videos"))] \
        == [os.path.basename(p) for p in jbatch.get_videos(str(jdir / "videos"))]
    # the per-run lines, the trajectory and the attempts
    pick = re.compile(r"^(run \d+: accuracy .*|trajectory: .*|attempts: .*)$", re.M)
    assert pick.findall(tout) == pick.findall(jout)
    assert len(pick.findall(tout)) == 5
    for run_id in range(3):
        (trows, tacc), (jrows, jacc) = _table(tdir, run_id), _table(jdir, run_id)
        assert tacc == jacc and set(trows) == set(jrows) == set(CLIPS)
        for clip in CLIPS:
            (tlabel, tp, *tpred), (jlabel, jp, *jpred) = trows[clip], jrows[clip]
            assert (tlabel, tpred) == (jlabel, jpred), (run_id, clip)
            assert tp == pytest.approx(jp, abs=PROB_TOL), (run_id, clip)
    with open(tdir / "lr_weights.json") as f:
        tw = json.load(f)
    with open(jdir / "lr_weights.json") as f:
        jw = json.load(f)
    assert set(tw) == set(jw)
    assert tw == pytest.approx(jw, abs=PROB_TOL)
