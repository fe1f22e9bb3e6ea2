"""``fvd_tpu_torch/tools/diagnose_{det,lmkpose}_heldout.py`` against the JAX
package's ``tools/diagnose_{det,lmkpose}_heldout.py`` on the CPU, on the
shipped checkpoints.

* ``render_factored`` gives the JAX tool's image, box and landmarks bit for
  bit over all 16 factor sets at 192, 256 and 300 pixels (with and without
  an aperture), and leaves the generator in the same state.
* Both tables at ``--n 8``: every row within ``FACE_TOL`` of the JAX
  tool's printed one (``tests/test_torch_eval_heldout.py``'s bars; the
  printed values carry 3 decimals), with the detector's and the
  hourglass's backbones in float32 on both sides.  In bfloat16 the two
  packages' convolutions round apart far enough to flip one frame's top
  box in the all-factors case at this n (IoU 0.056 apart on that frame,
  0.0072 in the row's mean); in float32 the rows measured equal.
* The tools' default path, the backbones in bfloat16 on both sides: every
  detector frame's IoU but at most one (a flipped top box) within
  ``FACE_TOL["det"]`` of the JAX tool's, and each row's mean over the
  frames that agree too; the landmark table's rows within ``FACE_TOL``.
* A mirror of ``tests/test_face_video_models.py::test_detector_heldout_all_factors_floor``
  on the port's detector: the all-factors cell at n 24, seed 11, has a mean
  IoU of at least 0.62."""

import contextlib
import functools
import io
import itertools
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("cv2")

import tools.diagnose_det_heldout as JD  # noqa: E402
import tools.diagnose_lmkpose_heldout as JL  # noqa: E402
from fvd_tpu.models import landmarks_fan as jlf  # noqa: E402
from fvd_tpu_torch import weights  # noqa: E402
from fvd_tpu_torch.models import face_ssd  # noqa: E402
from fvd_tpu_torch.tools import diagnose_det_heldout as PD  # noqa: E402
from fvd_tpu_torch.tools import diagnose_lmkpose_heldout as PL  # noqa: E402
from test_torch_eval_heldout import FACE_TOL  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTORS = ("stripes", "ecc_skin", "accessories", "rotation")
N = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def same_state(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a.get_state(), b.get_state()))


@pytest.mark.parametrize("size", [192, 256, 300])
def test_render_factored_matches_jax(size):
    for k, combo in enumerate(itertools.product([False, True], repeat=4)):
        factors = dict(zip(FACTORS, combo))
        for seed in (k, k + 16):
            aperture = 0.35 if seed % 2 else None
            rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
            ij, bj, pj = JD.render_factored(rj, size, aperture=aperture, **factors)
            ip, bp, pp = PD.render_factored(rp, size, aperture=aperture, **factors)
            assert ip.dtype == ij.dtype == np.uint8
            assert np.array_equal(ip, ij), (size, factors, seed, int((ip != ij).sum()))
            np.testing.assert_array_equal(bp, bj)
            np.testing.assert_array_equal(pp, pj)
            assert same_state(rp, rj)


def _printed_rows(text):
    """{case: [numbers]} of a table the tools print."""
    rows = {}
    for line in text.splitlines():
        name, nums = line[:28].strip(), line[28:].split()
        if name in dict(PD.CASES):
            rows[name] = [float(x) for x in nums if x not in ("mean", "IoU")]
    return rows


def _jax_stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.fixture
def float32_backbones(monkeypatch):
    """Both packages' SSD and hourglass backbones in float32."""
    from fvd_tpu.models import face_ssd as jssd
    from fvd_tpu_torch.models import landmarks_fan

    for mod, name in ((jssd, "detect_batch_jit"), (jlf, "landmarks_forward")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), compute_dtype=jax.numpy.float32))
    detect, forward = face_ssd.detect_batch, landmarks_fan.landmarks_forward
    monkeypatch.setattr(face_ssd, "detect_batch",
                        lambda model, frames, **k: detect(model, frames, **{**k, "compute_dtype": torch.float32}))
    monkeypatch.setattr(landmarks_fan, "landmarks_forward",
                        lambda model, crops, *a: forward(model, crops, torch.float32))


def test_det_table_matches_jax(capsys, float32_backbones):
    got = PD.main(["--n", str(N), "--cpu"])
    port_rows = _printed_rows(capsys.readouterr().out)
    jax_rows = _printed_rows(_jax_stdout(JD.main, ["--n", str(N)]))
    assert list(port_rows) == list(jax_rows) == [name for name, _ in PD.CASES]
    for name, (iou,) in jax_rows.items():
        assert port_rows[name] == [round(got[name], 3)]
        assert abs(got[name] - iou) <= FACE_TOL["det"], (name, got[name], iou)


@pytest.fixture
def template_shapes(monkeypatch):
    """The JAX tool's templates the checkpoints load into as shapes only
    (their eager inits take seconds)."""
    for name in ("init_landmark_params", "init_pose_params"):
        init = getattr(jlf, name)
        monkeypatch.setattr(jlf, name, lambda rng, width=32, _init=init: jax.eval_shape(
            functools.partial(_init, width=width), rng))


def test_det_bf16_matches_jax_but_one_flip(monkeypatch):
    import tools.eval_heldout as JE

    ious = {"port": [], "jax": []}

    def recording(side, iou):
        def _iou(a, b):
            ious[side].append(iou(a, b))
            return ious[side][-1]
        return _iou

    monkeypatch.setattr(PD, "_iou", recording("port", PD._iou))
    monkeypatch.setattr(JE, "_iou", recording("jax", JE._iou))
    with contextlib.redirect_stdout(io.StringIO()):
        got = PD.main(["--n", str(N), "--cpu"])
    _jax_stdout(JD.main, ["--n", str(N)])
    port, want = np.array(ious["port"]), np.array(ious["jax"])
    assert port.shape == want.shape == (len(PD.CASES) * N,)
    off = np.abs(port - want) > FACE_TOL["det"]
    assert off.sum() <= 1, np.abs(port - want).round(4)
    for k, (name, _) in enumerate(PD.CASES):
        rows = slice(k * N, (k + 1) * N)
        assert got[name] == pytest.approx(port[rows].mean(), abs=1e-12)
        keep = ~off[rows]
        assert abs(port[rows][keep].mean() - want[rows][keep].mean()) <= FACE_TOL["det"], name


def test_lmkpose_bf16_table_matches_jax(capsys, template_shapes):
    got = PL.main(["--n", str(N), "--cpu"])
    capsys.readouterr()
    jax_rows = _printed_rows(_jax_stdout(JL.main, ["--n", str(N)]))
    assert list(jax_rows) == list(got)
    for name, (lmk, pose) in jax_rows.items():
        assert abs(got[name][0] - lmk) <= FACE_TOL["lmk"], (name, got[name], lmk)
        assert abs(got[name][1] - pose) <= FACE_TOL["pose"], (name, got[name], pose)


def test_lmkpose_table_matches_jax(capsys, template_shapes, float32_backbones):
    got = PL.main(["--n", str(N), "--cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == f"{'factor':28s} {'lmk % of crop':>14s} {'pose mean deg':>14s}"
    jax_out = _jax_stdout(JL.main, ["--n", str(N)])
    assert jax_out.splitlines()[0] == out.splitlines()[0]
    jax_rows = _printed_rows(jax_out)
    assert list(jax_rows) == [name for name, _ in PD.CASES]
    for name, (lmk, pose) in jax_rows.items():
        assert abs(got[name][0] - lmk) <= FACE_TOL["lmk"], (name, got[name], lmk)
        assert abs(got[name][1] - pose) <= FACE_TOL["pose"], (name, got[name], pose)


def test_detector_heldout_all_factors_floor():
    model = face_ssd.from_params(weights.read_npz(os.path.join(ROOT, "checkpoints", "face_ssd.npz")), "cpu")
    frames, gts = PD.case_frames(24, dict.fromkeys(FACTORS, True), seed=11)
    iou = PD.mean_iou(model, frames, gts)
    assert iou >= 0.62, f"held-out all-factors IoU regressed: {iou}"
