"""``fvd_tpu_torch/tools/eval_pipeline_paired.py`` against the JAX package's
``tools/eval_pipeline_paired.py`` on the CPU.

* ``compose_ckpt_dir`` builds the same tree: the same links to the base's
  top-level ``.npz``/``.json``, and the same copied overrides and sidecars.
* The sync and fake clips: the port's pixels and audio equal the JAX
  tool's (its frames caught before the mp4 encoding), in the training and
  the held-out face distribution.
* ``analyze`` on the port's raw-RGBA sync clip (2 s at 5 fps) through both
  packages' 16 nodes with the recorded services, on the npz view of
  ``checkpoints/`` (``tests/test_torch_zoo_dag.py``'s links) in float32 on
  both sides: the LR features within ``ZOO_FEATURE_TOL`` and the
  probability within ``ZOO_PROB_TOL`` (``tests/test_torch_recorded_dag.py``'s
  bars), the transcript's word count and the claims equal.
* The contract on scripted analyses: the same JSON and exit code as the
  JAX tool, passing and failing."""

import functools
import json
import os

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
pytest.importorskip("cv2")

import fvd_tpu.synthetic as jsyn  # noqa: E402
import tools.eval_pipeline_paired as J  # noqa: E402
from fvd_tpu_torch.tools import eval_pipeline_paired as P  # noqa: E402
from fvd_tpu_torch.utils import avi  # noqa: E402
from fvd_tpu_torch.utils.wav import read_wav  # noqa: E402
from test_torch_recorded_dag import ZOO_FEATURE_TOL, ZOO_PROB_TOL  # noqa: E402
from test_torch_zoo_dag import LINKED  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(root):
    """{name: ("link", target) or ("file", bytes)} of a composed directory."""
    out = {}
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if os.path.islink(path):
            out[name] = ("link", os.readlink(path))
        else:
            with open(path, "rb") as f:
                out[name] = ("file", f.read())
    return out


def test_compose_ckpt_dir_matches_jax(tmp_path):
    base = tmp_path / "base"
    (base / "hf").mkdir(parents=True)
    for name in ("face_ssd.npz", "pose.npz", "pose.json", "notes.txt", "hf/config.json"):
        (base / name).write_bytes(name.encode())
    cand = tmp_path / "cand"
    cand.mkdir()
    for name in ("pose.npz", "pose.json", "clip.npz", "lr.json"):
        (cand / name).write_bytes(b"new " + name.encode())
    overrides = {"pose.npz": str(cand / "pose.npz"), "clip.npz": str(cand / "clip.npz"),
                 "extra.json": str(cand / "lr.json")}
    got, want = _tree(P.compose_ckpt_dir(str(base), overrides)), _tree(J.compose_ckpt_dir(str(base), overrides))
    assert got == want
    # the tool's own call composes into its working directory
    assert _tree(P.compose_ckpt_dir(str(base), overrides, str(tmp_path / "work" / "ckpt"))) == want
    assert got["pose.json"] == ("file", b"new pose.json") and got["face_ssd.npz"][0] == "link"
    assert "hf" not in got and "notes.txt" not in got


@pytest.mark.parametrize("heldout", [False, True], ids=["in_domain", "heldout"])
def test_clips_equal_jax(heldout, tmp_path, monkeypatch):
    captured = {}
    monkeypatch.setattr(jsyn, "write_video", lambda path, frames, fps: captured.update({path: frames.copy()}))
    from fvd_tpu.providers.factory import asr_speech_domain

    # the JAX tool's clips, in the speech domain of the shipped ASR
    renderer = asr_speech_domain(CKPT)
    assert renderer == "formant"
    common = dict(duration=1.0, fps=5.0, width=320, height=240, speech_renderer=renderer, heldout=heldout,
                  speech_text="the river level rose two feet")
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jsync = jsyn.make_face_video("media", name="sync", seed=21, **common)
    jfake = jsyn.make_face_video("media", name="fake", seed=22, mouth_gate_hz=1.37, texture_noise=14.0, **common)
    monkeypatch.chdir(tmp_path / "port")
    clips = P.render_clips(CKPT, 1.0, 5.0, heldout)
    for jpath, path in zip((jsync, jfake), clips):
        n = avi.probe(path)[1]
        frames, _ = avi.read_frames(path, range(n))
        want = captured[jpath]
        assert frames.shape == want.shape and np.array_equal(frames, want), os.path.basename(path)
        (a, sr_a), (b, sr_b) = (read_wav(os.path.splitext(p)[0] + ".wav") for p in (jpath, path))
        assert sr_a == sr_b and np.array_equal(a, b), os.path.basename(path)


def _final_states(monkeypatch, scheduler_cls, finals):
    invoke = scheduler_cls.invoke

    def recording(self, state):
        finals.append(invoke(self, state))
        return finals[-1]

    monkeypatch.setattr(scheduler_cls, "invoke", recording)


def test_analyze_matches_jax(tmp_path, monkeypatch):
    from fvd_tpu.models import face_ssd as jssd
    from fvd_tpu.models import landmarks_fan as jlmk
    from fvd_tpu.runtime.scheduler import Scheduler as JScheduler
    from fvd_tpu_torch.ops import fusion as tfusion
    from fvd_tpu_torch.runtime.scheduler import Scheduler as TScheduler

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    for n in LINKED:
        os.symlink(os.path.join(CKPT, n), ckpt / n)
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    sync, _ = P.render_clips(str(ckpt), 2.0, 5.0, False)
    sync = os.path.abspath(sync)
    finals = {"port": [], "jax": []}
    _final_states(monkeypatch, TScheduler, finals["port"])
    _final_states(monkeypatch, JScheduler, finals["jax"])
    got = P.analyze(sync, str(ckpt), device="cpu", compute_dtype=torch.float32)
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(jssd, "detect_batch_jit", functools.partial(jssd.detect_batch_jit, compute_dtype=jnp.float32))
    monkeypatch.setattr(jlmk, "landmarks_pose_from_frames",
                        functools.partial(jlmk.landmarks_pose_from_frames, compute_dtype=jnp.float32))
    want = J.analyze(sync, str(ckpt))
    (t,), (j,) = finals["port"], finals["jax"]
    for k in tfusion.FEATURE_ORDER:
        assert abs(t.features[k] - j.features[k]) <= ZOO_FEATURE_TOL, (k, t.features[k], j.features[k])
    assert abs(t.fake_probability - j.fake_probability) <= ZOO_PROB_TOL
    assert got["words"] == want["words"] > 0 and got["claims"] == want["claims"]
    assert abs(got["p"] - want["p"]) <= 1e-4 and abs(got["lip"] - want["lip"]) <= 1e-4


#: (old sync, old fake, new sync, new fake) analyses as (p, lip)
CONTRACT_CASES = {
    "ok": ((0.30, 0.62), (0.46, 0.02), (0.31, 0.55), (0.47, 0.10)),
    "separation_halved": ((0.30, 0.62), (0.46, 0.02), (0.31, 0.40), (0.47, 0.15)),
    "no_prob_gap": ((0.30, 0.62), (0.46, 0.02), (0.47, 0.62), (0.47, 0.02)),
}


@pytest.mark.parametrize("case", sorted(CONTRACT_CASES))
def test_contract_matches_jax(case, tmp_path, monkeypatch):
    import fvd_tpu_torch.synthetic as tsyn

    rows = dict(zip(("old sync", "old fake", "new sync", "new fake"), CONTRACT_CASES[case]))
    for mod in (jsyn, tsyn):
        monkeypatch.setattr(mod, "make_face_video", lambda dirpath, name, **k: f"{dirpath}/{name}")
    out, rc = {}, {}
    for side, mod in (("port", P), ("jax", J)):
        base = mod.REPO

        def analyze(video, ckpt, *a, _base=base, **k):
            p, lip = rows[f"{'old' if ckpt == os.path.join(_base, 'checkpoints') else 'new'} "
                          f"{os.path.basename(video)}"]
            return {"p": p, "lip": lip, "words": 4, "claims": 1}

        monkeypatch.setattr(mod, "analyze", analyze)
        out[side] = str(tmp_path / f"{side}.json")
        argv = ["--duration", "1", "--json", out[side]]
        rc[side] = mod.main(argv + (["--cpu"] if side == "port" else []))
    with open(out["port"]) as f, open(out["jax"]) as g:
        got, want = json.load(f), json.load(g)
    assert got == want and rc["port"] == rc["jax"] == (0 if case == "ok" else 1)
    assert got["contract_ok"] == (case == "ok")
