"""The port's paired adoption gates for the ASR, the text encoder and CLIP
(``fvd_tpu_torch/tools/eval_{asr,text,clip}_paired.py``) against the JAX
package's ``tools/eval_{asr,text,clip}_paired.py`` on the CPU.

* The helpers on fixed inputs: ``score``, ``ranking_metrics``,
  ``cross_scores`` and ``provider_metrics`` equal to the JAX tools'.
* The gates: each tool's ``main`` with its metric function scripted (and
  its models stubbed), so the JAX tool's inline gate and the port's decide
  the same cases; the JSON files equal.
* ``eval_asr_paired.main(--n 4)`` on ``asr_formant.npz`` against a copy of
  itself: the same decoded strings and the same JSON.
* ``eval_text_paired`` on the shipped MiniLM and text tower at ``--n 8
  --rounds 1``: the same JSON.
* ``eval_clip_paired`` on one tiny CLIP written by the port's maker and
  read by both tools, against ``clip.npz`` at ``--n 4``: the cosine
  matrices within ``EMBED_TOL`` (``tests/test_torch_hf_models.py``'s), the
  band and retrieval metrics and the gate equal.

The JAX providers load the HF directories through
``test_torch_hf_models.jax_from_local_without_init`` (no random init)."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("transformers")

import tools.eval_asr_paired as JA  # noqa: E402
import tools.eval_clip_paired as JC  # noqa: E402
import tools.eval_text_paired as JT  # noqa: E402
from fvd_tpu_torch.tools import eval_asr_paired as PA  # noqa: E402
from fvd_tpu_torch.tools import eval_clip_paired as PC  # noqa: E402
from fvd_tpu_torch.tools import eval_text_paired as PT  # noqa: E402
from test_torch_hf_models import EMBED_TOL, jax_from_local_without_init  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints")
ASR = os.path.join(CKPT, "asr_formant.npz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def jax_tools_path(monkeypatch):
    """The JAX tools import their sibling tools by bare name, as they do run
    as scripts from ``tools/``."""
    monkeypatch.setattr(sys, "path", [os.path.join(ROOT, "tools")] + sys.path)


def _json(path):
    with open(path) as f:
        return json.load(f)


# --- the helpers on fixed inputs ------------------------------------------
@pytest.mark.parametrize("decoded,texts", [
    (["abc", "hello", ""], ["abc", "help", "x"]),
    (["the cat"], ["the cat sat"]),
    ([], []),
])
def test_score_matches_jax(decoded, texts):
    assert PA.score(decoded, texts) == JA.score(decoded, texts)


class _FixedEncoder:
    """``encode_batch`` from a seeded table keyed by each text's position."""

    def __init__(self, seed, dim=16):
        self.rng = np.random.RandomState(seed)
        self.dim = dim

    def encode_batch(self, texts):
        return self.rng.randn(len(texts), self.dim).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranking_metrics_match_jax(seed):
    claims, docs = [f"c{i}" for i in range(12)], [f"d{i}" for i in range(12)]
    got = PT.ranking_metrics(_FixedEncoder(seed), claims, docs)
    want = JT.ranking_metrics(_FixedEncoder(seed), claims, docs)
    assert got == want


class _FixedClip:
    """A similarity from each image's pixels and each text's characters."""

    def image_text_similarity_batch(self, images, texts):
        return np.array([(float(im.mean()) / 255.0 - 0.5) + 0.03 * (sum(map(ord, t)) % 17) - 0.2
                         for im, t in zip(images, texts)], np.float32)


def test_cross_scores_and_provider_metrics_match_jax():
    rng = np.random.RandomState(3)
    images = [rng.randint(0, 256, (8, 8, 3)).astype(np.uint8) for _ in range(6)]
    caps = [f"caption {i}" for i in range(6)]
    kf_images, kf_texts = images[:3], ["a b", "c d", "e f"]
    np.testing.assert_array_equal(PC.cross_scores(_FixedClip(), images, caps, chunk=7),
                                  JC.cross_scores(_FixedClip(), images, caps, chunk=7))
    assert PC.provider_metrics(_FixedClip(), images, caps, kf_images, kf_texts) == \
        JC.provider_metrics(_FixedClip(), images, caps, kf_images, kf_texts)


# --- the gates, on scripted metrics ---------------------------------------
#: (exact, char) of base old, base new, hard old, hard new
ASR_CASES = {
    "adopt": [(0.5, 0.9), (0.48, 0.9), (0.2, 0.8), (0.4, 0.85)],
    "base_regression": [(0.5, 0.9), (0.46, 0.9), (0.2, 0.8), (0.4, 0.85)],
    "hard_tie": [(0.5, 0.9), (0.6, 0.9), (0.2, 0.8), (0.2, 0.85)],
}


@pytest.mark.parametrize("case", sorted(ASR_CASES))
def test_asr_verdict_matches_jax(case, tmp_path, monkeypatch):
    meta = {"dim": 192, "depth": 4, "chunk_frames": 128, "max_tokens": 16, "dither": 0.002}
    out = {}
    for side, mod in (("port", PA), ("jax", JA)):
        scripted = iter(ASR_CASES[case])
        monkeypatch.setattr(mod, "load_ckpt", lambda path, *a, **k: (None, meta))
        monkeypatch.setattr(mod, "decode_all", lambda *a, **k: [])
        monkeypatch.setattr(mod, "score", lambda decoded, texts: next(scripted))
        out[side] = str(tmp_path / f"{side}.json")
        argv = ["--new", "x.npz", "--n", "1", "--json", out[side]]
        assert mod.main(argv + (["--cpu"] if side == "port" else [])) == 0
    assert _json(out["port"]) == _json(out["jax"])
    assert _json(out["port"])["adopt"] == (case == "adopt")


#: (new, old) metrics of one round
TEXT_CASES = {
    "win": ({"retrieval_at_1": 0.9, "mrr": 0.95, "top5": 1.0}, {"retrieval_at_1": 0.9, "mrr": 0.9, "top5": 1.0}),
    "loss": ({"retrieval_at_1": 0.9, "mrr": 0.95, "top5": 0.9}, {"retrieval_at_1": 0.8, "mrr": 0.9, "top5": 1.0}),
}


@pytest.mark.parametrize("case", sorted(TEXT_CASES))
def test_text_gate_matches_jax(case, tmp_path, monkeypatch):
    import fvd_tpu.models.encoders as jenc
    import fvd_tpu.providers.hf_models as jhf
    from fvd_tpu_torch.models import encoders as tenc
    from fvd_tpu_torch.providers import hf_models as thf

    new, old = TEXT_CASES[case]
    for cls in (jhf.HFTextEncoder, thf.HFTextEncoder):
        monkeypatch.setattr(cls, "from_local", classmethod(lambda cls, *a, **k: "new"))
    for mod in (jenc, tenc):
        monkeypatch.setattr(mod, "JaxTextEncoder", lambda **k: "old")
    out = {}
    for side, mod in (("port", PT), ("jax", JT)):
        monkeypatch.setattr(mod, "ranking_metrics", lambda enc, claims, docs: dict(new if enc == "new" else old))
        out[side] = str(tmp_path / f"{side}.json")
        argv = ["--old", os.path.join(CKPT, "text_encoder.npz"), "--n", "4", "--rounds", "2", "--json", out[side]]
        assert mod.main(argv + (["--cpu"] if side == "port" else [])) == 0
    assert _json(out["port"]) == _json(out["jax"])
    assert _json(out["port"])["meets_verdict_gate"] == (case == "win")


def _clip_metrics(r1, margin, plus, minus):
    return {"retrieval_at_1": r1, "margin": margin, "diag_mean": 0.3, "off_mean": 0.3 - margin,
            "band_matched_gt_025": plus, "band_mismatched_lt_015": minus,
            "keyframe_vs_transcript_mean": 0.1, "keyframe_vs_transcript_max": 0.2}


#: (new, old): "band_bought" wins retrieval and margin and loses the balanced band
CLIP_CASES = {
    "win": (_clip_metrics(0.9, 0.3, 0.8, 0.9), _clip_metrics(0.8, 0.2, 1.0, 0.7)),
    "band_bought": (_clip_metrics(0.9, 0.3, 1.0, 0.5), _clip_metrics(0.8, 0.2, 0.8, 0.82)),
    "retrieval_loss": (_clip_metrics(0.7, 0.3, 1.0, 1.0), _clip_metrics(0.8, 0.2, 0.8, 0.8)),
}


@pytest.mark.parametrize("case", sorted(CLIP_CASES))
def test_clip_gate_matches_jax(case, tmp_path, monkeypatch):
    import fvd_tpu.models.encoders as jenc
    import fvd_tpu.providers.hf_models as jhf
    from fvd_tpu_torch.models import encoders as tenc
    from fvd_tpu_torch.providers import hf_models as thf

    new, old = CLIP_CASES[case]
    for cls in (jhf.HFClip, thf.HFClip):
        monkeypatch.setattr(cls, "from_local", classmethod(lambda cls, *a, **k: "new"))
    for mod in (jenc, tenc):
        monkeypatch.setattr(mod.JaxClip, "__init__", lambda self, **k: None)
    out = {}
    for side, mod in (("port", PC), ("jax", JC)):
        monkeypatch.setattr(mod, "provider_metrics", lambda p, *a: dict(new if p == "new" else old))
        out[side] = str(tmp_path / f"{side}.json")
        argv = ["--old", os.path.join(CKPT, "clip.npz"), "--n", "2", "--json", out[side]]
        assert mod.main(argv + (["--cpu"] if side == "port" else [])) == 0
    assert _json(out["port"]) == _json(out["jax"])
    assert _json(out["port"])["meets_verdict_gate"] == (case == "win")


# --- the tools on real models ---------------------------------------------
def test_eval_asr_paired_matches_jax(tmp_path, monkeypatch):
    """Both tools decode the same 4 + 4 utterances alike on the shipped
    formant checkpoint and a copy of it (REJECT: no win on ``hard``)."""
    new = str(tmp_path / "asr_new.npz")
    shutil.copy(ASR, new)
    shutil.copy(ASR.replace(".npz", ".json"), new.replace(".npz", ".json"))
    decoded, out = {}, {}
    for side, mod in (("port", PA), ("jax", JA)):
        decode = mod.decode_all
        decoded[side] = []
        monkeypatch.setattr(mod, "decode_all", lambda *a, _d=decode, _s=side: decoded[_s].append(_d(*a)) or
                            decoded[_s][-1])
        out[side] = str(tmp_path / f"{side}.json")
        argv = ["--old", ASR, "--new", new, "--n", "4", "--json", out[side]]
        assert mod.main(argv + (["--cpu"] if side == "port" else [])) == 0
    assert decoded["port"] == decoded["jax"] and len(decoded["port"]) == 4
    assert _json(out["port"]) == _json(out["jax"])
    assert _json(out["port"])["adopt"] is False


def test_eval_text_paired_matches_jax(tmp_path, monkeypatch):
    jax_from_local_without_init(monkeypatch)
    out = {}
    for side, mod in (("port", PT), ("jax", JT)):
        out[side] = str(tmp_path / f"{side}.json")
        argv = ["--new", os.path.join(CKPT, "hf", "minilm"), "--old", os.path.join(CKPT, "text_encoder.npz"),
                "--n", "8", "--rounds", "1", "--json", out[side]]
        assert mod.main(argv + (["--cpu"] if side == "port" else [])) == 0
    assert _json(out["port"]) == _json(out["jax"])


@pytest.fixture(scope="module")
def tiny_clip(tmp_path_factory):
    """A ``--tiny`` CLIP from the port's maker (random weights)."""
    from fvd_tpu_torch.tools.make_hf_geometry_checkpoints import make_clip

    path = str(tmp_path_factory.mktemp("hf") / "clip")
    make_clip(path, tiny=True)
    return path


def test_eval_clip_paired_matches_jax(tiny_clip, tmp_path, monkeypatch):
    jax_from_local_without_init(monkeypatch)
    cos, out = {}, {}
    for side, mod in (("port", PC), ("jax", JC)):
        cross = mod.cross_scores
        cos[side] = []
        monkeypatch.setattr(mod, "cross_scores", lambda *a, _c=cross, _s=side, **k: cos[_s].append(_c(*a, **k)) or
                            cos[_s][-1])
        out[side] = str(tmp_path / f"{side}.json")
        argv = ["--new", tiny_clip, "--old", os.path.join(CKPT, "clip.npz"), "--n", "4", "--json", out[side]]
        assert mod.main(argv + (["--cpu"] if side == "port" else [])) == 0
    assert len(cos["port"]) == len(cos["jax"]) == 2   # new, then old
    for got, want in zip(cos["port"], cos["jax"]):
        assert got.shape == want.shape == (7, 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_TOL)
    got, want = _json(out["port"]), _json(out["jax"])
    assert got["meets_verdict_gate"] == want["meets_verdict_gate"]
    for name in ("new", "old"):
        for key, value in want[name].items():
            if key.startswith(("band_", "retrieval_")):
                assert got[name][key] == value, (name, key)
            else:
                assert abs(got[name][key] - value) <= EMBED_TOL, (name, key, got[name][key], value)
