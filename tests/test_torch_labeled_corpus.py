"""``fvd_tpu_torch/tools/make_labeled_corpus.py`` against
``tools/make_labeled_corpus.py`` on the CPU: the same recipe tables and
sentences, and a corpus of every family with the same names, labels,
pixels (before the JAX tool's mp4 encoding) and audio, at the train seeds
and at ``tools/calibrate_lr.py``'s shifted validation seeds."""

import argparse
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

import fvd_tpu.synthetic as jsyn
import tools.make_labeled_corpus as jmlc
from fvd_tpu.batch import get_label as jget_label
from fvd_tpu_torch.batch import get_label, get_videos
from fvd_tpu_torch.tools import calibrate_lr as tcal
from fvd_tpu_torch.tools import make_labeled_corpus as tmlc
from fvd_tpu_torch.utils import avi
from fvd_tpu_torch.utils.wav import read_wav


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_tables_equal_the_jax_tool():
    assert tmlc.SENTENCES == jmlc.SENTENCES
    assert tmlc.FAKE_RECIPES == jmlc.FAKE_RECIPES
    assert tmlc.AMBIGUOUS_RECIPES == jmlc.AMBIGUOUS_RECIPES
    assert tmlc.HARD_REAL_RECIPES == jmlc.HARD_REAL_RECIPES


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: one clip of every family, 1 s at 5 fps and 160x120
CORPUS = dict(n_real=1, n_fake=1, n_ambiguous=1, n_hard_real=1)
SIZE = dict(duration=1.0, fps=5.0)


def _jax_corpus(seed_shift, out, monkeypatch):
    """JAX's corpus -> {name: (frames before the mp4 encoding, wav path)}:
    ``build_corpus`` at the train seeds, ``calibrate_lr.build`` (whose
    monkeypatch shifts the seeds) otherwise."""
    captured = {}
    monkeypatch.setattr(jsyn, "write_video",
                        lambda path, frames, fps: captured.update({path: frames.copy()}))
    if seed_shift == 0:
        paths = jmlc.build_corpus(out, CORPUS["n_real"], CORPUS["n_fake"], SIZE["duration"], fps=SIZE["fps"],
                                  width=160, height=120, n_ambiguous=CORPUS["n_ambiguous"],
                                  n_hard_real=CORPUS["n_hard_real"])
    else:
        # calibrate_lr.build imports make_labeled_corpus from tools/, which the JAX
        # tool puts on sys.path only when it is first imported
        monkeypatch.setattr(sys, "path", list(sys.path))
        monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
        import tools.calibrate_lr as jcal

        monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix="": out)
        # calibrate_lr.build always draws 320x240 clips
        args = argparse.Namespace(n_real=CORPUS["n_real"], n_fake=CORPUS["n_fake"], duration=SIZE["duration"],
                                  fps=SIZE["fps"], ambiguous=CORPUS["n_ambiguous"],
                                  hard_reals=CORPUS["n_hard_real"])
        paths, labels = jcal.build(args, seed_shift, "val")
        assert labels == [jget_label(p) for p in paths]
    return {os.path.basename(p): (captured[p], os.path.splitext(p)[0] + ".wav") for p in paths}


@pytest.mark.parametrize("seed_shift", [0, 50])
def test_corpus_equals_jax(tmp_path, monkeypatch, seed_shift):
    want = _jax_corpus(seed_shift, str(tmp_path / "jax"), monkeypatch)
    out = str(tmp_path / "port")
    if seed_shift == 0:
        paths = tmlc.build_corpus(out, CORPUS["n_real"], CORPUS["n_fake"], SIZE["duration"], fps=SIZE["fps"],
                                  width=160, height=120, n_ambiguous=CORPUS["n_ambiguous"],
                                  n_hard_real=CORPUS["n_hard_real"])
    else:
        args = argparse.Namespace(n_real=CORPUS["n_real"], n_fake=CORPUS["n_fake"], duration=SIZE["duration"],
                                  fps=SIZE["fps"], ambiguous=CORPUS["n_ambiguous"],
                                  hard_reals=CORPUS["n_hard_real"])
        paths, labels = tcal.build(args, seed_shift, out)
        assert labels == [get_label(p) for p in paths]
    names = [os.path.basename(p) for p in paths]
    assert names == list(want) == ["clip00_real_news.mp4", "clip01_deepfake.mp4", "clip02_subtle_deepfake.mp4",
                                   "clip03_real_vlog.mp4"]
    assert [get_label(p) for p in paths] == [jget_label(n) for n in names] == [0, 1, 1, 0]
    assert sorted(get_videos(out)) == sorted(paths)
    for path in paths:
        frames, jwav = want[os.path.basename(path)]
        n = avi.probe(path)[1]
        got, _ = avi.read_frames(path, range(n))
        assert np.array_equal(got, frames), f"{os.path.basename(path)}: {int((got != frames).sum())} bytes differ"
        (a, sr_a), (b, sr_b) = read_wav(jwav), read_wav(os.path.splitext(path)[0] + ".wav")
        assert sr_a == sr_b and np.array_equal(a, b), os.path.basename(path)


def test_hard_real_recipes_have_no_claimable_sentence():
    """``tests/test_face_video_models.py``'s check on the port's table: the
    hard reals pair degradation with exclamations of under four words (C3
    extracts no claim), carry no manipulation, and their names parse as
    real."""
    for recipe, text in tmlc.HARD_REAL_RECIPES:
        assert len(text.split()) < 4
        assert recipe.get("sensor_noise", 0) > 0
        assert "mouth_gate_hz" not in recipe
        assert "texture_noise" not in recipe
    assert get_label("clip16_real_vlog.mp4") == 0
