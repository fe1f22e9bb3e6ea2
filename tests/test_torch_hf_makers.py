"""``fvd_tpu_torch/tools/make_hf_geometry_checkpoints.py`` against the JAX
package's makers at the trainers' small geometries (Whisper ``--tiny``'s
d64, 2 + 2 layers, vocab 600; CLIP ``--tiny``) and MiniLM's one: the same
tree of leaves and shapes, every constant leaf equal (biases, LayerNorm
scales, ``logit_scale``), every random leaf's mean and standard deviation
within sampling error of the JAX draw's, the encoder's sinusoids those of
``sinusoidal_embedding_init`` rounded correctly, the same ``config.json``,
and tokenizer files that tokenize as the JAX maker's do."""

import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("transformers")

from fvd_tpu_torch.tools import make_hf_geometry_checkpoints as makers  # noqa: E402
from fvd_tpu_torch.utils.hf_tokenizers import Tokenizer  # noqa: E402
from fvd_tpu_torch.utils.msgpack import leaves, read_msgpack  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
os.environ.setdefault("USE_TF", "0")
#: a leaf's mean and standard deviation against the JAX draw's: six
#: standard errors of the difference of two independent estimates
SIGMAS = 6.0
WHISPER_TINY = dict(d_model=64, layers=2, heads=2, ffn=128, vocab_size=600)


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    import make_hf_geometry_checkpoints as jmakers

    root = tmp_path_factory.mktemp("makers")
    out = {}
    for kind, port, jax_maker in (
            ("whisper", lambda d: makers.make_whisper(d, **WHISPER_TINY),
             lambda d: jmakers.make_whisper(d, **WHISPER_TINY)),
            ("clip", lambda d: makers.make_clip(d, tiny=True), lambda d: jmakers.make_clip(d, tiny=True)),
            ("minilm", makers.make_minilm, jmakers.make_minilm)):
        port(str(root / f"port_{kind}"))
        jax_maker(str(root / f"jax_{kind}"))
        out[kind] = (str(root / f"port_{kind}"), str(root / f"jax_{kind}"))
    return out


@pytest.mark.parametrize("kind", ["whisper", "clip", "minilm"])
def test_init_statistics_match_the_jax_maker(made, kind):
    port_dir, jax_dir = made[kind]
    port = dict(leaves(read_msgpack(os.path.join(port_dir, "flax_model.msgpack"))))
    ref = dict(leaves(read_msgpack(os.path.join(jax_dir, "flax_model.msgpack"))))
    assert set(port) == set(ref)
    assert list(port) == sorted(port, key=lambda p: tuple(p))
    for path, r in ref.items():
        p = port[path]
        assert p.shape == r.shape and p.dtype == r.dtype == np.float32, path
        if path[-2:] == ("embed_positions", "embedding") and path[1] == "encoder":
            continue
        if r.size == 1 or float(r.std()) == 0.0:
            np.testing.assert_array_equal(p, r, err_msg="/".join(path))
            continue
        n, sd = r.size, float(r.std())
        assert abs(float(p.mean()) - float(r.mean())) <= SIGMAS * sd * np.sqrt(2.0 / n), path
        assert abs(float(p.std()) - sd) <= SIGMAS * sd * np.sqrt(1.0 / n), (path, float(p.std()), sd)


def test_whisper_positions_are_the_sinusoids(made):
    """The encoder's positions are ``sinusoidal_embedding_init``'s table:
    the JAX maker's is XLA's float32 evaluation of it, the port's the same
    arguments with ``exp``, ``sin`` and ``cos`` rounded correctly.  They
    differ where XLA's ``exp`` is an ulp off a frequency, which the 1 500
    positions magnify (a recorded divergence, ROADMAP.md section 3)."""
    port_dir, jax_dir = made["whisper"]
    port = read_msgpack(os.path.join(port_dir, "flax_model.msgpack"))["model"]["encoder"]["embed_positions"]
    ref = read_msgpack(os.path.join(jax_dir, "flax_model.msgpack"))["model"]["encoder"]["embed_positions"]
    port, ref = port["embedding"], ref["embedding"]
    np.testing.assert_array_equal(port, makers.sinusoids(1500, 64))
    assert np.abs(port - ref).max() <= 2e-4
    t = np.arange(1500, dtype=np.float64)[:, None] * np.exp(-np.log(10000) / 31 * np.arange(32))[None]
    exact = np.concatenate([np.sin(t), np.cos(t)], axis=1)
    assert np.abs(port - exact).max() <= 2e-4 and np.abs(port[:, :32] - exact[:, :32]).mean() < 1e-5


@pytest.mark.parametrize("kind", ["whisper", "clip", "minilm"])
def test_configs_and_tokenizers_match_the_jax_maker(made, kind):
    port_dir, jax_dir = made[kind]
    cfgs = []
    for d in (port_dir, jax_dir):
        with open(os.path.join(d, "config.json")) as f:
            cfg = json.load(f)
        cfg.pop("transformers_version", None)
        cfgs.append(cfg)
    assert cfgs[0] == cfgs[1]
    text = "the river level rose two feet" if kind == "minilm" else "hello world 42"
    port_tok, ref_tok = Tokenizer.from_dir(port_dir), Tokenizer.from_dir(jax_dir)
    assert port_tok.vocab == ref_tok.vocab
    assert port_tok.encode_ids(text) == ref_tok.encode_ids(text)
    assert set(os.listdir(port_dir)) == set(os.listdir(jax_dir))
