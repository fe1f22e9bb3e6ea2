"""``fvd_tpu_torch/models/encoders.py`` against ``fvd_tpu/models/encoders.py``
on the CPU, both in float32: the text and image towers at depth 2 from one
flax init, then ``JaxTextEncoder`` on ``text_encoder.npz`` and ``JaxClip`` on
``clip.npz`` with the dims and calibration of their sidecars.  Inputs are
made from numpy seeds."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvd_tpu.models import encoders as jenc
from fvd_tpu_torch import weights
from fvd_tpu_torch.models import encoders as tenc

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
#: float32 on both sides; only the summation order differs
TOL = 1e-5
SENTENCES = [
    "the moon landing happened in 1969", "water boils at 100 degrees", "", "a",
    "Fact check: riverton mayor announces 10% property tax reduction",
    "Reality Check: harbor steel plans to cut 5 jobs in summit", "é" * 40, "x" * 300,
]


def _sentences(n=64):
    """``n`` sentences: the fixed ones, then words drawn from them by seed."""
    rng = np.random.RandomState(0)
    words = " ".join(SENTENCES[:6]).split()
    out = list(SENTENCES)
    while len(out) < n:
        out.append(" ".join(rng.choice(words, rng.randint(1, 20))))
    return out[:n]


def _tower_pair(jmodel, tmodel, x):
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    tmodel.load_state_dict(weights.to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    return got, want


def test_text_tower_depth2_matches_flax():
    rng = np.random.RandomState(1)
    ids = rng.randint(3, 259, (3, 32)).astype(np.int32)
    ids[0, 10:] = 0    # PAD rows: every key masked
    ids[1, :] = 0      # an empty text: the mean pool divides by 1
    got, want = _tower_pair(jenc.TextTower(dim=64, depth=2, out_dim=32),
                            tenc.TextTower(dim=64, depth=2, out_dim=32), ids)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_image_tower_depth2_matches_flax():
    """16x16 stride-16 patches in NHWC raster order, a cls token and sincos
    positions over 50 tokens."""
    x = np.random.RandomState(2).rand(2, tenc.IMAGE_SIZE, tenc.IMAGE_SIZE, 3).astype(np.float32)
    got, want = _tower_pair(jenc.ImageTower(dim=64, depth=2, out_dim=32),
                            tenc.ImageTower(dim=64, depth=2, out_dim=32), x)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def text_encoders():
    with open(os.path.join(CKPT, "text_encoder.json")) as f:
        meta = json.load(f)
    dims = {k: meta[k] for k in ("dim", "depth", "out_dim")}
    path = os.path.join(CKPT, "text_encoder.npz")
    return (jenc.JaxTextEncoder(checkpoint=path, **dims),
            tenc.JaxTextEncoder(checkpoint=path, device="cpu", **dims))


def _unit(e):
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def test_shipped_text_encoder_matches_jax(text_encoders):
    """64 sentences: unit embeddings within TOL and the same ranking of the
    others against each sentence."""
    jt, tt = text_encoders
    texts = _sentences()
    got, want = _unit(tt.encode_batch(texts)), _unit(jt.encode_batch(texts))
    assert got.shape == (64, 256)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(np.argsort(-(got @ got.T), axis=1)[:, :5],
                                  np.argsort(-(want @ want.T), axis=1)[:, :5])
    np.testing.assert_allclose(tt.encode(texts[0]), jt.encode(texts[0]), atol=TOL, rtol=0)


def test_text_encoder_rows_do_not_depend_on_the_batch(text_encoders):
    """The JAX package pads the batch to a power of two; the port does not,
    and a row's embedding is the same alone and in a batch."""
    _, tt = text_encoders
    texts = _sentences(5)
    batch = tt.encode_batch(texts)
    for i, t in enumerate(texts):
        np.testing.assert_allclose(tt.encode(t), batch[i], atol=TOL, rtol=0)


def test_shipped_clip_matches_jax():
    """Keyframe-like 240x320 frames (resized on the host with OpenCV's rule
    on both sides) against segment texts: calibrated similarities within
    TOL."""
    with open(os.path.join(CKPT, "clip.json")) as f:
        meta = json.load(f)
    path = os.path.join(CKPT, "clip.npz")
    jc = jenc.JaxClip(checkpoint=path, **meta)
    tc = tenc.JaxClip(checkpoint=path, device="cpu", **meta)
    rng = np.random.RandomState(3)
    images = [rng.randint(0, 256, (240, 320, 3)).astype(np.uint8) for _ in range(4)] + \
             [np.full((112, 112, 3), 200, np.uint8), rng.randint(0, 256, (97, 131, 3)).astype(np.uint8)]
    texts = _sentences(len(images))
    got = tc.image_text_similarity_batch(images, texts)
    want = jc.image_text_similarity_batch(images, texts)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert abs(tc.image_text_similarity(images[0], texts[0]) - float(want[0])) <= TOL
