"""``fvd_tpu_torch/models/transformer.py`` against ``fvd_tpu/models/transformer.py``
on the CPU, both in float32: the same numpy-seeded inputs through the flax
``MHABlock`` and the port's, with the flax params loaded through
``fvd_tpu_torch.weights``; and the converter's leaves for attention and 1-D
convs on the shipped ``clip.npz`` and ``asr.npz``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvd_tpu.models import transformer as jtr
from fvd_tpu_torch import weights
from fvd_tpu_torch.models import transformer as ttr

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
DIM, HEADS = 64, 2
#: float32 on both sides; only the summation order differs
TOL = 1e-5


def _pair(causal, cross, x, context=None, mask=None):
    jblock = jtr.MHABlock(DIM, HEADS, causal=causal)
    args = (jnp.asarray(x),) + ((jnp.asarray(context),) if cross else ())
    kwargs = {} if mask is None else {"mask": jnp.asarray(mask)}
    params = jax.jit(lambda *a: jblock.init(jax.random.PRNGKey(3), *a, **kwargs))(*args)
    want = np.asarray(jblock.apply(params, *args, **kwargs))
    tblock = ttr.MHABlock(DIM, HEADS, causal=causal, cross=cross)
    tblock.load_state_dict(weights.to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tblock(torch.from_numpy(x), torch.from_numpy(context) if cross else None,
                     None if mask is None else torch.from_numpy(mask)).numpy()
    return got, want


@pytest.mark.parametrize("causal,cross", [(False, False), (True, False), (True, True)])
def test_mha_block_matches_flax(causal, cross):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 12, DIM).astype(np.float32)
    context = rng.randn(2, 9, DIM).astype(np.float32) if cross else None
    got, want = _pair(causal, cross, x, context)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_fully_masked_rows_get_a_uniform_softmax_as_in_flax():
    """The text tower's PAD rows: every key masked.  flax sets masked scores
    to finfo.min, so such a row averages all values; a -inf mask would give
    NaN."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 10, DIM).astype(np.float32)
    valid = np.array([[True] * 6 + [False] * 4, [True] * 10])
    mask = valid[:, None, None, :] & valid[:, None, :, None]
    got, want = _pair(False, False, x, mask=mask)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_tokenizer_and_positions_match():
    jt, tt = jtr.ByteTokenizer(), ttr.ByteTokenizer()
    for text, n, special in [("hello", 8, False), ("é moon 1969", 32, True), ("x" * 300, 128, False)]:
        ids = tt.encode(text, n, add_special=special)
        np.testing.assert_array_equal(ids, jt.encode(text, n, add_special=special))
        assert tt.decode(ids) == jt.decode(ids)
    np.testing.assert_array_equal(ttr.sincos_positions(50, 128), jtr.sincos_positions(50, 128))


def test_converter_reads_attention_and_conv1d_kernels_by_module():
    """Attention kernels and 1-D conv kernels are both 3-D; the module name
    decides how each is laid out."""
    sd = weights.to_state_dict(weights.read_npz(os.path.join(CKPT, "clip.npz")))
    att = "image.MHABlock_0.MultiHeadDotProductAttention_0"
    assert sd[f"{att}.out.weight"].shape == (128, 128)       # flax [4, 32, 128]
    assert sd[f"{att}.query.weight"].shape == (128, 128)     # flax [128, 4, 32]
    assert sd[f"{att}.query.bias"].shape == (128,)           # flax [4, 32]
    assert sd["image.cls"].shape == (1, 1, 128) and sd["logit_scale"].shape == ()
    assert sd["text.Embed_0.weight"].shape == (259, 128)
    raw = weights.read_npz(os.path.join(CKPT, "asr.npz"))
    sd = weights.to_state_dict(raw)
    k = raw["['params']['encoder']['Conv_0']['kernel']"]                 # [K, I, O]
    np.testing.assert_array_equal(sd["encoder.Conv_0.weight"].numpy(), k.transpose(2, 1, 0))
    out = raw["['params']['decoder']['MHABlock_0']['MultiHeadDotProductAttention_1']['out']['kernel']"]
    np.testing.assert_array_equal(sd["decoder.MHABlock_0.MultiHeadDotProductAttention_1.out.weight"].numpy(),
                                  out.reshape(-1, out.shape[-1]).T)
