"""The zoo's training losses against the JAX package's on the CPU:
``asr_loss``, ``ctc_loss``, ``clip_loss`` and the text encoder's InfoNCE (the
JAX tool computes it inline, ``tools/pretrain_text_encoder.py:225-234``; the
reference below is a copy), at small widths (dim 32, depth 1; a recognizer
of width 8).  The port's seeded weights go to JAX as a flax tree through
``weights.from_state_dict``, which needs the model for the attention
projections' head count and the embeddings.

In float32 the loss on the first batch agrees within ``F32_LOSS_RTOL``; in
float64 (JAX with x64 on, the port's modules in double) the losses of three
Adam steps, the first step's gradients and the parameters after the third
step agree within ``F64_RTOL`` relative L2 per tensor.  The key projection's
bias has an exactly zero gradient (it adds the same score to every key of a
query's row, which the softmax ignores): its gradient is held to zero on
both sides instead, and the parameter, which starts at zero, to stay within
rounding of it.  Also the round trip
``to_state_dict(from_state_dict(m)) == m.state_dict()`` for the four
models, and the CTC loss where no alignment exists.
"""

import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from fvd_tpu.models import asr as jasr  # noqa: E402
from fvd_tpu.models import encoders as jenc  # noqa: E402
from fvd_tpu.models import ocr as jocr  # noqa: E402
from fvd_tpu_torch import weights  # noqa: E402
from fvd_tpu_torch.models import asr, encoders, ocr  # noqa: E402
from fvd_tpu_torch.models.layers import adam, adam_step  # noqa: E402
from fvd_tpu_torch.models.transformer import ByteTokenizer  # noqa: E402
from test_torch_train_losses import _nest, one_torch_thread, rel_l2  # noqa: E402,F401

F32_LOSS_RTOL = 1e-5
F64_RTOL = 1e-9
#: the zero-gradient tensors' gradient, relative to the whole gradient, and
#: their parameter after three steps
ZERO_GRAD_RTOL, ZERO_PARAM_ATOL = 1e-12, 1e-9
STEPS = 3
DIM, DEPTH, OUT = 32, 1, 16
LR = {"asr": 1e-3, "ctc": 1e-3, "clip": 3e-4, "text": 3e-4}
SENTENCES = ["the moon landing happened in 1969", "water boils at 100 degrees",
             "the mayor said the city will cut taxes", "thanks for watching", "a", "river rose two feet"]


def _jax_text_loss(params, model, q_ids, d_ids):
    """``tools/pretrain_text_encoder.py``'s ``loss_fn``."""
    q = model.apply(params, q_ids)
    d = model.apply(params, d_ids)
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    logits = (q @ d.T) / 0.07
    labels = jnp.arange(logits.shape[0])
    lq = -jnp.mean(jax.nn.log_softmax(logits, axis=1)[labels, labels])
    ld = -jnp.mean(jax.nn.log_softmax(logits, axis=0)[labels, labels])
    return (lq + ld) / 2


def _ids(rng, n, length=24):
    tok = ByteTokenizer()
    return np.stack([tok.encode(SENTENCES[i] if rng.rand() < 0.5 else SENTENCES[i][::-1], length)
                     for i in rng.permutation(len(SENTENCES))[:n]]).astype(np.int32)


def _batches(name, float_dt):
    """Three batches of ``name``'s inputs (floats in ``float_dt``)."""
    out = []
    for s in range(STEPS):
        rng = np.random.RandomState(s)
        if name == "asr":
            tok = ByteTokenizer()
            texts = [SENTENCES[i][:10] for i in rng.permutation(len(SENTENCES))[:2]]
            tout = np.stack([tok.encode(t, 16, add_special=True) for t in texts]).astype(np.int32)
            tin = np.concatenate([np.full((2, 1), tok.BOS, np.int32), tout[:, :-1]], axis=1)
            out.append((rng.randn(2, 24, asr.N_MELS).astype(float_dt), tin, tout))
        elif name == "ctc":
            labels = np.stack([ocr.encode_ctc_labels(t, 32) for t in ("Hello 42", "moon-landing")])
            out.append((rng.rand(2, 32, 256, 1).astype(float_dt), labels))
        elif name == "clip":
            out.append((rng.rand(3, 112, 112, 3).astype(float_dt), _ids(rng, 3)))
        else:
            out.append((_ids(rng, 4), _ids(rng, 4)))
    return out


def _models():
    """name -> (port model, JAX module, JAX loss, port loss)."""
    return {
        "asr": (weights.seeded(asr.AsrModel(DIM, DEPTH), 0), jasr.AsrModel(dim=DIM, depth=DEPTH), jasr.asr_loss,
                asr.asr_loss),
        "ctc": (weights.seeded(ocr.CTCRecognizer(8), 1), jocr.CTCRecognizer(width=8), jocr.ctc_loss, ocr.ctc_loss),
        "clip": (weights.seeded(encoders.ClipModel(DIM, DEPTH, OUT), 2),
                 jenc.ClipModel(dim=DIM, depth=DEPTH, out_dim=OUT), jenc.clip_loss, encoders.clip_loss),
        "text": (weights.seeded(encoders.TextTower(DIM, DEPTH, out_dim=OUT), 3),
                 jenc.TextTower(dim=DIM, depth=DEPTH, out_dim=OUT), _jax_text_loss, encoders.text_info_nce_loss),
    }


def _port_args(batch, tdt):
    return [torch.from_numpy(np.asarray(x)).to(tdt if np.asarray(x).dtype.kind == "f" else torch.long)
            for x in batch]


def run_both(name, steps, double):
    """Both packages' Adam steps over ``steps`` batches from the port's
    seeded weights -> {side: (losses, step-0 grads, final params)}."""
    model, jmodel, jloss, ploss = _models()[name]
    tdt, ndt = (torch.float64, np.float64) if double else (torch.float32, np.float32)
    batches = _batches(name, ndt)[:steps]
    model = copy.deepcopy(model).to(tdt)
    tx = optax.adam(LR[name])

    @jax.jit
    def jstep(params, opt_state, *b):
        loss, grads = jax.value_and_grad(jloss)(params, jmodel, *b)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    params = _nest({k: jnp.asarray(v) for k, v in weights.from_state_dict(model, dtype=tdt).items()})
    opt_state, losses, grads = tx.init(params), [], None
    for b in batches:
        params, opt_state, loss, g = jstep(params, opt_state, *(jnp.asarray(x) for x in b))
        losses.append(float(loss))
        grads = grads or weights.flatten(jax.tree.map(np.asarray, g))
    out = {"jax": (losses, grads, weights.flatten(jax.tree.map(np.asarray, params)))}

    opt, losses, grads = adam(model, LR[name]), [], None
    for b in batches:
        losses.append(float(adam_step(ploss, model, opt, *_port_args(b, tdt))))
        grads = grads or weights.from_state_dict({k: p.grad for k, p in model.named_parameters()}, dtype=tdt,
                                                 model=model)
    out["port"] = (losses, grads, weights.from_state_dict(model, dtype=tdt))
    return out


CASES = ("asr", "ctc", "clip", "text")


@pytest.fixture(scope="module")
def f64_runs():
    jax.config.update("jax_enable_x64", True)
    try:
        return {name: run_both(name, STEPS, double=True) for name in CASES}
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("name", CASES)
def test_f32_loss_matches_jax(name):
    model, jmodel, jloss, ploss = _models()[name]
    batch = _batches(name, np.float32)[0]
    params = _nest({k: jnp.asarray(v) for k, v in weights.from_state_dict(model).items()})
    want = float(jax.jit(jloss, static_argnums=1)(params, jmodel, *(jnp.asarray(x) for x in batch)))
    with torch.no_grad():
        got = float(ploss(model, *_port_args(batch, torch.float32)))
    np.testing.assert_allclose(got, want, rtol=F32_LOSS_RTOL)


@pytest.mark.parametrize("name", CASES)
def test_f64_losses_gradients_and_params_after_three_adam_steps_match_jax(f64_runs, name):
    (jl, jg, jp), (pl, pg, pp) = f64_runs[name]["jax"], f64_runs[name]["port"]
    np.testing.assert_allclose(pl, jl, rtol=F64_RTOL)
    assert set(pg) == set(jg) and set(pp) == set(jp)
    total = np.sqrt(sum(float(np.sum(g ** 2)) for g in jg.values()))
    for key in jg:
        if key.endswith("['key']['bias']"):
            for g, p in ((jg[key], jp[key]), (pg[key], pp[key])):
                assert np.linalg.norm(g) <= ZERO_GRAD_RTOL * total and np.abs(p).max() <= ZERO_PARAM_ATOL, key
            continue
        assert rel_l2(pg[key], jg[key]) <= F64_RTOL, ("grad", key, rel_l2(pg[key], jg[key]))
        assert rel_l2(pp[key], jp[key]) <= F64_RTOL, ("param", key, rel_l2(pp[key], jp[key]))
    assert pl[-1] < pl[0]


@pytest.mark.parametrize("name", CASES)
def test_state_dict_round_trip(name):
    model = _models()[name][0]
    tree = weights.from_state_dict(model)
    back = weights.to_state_dict(tree)
    ref = model.state_dict()
    assert set(back) == set(ref)
    for k, v in ref.items():
        assert torch.equal(back[k], v), k
    if name in ("asr", "text"):  # [D, H, Dh] kernels, embeddings as they are
        prefix = "['params']['encoder']" if name == "asr" else "['params']"
        q = tree[prefix + "['MHABlock_0']['MultiHeadDotProductAttention_0']['query']['kernel']"]
        assert q.shape == (DIM, 1, DIM)
        emb = "['params']['decoder']['Embed_0']['embedding']" if name == "asr" else "['params']['Embed_0']['embedding']"
        assert tree[emb].shape == (ByteTokenizer.vocab_size, DIM)


def test_attention_and_embeddings_need_the_model():
    model = weights.seeded(encoders.TextTower(DIM, DEPTH, heads=2, out_dim=OUT), 0)
    with pytest.raises(ValueError, match="needs the model"):
        weights.from_state_dict(model.state_dict())
    tree = weights.from_state_dict(model)
    out = tree["['params']['MHABlock_0']['MultiHeadDotProductAttention_0']['out']['kernel']"]
    bias = tree["['params']['MHABlock_0']['MultiHeadDotProductAttention_0']['value']['bias']"]
    assert out.shape == (2, DIM // 2, DIM) and bias.shape == (2, DIM // 2)


def test_ctc_loss_without_an_alignment():
    """More labels than frames: optax's ``log_epsilon`` gives a large finite
    loss, torch gives ``inf`` (documented in ``ocr.ctc_loss``); a feasible
    row in the same batch keeps its finite loss on both sides."""
    model = weights.seeded(ocr.CTCRecognizer(8), 0)
    images = np.random.RandomState(0).rand(1, 32, 256, 1).astype(np.float32)
    labels = np.tile(np.arange(1, 66, dtype=np.int32), (1, 1))   # 65 labels, 64 frames
    params = _nest({k: jnp.asarray(v) for k, v in weights.from_state_dict(model).items()})
    want = float(jocr.ctc_loss(params, jocr.CTCRecognizer(width=8), jnp.asarray(images), jnp.asarray(labels)))
    with torch.no_grad():
        got = float(ocr.ctc_loss(model, torch.from_numpy(images), torch.from_numpy(labels)))
    assert np.isfinite(want) and want > 1e4 and got == float("inf")
