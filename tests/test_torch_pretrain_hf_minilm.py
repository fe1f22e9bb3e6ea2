"""``fvd_tpu_torch/tools/pretrain_hf_minilm.py`` against the JAX package's
``tools/pretrain_hf_minilm.py`` on the CPU, BERT at 2 layers x 64 for the
arithmetic (``tests/hf_train_parity.py``):

* the batch: unique facts of the JAX tool's generator rendered as claim and
  search result, tokenized as ``AutoTokenizer(..., padding="max_length",
  max_length=64)`` tokenizes them;
* the loss (masked mean pool, symmetric InfoNCE at 0.07) and its gradient
  against the JAX tool's on ``FlaxBertModule`` in float64, three clipped
  AdamW steps end to end, and the pooler, which no loss reaches, decayed as
  optax decays it;
* the bfloat16 forward within 1.5 x JAX's own bfloat16-against-float32
  distance;
* the tool at 2 steps: its files load in ``FlaxBertModel`` and in
  ``HFTextEncoder`` with the same embeddings, ``--resume`` continues,
  ``--promote`` writes float16, and the meta sidecar has the JAX tool's keys.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import hf_train_parity as hp  # noqa: E402
from fvd_tpu_torch.tools import pretrain_hf_minilm as pm  # noqa: E402
from fvd_tpu_torch.utils.hf_tokenizers import Tokenizer  # noqa: E402
from test_torch_train_losses import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HF = os.path.join(REPO, "checkpoints", "hf", "minilm")
sys.path.insert(0, os.path.join(REPO, "tools"))
os.environ.setdefault("USE_TF", "0")


@pytest.fixture(scope="module")
def tok():
    return Tokenizer.from_dir(HF)


def _jax_batch(rng, batch):
    """``make_batch`` of ``tools/pretrain_hf_minilm.py:98-116``."""
    from pretrain_text_encoder import make_fact, render_doc, render_fact
    from transformers import AutoTokenizer

    hf_tok = AutoTokenizer.from_pretrained(HF)
    seen, qs, ds = set(), [], []
    while len(qs) < batch:
        f = make_fact(rng)
        key = json.dumps(f, sort_keys=True)
        if key in seen:
            continue
        seen.add(key)
        qs.append(render_fact(rng, f))
        ds.append(render_doc(rng, f))
    out = []
    for texts in (qs, ds):
        enc = hf_tok(texts, padding="max_length", truncation=True, max_length=64, return_tensors="np")
        out += [enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(np.int32)]
    return out


def test_batch_matches_the_jax_tool(tok):
    for seed in (7, 10_007):
        ref = _jax_batch(np.random.RandomState(seed), 24)
        got = pm.make_batch(np.random.RandomState(seed), 24, tok)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)


def _jax_loss(module, p, q_ids, q_mask, d_ids, d_mask):
    """``tools/pretrain_hf_minilm.py:128-147``; its ``jnp.float32`` casts
    are float64 here."""
    def mean_pool(input_ids, attention_mask):
        hidden = module.apply({"params": p}, input_ids, attention_mask, deterministic=True).last_hidden_state
        mask = attention_mask[..., None].astype(hidden.dtype)
        summed = (hidden * mask).sum(axis=1)
        counts = mask.sum(axis=1).clip(1e-9)
        return (summed / counts).astype(jnp.float64)

    q = mean_pool(q_ids, q_mask)
    d = mean_pool(d_ids, d_mask)
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + 1e-8)
    d = d / (jnp.linalg.norm(d, axis=-1, keepdims=True) + 1e-8)
    logits = (q @ d.T) / 0.07
    labels = jnp.arange(logits.shape[0])
    lq = -jnp.mean(jax.nn.log_softmax(logits, axis=1)[labels, labels])
    ld = -jnp.mean(jax.nn.log_softmax(logits, axis=0)[labels, labels])
    return (lq + ld) / 2


@pytest.fixture(scope="module")
def setup(tok):
    cfg = hp.small_config("bert")
    return cfg, hp.weights("bert", cfg)


def test_f64_loss_gradient_and_three_steps_match_jax(setup, tok, one_torch_thread):
    cfg, sd = setup
    rng = np.random.RandomState(7)
    batches = [tuple(x.astype(np.int64) for x in pm.make_batch(rng, 6, tok)) for _ in range(hp.STEPS)]
    jout, pout = hp.f64_runs("bert", cfg, sd, _jax_loss, pm.minilm_loss, batches)
    zero = hp.check_f64(jout, pout, frozen=("pooler.dense.weight",))
    assert {k for k in zero if not k.startswith("pooler")} <= {
        f"encoder.layer.{i}.attention.self.key.bias" for i in range(2)} | {"embeddings.position_embeddings.weight"}


def test_bf16_forward_within_jax_own_distance(setup, tok):
    cfg, sd = setup
    q_ids, q_mask, _, _ = pm.make_batch(np.random.RandomState(3), 8, tok)
    params = hp.flax_params("bert", sd, np.float32)

    def jax_embed(dtype):
        hidden = hp.flax_module("bert", cfg, dtype).apply({"params": params}, q_ids, q_mask,
                                                           deterministic=True).last_hidden_state
        mask = q_mask[..., None].astype(hidden.dtype)
        return np.asarray(((hidden * mask).sum(axis=1) / mask.sum(axis=1).clip(1e-9)).astype(jnp.float32))

    ref32, ref16 = jax_embed(jnp.float32), jax_embed(jnp.bfloat16)
    model = hp.port_model("bert", cfg, sd, torch.float32, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        port16 = pm.embed(model, torch.from_numpy(q_ids), torch.from_numpy(q_mask)).numpy()
    assert port16.dtype == np.float32
    jax_gap = hp.rel_l2(ref16, ref32)
    assert 0 < hp.rel_l2(port16, ref32) <= 1.5 * jax_gap, (hp.rel_l2(port16, ref32), jax_gap)


def test_tool_writes_files_both_packages_load(tmp_path, one_torch_thread):
    from transformers import FlaxBertModel

    from fvd_tpu_torch.providers.hf_models import HFTextEncoder
    from fvd_tpu_torch.utils.msgpack import leaves, read_msgpack

    out, promoted = str(tmp_path / "minilm"), str(tmp_path / "promoted")
    first = pm.main(["--cpu", "--steps", "2", "--batch", "4", "--eval-every", "0", "--out", out,
                     "--promote", promoted])
    assert first["steps"] == 2 and np.isfinite([first["loss_first"], first["loss_last"]]).all()
    with open(os.path.join(out, "fvd_train_meta.json")) as f:
        assert sorted(json.load(f)) == sorted(["domain", "train", "steps", "seed", "geometry"])
    assert {str(v.dtype) for _, v in leaves(read_msgpack(os.path.join(promoted, "flax_model.msgpack")))} == \
        {"float16"}
    assert set(os.listdir(promoted)) == set(os.listdir(out))

    sentences = ["the city council said on monday it will cut taxes", "river levels rose two feet"]
    enc = HFTextEncoder.from_local(out, max_len=64, device="cpu")
    port = enc.encode_batch(sentences)
    flax_model = FlaxBertModel.from_pretrained(out, _do_init=False)
    flax_model, params = flax_model[0] if isinstance(flax_model, tuple) else flax_model, \
        flax_model[1] if isinstance(flax_model, tuple) else flax_model.params
    batch = enc.tokenize(sentences)
    hidden = np.asarray(flax_model.module.apply({"params": params}, batch["input_ids"], batch["attention_mask"],
                                                deterministic=True).last_hidden_state)
    mask = batch["attention_mask"][..., None]
    np.testing.assert_allclose(port, (hidden * mask).sum(1) / mask.sum(1), atol=1e-5)
    assert "pooler" in params

    before = read_msgpack(os.path.join(out, "flax_model.msgpack"))
    w0 = np.array(before["encoder"]["layer"]["0"]["output"]["dense"]["kernel"])
    second = pm.main(["--cpu", "--resume", "--steps", "1", "--batch", "4", "--lr", "1e-3", "--warmup", "0",
                      "--eval-every", "0", "--out", out])
    assert second["steps"] == 1
    after = read_msgpack(os.path.join(out, "flax_model.msgpack"))
    w1 = np.array(after["encoder"]["layer"]["0"]["output"]["dense"]["kernel"])
    assert 0 < np.abs(w1 - w0).max() < 1e-2
