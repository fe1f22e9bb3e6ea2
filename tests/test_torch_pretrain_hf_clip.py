"""``fvd_tpu_torch/tools/pretrain_hf_clip.py`` against the JAX package's
``tools/pretrain_hf_clip.py`` on the CPU, CLIP ``--tiny`` for the
arithmetic (``tests/hf_train_parity.py``):

* the data: text scenes, faces and backgrounds bit for bit against the JAX
  tool's OpenCV scenes, the pool's layout and captions, the sampler's
  indices, and the captions' ids and masks against ``AutoTokenizer``;
* the loss (gather and normalise on the device, symmetric InfoNCE at the
  clipped learned scale plus the band term) and its gradient against the
  JAX tool's on ``FlaxCLIPModule`` in float64, and three clipped AdamW
  steps end to end, ``logit_scale`` trained with the rest;
* the bfloat16 embeddings within 1.5 x JAX's own bfloat16-against-float32
  distance;
* the tool at 2 steps with ``--tiny``: its files load in ``FlaxCLIPModel``
  (equal embeddings) and in ``HFClip`` with the calibration it wrote,
  ``--resume`` continues, ``--promote`` writes float16, and the meta
  sidecar has the JAX tool's keys.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("cv2")
import jax.numpy as jnp  # noqa: E402

import hf_train_parity as hp  # noqa: E402
from fvd_tpu_torch.tools import pretrain_hf_clip as pc  # noqa: E402
from fvd_tpu_torch.utils.hf_tokenizers import Tokenizer  # noqa: E402
from test_torch_train_losses import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HF = os.path.join(REPO, "checkpoints", "hf", "clip")
sys.path.insert(0, os.path.join(REPO, "tools"))
os.environ.setdefault("USE_TF", "0")
import pretrain_hf_clip as jc  # noqa: E402


@pytest.fixture(scope="module")
def pool():
    """The JAX tool's pool of 10 text scenes, 3 faces and 2 backgrounds."""
    return jc.build_pool(np.random.RandomState(0), 10, 3, 2)


def test_scenes_match_the_jax_tool():
    for seed in range(4):
        assert np.array_equal(pc.make_text_scene(np.random.RandomState(seed), "TEXT 42 AB"),
                              jc.make_text_scene(np.random.RandomState(seed), "TEXT 42 AB"))
        assert np.array_equal(pc.make_face_scene(np.random.RandomState(seed)),
                              jc.make_face_scene(np.random.RandomState(seed)))
        assert np.array_equal(pc.make_background(np.random.RandomState(seed)),
                              jc.make_background(np.random.RandomState(seed)))


def test_pool_sampler_and_captions_match_the_jax_tool(pool):
    from transformers import AutoTokenizer

    images, captions = pool
    got_images, got_captions = pc.build_pool(np.random.RandomState(0), 10, 3, 2)
    assert got_captions == captions and captions[10] == pc.FACE_CAPTION and captions[-1] == pc.BG_CAPTION
    np.testing.assert_array_equal(got_images, images)
    for seed in (7, 8):
        np.testing.assert_array_equal(pc.sample_batch(np.random.RandomState(seed), 8, 10, 3, 2),
                                      jc.sample_batch(np.random.RandomState(seed), 8, 10, 3, 2))
    ref = AutoTokenizer.from_pretrained(HF)(captions, padding="max_length", truncation=True, max_length=pc.MAX_LEN,
                                            return_tensors="np")
    got = Tokenizer.from_dir(HF)(captions, pc.MAX_LEN)
    np.testing.assert_array_equal(got["input_ids"], ref["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], ref["attention_mask"])


BAND = (2.0, 0.35)


def _jax_loss(module, p, idx, pool, ids, mask):
    """``tools/pretrain_hf_clip.py:229-262`` (``towers``, ``loss_fn`` and
    ``preprocess`` of the step); its ``jnp.float32`` reads as float64 while
    it is traced."""
    mean = jnp.asarray([0.48145466, 0.4578275, 0.40821073], jnp.float32)
    std = jnp.asarray([0.26862954, 0.26130258, 0.27577711], jnp.float32)
    px = pool[idx].astype(jnp.float32) / 255.0
    pixel_values = (px - mean) / std
    input_ids, attention_mask = ids[idx], mask[idx]
    position_ids = jnp.broadcast_to(jnp.arange(input_ids.shape[-1])[None, :], input_ids.shape)
    out = module.apply({"params": p}, input_ids=input_ids, pixel_values=pixel_values,
                       attention_mask=attention_mask, position_ids=position_ids, deterministic=True)
    ie = out.image_embeds.astype(jnp.float32)
    te = out.text_embeds.astype(jnp.float32)
    ie = ie / (jnp.linalg.norm(ie, axis=-1, keepdims=True) + 1e-8)
    te = te / (jnp.linalg.norm(te, axis=-1, keepdims=True) + 1e-8)
    cos = ie @ te.T
    scale = jnp.exp(jnp.clip(p["logit_scale"], 0.0, jnp.log(100.0)))
    logits = cos * scale
    labels = jnp.arange(logits.shape[0])
    li = -jnp.mean(jax.nn.log_softmax(logits, axis=1)[labels, labels])
    lt = -jnp.mean(jax.nn.log_softmax(logits, axis=0)[labels, labels])
    diag = jnp.diag(cos)
    off = cos - jnp.eye(cos.shape[0]) * cos
    band = (jnp.mean(jax.nn.relu(BAND[1] - diag) ** 2) + jnp.mean(jax.nn.relu(off - 0.05) ** 2))
    return (li + lt) / 2 + BAND[0] * band


def _port_loss(model, idx, pool, ids, mask):
    return pc.clip_step_loss(model, pool, ids, mask, idx, BAND[0], BAND[1], [])


@pytest.fixture(scope="module")
def setup(pool):
    images, captions = pool
    cfg = hp.small_config("clip")
    enc = Tokenizer.from_dir(HF)(captions, pc.MAX_LEN)
    rng = np.random.RandomState(7)
    batches = [(pc.sample_batch(rng, 6, 10, 3, 2).astype(np.int64), images, enc["input_ids"],
                enc["attention_mask"]) for _ in range(hp.STEPS)]
    return cfg, hp.weights("clip", cfg), batches


def test_f64_loss_gradient_and_three_steps_match_jax(setup, monkeypatch, one_torch_thread):
    cfg, sd, batches = setup
    monkeypatch.setattr(jnp, "float32", jnp.float64)
    jout, pout = hp.f64_runs("clip", cfg, sd, _jax_loss, _port_loss, batches)
    monkeypatch.undo()
    zero = hp.check_f64(jout, pout)
    assert "logit_scale" not in zero
    assert hp.rel_l2(pout["params"]["logit_scale"], pout["start"]["logit_scale"]) > 0


def test_bf16_embeddings_within_jax_own_distance(setup):
    cfg, sd, batches = setup
    idx, images, ids, mask = batches[0]
    params = hp.flax_params("clip", sd, np.float32)
    px = torch.from_numpy(images)
    pixels32 = pc.preprocess(px, torch.from_numpy(idx), torch.float32).numpy()

    def jax_embeds(dtype):
        out = hp.flax_module("clip", cfg, dtype).apply(
            {"params": params}, input_ids=ids[idx], pixel_values=pixels32.astype(dtype), attention_mask=mask[idx],
            position_ids=np.broadcast_to(np.arange(pc.MAX_LEN)[None], ids[idx].shape), deterministic=True)
        return np.concatenate([np.asarray(out.image_embeds.astype(jnp.float32)),
                               np.asarray(out.text_embeds.astype(jnp.float32))])

    ref32, ref16 = jax_embeds(jnp.float32), jax_embeds(jnp.bfloat16)
    model = hp.port_model("clip", cfg, sd, torch.float32, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        ie, te = model(pc.preprocess(px, torch.from_numpy(idx), torch.bfloat16), torch.from_numpy(ids[idx]),
                       torch.from_numpy(mask[idx]))
    port16 = np.concatenate([ie.float().numpy(), te.float().numpy()])
    jax_gap = hp.rel_l2(ref16, ref32)
    assert 0 < hp.rel_l2(port16, ref32) <= 1.5 * jax_gap, (hp.rel_l2(port16, ref32), jax_gap)


def test_tool_writes_files_both_packages_load(tmp_path, one_torch_thread):
    from transformers import FlaxCLIPModel

    from fvd_tpu_torch.providers.hf_models import HFClip
    from fvd_tpu_torch.utils.msgpack import leaves, read_msgpack

    out, promoted = str(tmp_path / "clip"), str(tmp_path / "promoted")
    first = pc.main(["--cpu", "--tiny", "--steps", "2", "--batch", "4", "--pool", "8", "--eval-every", "0",
                     "--out", out, "--promote", promoted])
    assert first["steps"] == 2 and np.isfinite([first["loss_first"], first["loss_last"]]).all()
    with open(os.path.join(out, "fvd_train_meta.json")) as f:
        meta = json.load(f)
    assert sorted(meta) == sorted(["domain", "train", "steps", "pool", "seed", "geometry", "cal_offset",
                                   "cal_scale"])
    assert {str(v.dtype) for _, v in leaves(read_msgpack(os.path.join(promoted, "flax_model.msgpack")))} == \
        {"float16"}
    served = HFClip.from_local(out, device="cpu")
    assert (served.cal_offset, served.cal_scale) == (meta["cal_offset"], meta["cal_scale"])

    loaded = FlaxCLIPModel.from_pretrained(out, _do_init=False)
    flax_model, params = loaded if isinstance(loaded, tuple) else (loaded, loaded.params)
    assert params["logit_scale"].shape == ()
    images, captions = pc.build_pool(np.random.RandomState(3), 2, 1, 1)
    enc = served.tokenize(captions)
    pixels = pc.preprocess(torch.from_numpy(images), torch.arange(4), torch.float32)
    ref = flax_model.module.apply({"params": params}, input_ids=enc["input_ids"], pixel_values=pixels.numpy(),
                                  attention_mask=enc["attention_mask"],
                                  position_ids=np.broadcast_to(np.arange(pc.MAX_LEN)[None], enc["input_ids"].shape),
                                  deterministic=True)
    with torch.no_grad():
        ie, te = served.model(pixels, torch.as_tensor(enc["input_ids"]), torch.as_tensor(enc["attention_mask"]))
    np.testing.assert_allclose(ie.numpy(), np.asarray(ref.image_embeds), atol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(ref.text_embeds), atol=1e-5)

    before = read_msgpack(os.path.join(out, "flax_model.msgpack"))
    second = pc.main(["--cpu", "--tiny", "--resume", "--steps", "1", "--batch", "4", "--pool", "8", "--lr", "1e-3",
                      "--warmup", "0", "--eval-every", "0", "--out", out])
    assert second["steps"] == 1
    after = read_msgpack(os.path.join(out, "flax_model.msgpack"))
    w0 = np.array(before["visual_projection"]["kernel"])
    w1 = np.array(after["visual_projection"]["kernel"])
    assert 0 < np.abs(w1 - w0).max() < 1e-2
    assert float(after["logit_scale"]) != float(before["logit_scale"])
