"""What ``tests/test_torch_pretrain_hf_{minilm,whisper,clip}.py`` share: the
small geometries, the port's model and transformers' Flax module of each on
the same weights, and the float64 runs of three steps of a tool's loss and
optimiser chain in both packages (JAX with x64 on).

The JAX side is the JAX tools' arithmetic on transformers' Flax modules
(the loss functions are nested in each tool's ``main``, so they are
written out here, line for line, with the tool's ``jnp.float32`` casts of
the compute-dtype outputs as float64 and its optax chain with the schedule
read at a float64 count, as ``tests/test_torch_pretrain_fan.py`` reads it).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from fvd_tpu_torch.models import optim
from fvd_tpu_torch.models.hf_bert import BertModel
from fvd_tpu_torch.models.hf_clip import CLIPModel
from fvd_tpu_torch.models.hf_whisper import WhisperForConditionalGeneration
from fvd_tpu_torch.tools import hf_train, make_hf_geometry_checkpoints as makers
from fvd_tpu_torch.weights import hf_state_dict, hf_tree

STEPS, WARMUP, LR = 3, 1, 1e-3
#: a tensor's gradient whose norm is under this share of the whole is zero
#: in exact arithmetic (the attention key biases: the softmax does not see a
#: per-query constant; the pooler; the frozen positions)
ZERO_GRAD_RTOL = 1e-12
F64_RTOL = 1e-12
F64_END_TO_END = 1e-9
PORT_CLASSES = {"bert": BertModel, "clip": CLIPModel, "whisper": WhisperForConditionalGeneration}


def small_config(family: str) -> dict:
    """BERT 2 x 64, CLIP ``--tiny``, Whisper d64 2 + 2 with vocab 600."""
    if family == "bert":
        cfg = makers.minilm_config()
        cfg.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128)
        return cfg
    if family == "clip":
        return makers.clip_config(tiny=True)
    return makers.whisper_config(d_model=64, layers=2, heads=2, ffn=128, vocab_size=600)


def weights(family: str, cfg: dict, seed: int = 0) -> dict:
    """The port's maker's float32 weights (state dict) at ``cfg``."""
    return makers.init_state_dict(hf_train.training_model(PORT_CLASSES[family], family, cfg), family, cfg, seed)


def port_model(family: str, cfg: dict, sd: dict, dtype=torch.float64, compute_dtype=None):
    model = hf_train.training_model(PORT_CLASSES[family], family, cfg, compute_dtype)
    model.load_state_dict(sd)
    return model.to(dtype)


def flax_module(family: str, cfg: dict, dtype):
    from transformers import BertConfig, CLIPConfig, WhisperConfig
    from transformers.models.bert.modeling_flax_bert import FlaxBertModule
    from transformers.models.clip.modeling_flax_clip import FlaxCLIPModule
    from transformers.models.whisper.modeling_flax_whisper import FlaxWhisperForConditionalGenerationModule

    if family == "bert":
        return FlaxBertModule(BertConfig(**cfg), dtype=dtype)
    if family == "clip":
        return FlaxCLIPModule(CLIPConfig(**cfg), dtype=dtype)
    return FlaxWhisperForConditionalGenerationModule(WhisperConfig(**cfg), dtype=dtype)


def flax_params(family: str, sd: dict, dtype=np.float64):
    return jax.tree.map(jnp.asarray, hf_tree(sd, family, dtype=dtype))


def to_port(tree, family: str) -> dict:
    """A Flax tree (params or gradients) as the port's float64 state dict."""
    return hf_state_dict(jax.tree.map(np.asarray, tree), family, unused=True)


def jax_chain():
    """The HF tools' ``tx`` (``pretrain_hf_minilm.py:118-125`` and the same
    lines of the other two), the schedule read at a float64 count."""
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, WARMUP, max(STEPS, WARMUP + 1), end_value=LR * 0.03)
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        lambda count: sched(jnp.asarray(count, jnp.float64)), b2=0.98, weight_decay=0.01))


def decay_factors() -> list:
    """optax's ``1 - lr_t * 0.01`` of each step in float64."""
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, WARMUP, max(STEPS, WARMUP + 1), end_value=LR * 0.03)
    return [1.0 - float(sched(jnp.asarray(t, jnp.float64))) * 0.01 for t in range(STEPS)]


def f64_runs(family: str, cfg: dict, sd: dict, jax_loss, port_loss, batches):
    """Three steps in both packages from ``sd`` on ``batches`` (tuples of
    numpy arrays; ``jax_loss(module, params, *batch)`` and
    ``port_loss(model, *batch)``) -> (jax, port): each a dict of the losses,
    the first unclipped gradient, the clipped gradients of each step, and
    the final parameters, as float64 state dicts of the port's names."""
    jax.config.update("jax_enable_x64", True)
    try:
        module = flax_module(family, cfg, jnp.float64)
        tx, clip = jax_chain(), optax.clip_by_global_norm(1.0)

        def loss_fn(p, *batch):
            return jax_loss(module, p, *batch)

        @jax.jit
        def jstep(params, opt_state, *batch):
            loss, grads = jax.value_and_grad(loss_fn)(params, *batch)
            clipped, _ = clip.update(grads, clip.init(params))
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss, grads, clipped

        params = flax_params(family, sd)
        opt_state = tx.init(params)
        jout = {"losses": [], "clipped": []}
        for b in batches:
            params, opt_state, loss, g, gc = jstep(params, opt_state, *(jnp.asarray(x) for x in b))
            jout["losses"].append(float(loss))
            jout.setdefault("grad0", to_port(g, family))
            jout["clipped"].append(to_port(gc, family))
        jout["params"] = to_port(params, family)
        jout["decay"] = decay_factors()
    finally:
        jax.config.update("jax_enable_x64", False)

    def tensors(b):
        return [torch.from_numpy(np.asarray(x)) for x in b]

    start = port_model(family, cfg, sd)
    model = copy.deepcopy(start)
    opt, sched = hf_train.hf_optimizer(model, LR, WARMUP, STEPS)
    pout = {"losses": [], "clipped": []}
    for b in batches:
        pout["losses"].append(float(optim.clipped_adamw_step(port_loss, model, opt, sched, *tensors(b))))
        pout["clipped"].append({k: p.grad.detach().clone() for k, p in model.named_parameters()})
    pout["params"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model = copy.deepcopy(start)
    loss = port_loss(model, *tensors(batches[0]))
    loss.backward()
    pout["loss0"] = float(loss.detach())
    pout["grad0"] = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
                     for k, p in model.named_parameters()}
    pout["start"] = {k: v.detach().clone() for k, v in start.state_dict().items()}
    return jout, pout


def rel_l2(a, b) -> float:
    a, b = (torch.as_tensor(np.array(x, dtype=np.float64)) for x in (a, b))
    diff, ref = float(torch.linalg.vector_norm(a - b)), float(torch.linalg.vector_norm(b))
    return 0.0 if diff == ref == 0 else diff / ref


def zero_grads(grads: dict) -> set:
    total = sum(float(torch.sum(g.double() ** 2)) for g in grads.values()) ** 0.5
    return {k for k, g in grads.items() if float(torch.linalg.vector_norm(g.double())) <= ZERO_GRAD_RTOL * total}


def check_f64(jout: dict, pout: dict, frozen=()):
    """The first loss and gradient within ``F64_RTOL`` (the gradient per
    tensor of the whole), three steps end to end within ``F64_END_TO_END``
    per tensor but for the tensors whose gradient is zero in exact
    arithmetic (Adam turns their rounding noise into steps of ~lr either
    way), and the ``frozen`` parameters decayed as optax decays them."""
    np.testing.assert_allclose(pout["loss0"], jout["losses"][0], rtol=F64_RTOL)
    g0 = jout["grad0"]
    assert set(pout["grad0"]) == set(g0)
    total = sum(float(torch.sum(g ** 2)) for g in g0.values()) ** 0.5
    for k, ref in g0.items():
        assert float(torch.linalg.vector_norm(pout["grad0"][k] - ref)) <= F64_RTOL * total, k
    zero = zero_grads(g0)
    assert set(frozen) <= zero, (sorted(frozen), sorted(zero))
    np.testing.assert_allclose(pout["losses"], jout["losses"], rtol=F64_END_TO_END)
    for jg, pg in zip(jout["clipped"], pout["clipped"]):
        for k in jg:
            if k not in zero:
                assert rel_l2(pg[k], jg[k]) <= F64_END_TO_END, ("grad", k, rel_l2(pg[k], jg[k]))
    for k, ref in jout["params"].items():
        if k not in zero:
            assert rel_l2(pout["params"][k], ref) <= F64_END_TO_END, ("param", k, rel_l2(pout["params"][k], ref))
    factor = float(np.prod(jout["decay"]))
    for k in frozen:
        p0 = pout["start"][k]
        assert rel_l2(jout["params"][k], p0 * factor) <= F64_RTOL, ("optax decay", k)
        assert rel_l2(pout["params"][k], jout["params"][k]) <= F64_RTOL, ("port decay", k)
        assert factor < 1.0 and not torch.equal(pout["params"][k], p0)
    return zero
