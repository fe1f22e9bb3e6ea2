"""Rank programs: what each rank of a
:class:`~fvd_tpu_torch.parallel.launch.RankGroup` runs to drive the parallel
layer, numpy in and numpy out.

Each builds its mesh over the group's ranks (a mesh smaller than the group
takes ranks ``0..size-1``; the others return ``None``), puts its inputs on
the rank's device, and returns what the JAX counterpart returns.
``entry.dryrun_multichip``, ``chip_smoke.py`` and the tests run them.
Weights come as numpy trees or from a seed (:func:`weights.seeded_state_dict`),
so each rank builds them itself.
"""

from __future__ import annotations

import numpy as np
import torch

from fvd_tpu_torch import weights as weights_mod
from fvd_tpu_torch.parallel import experts, pipeline, stages, tensor
from fvd_tpu_torch.parallel.launch import rank_device
from fvd_tpu_torch.parallel.mesh import axis_mesh, make_mesh


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=rank_device())


def sp_lipsync(n_data: int, n_time: int, mouth, audio, fps: float):
    """The SP lip-sync score of ``mouth``/``audio`` ``[n]`` over a
    ``n_data x n_time`` mesh."""
    mesh = make_mesh(n_data, n_time)
    out = pipeline.make_time_sharded_lipsync(mesh, len(mouth), fps)(_t(mouth), _t(audio))
    return None if out is None else float(out)


def dp_lr_step(n_data: int, feats, labels, w, b, lr: float):
    """One DP LR step over a ``n_data x 1`` mesh -> dict ``w, b, probs, loss``."""
    step = pipeline.make_dp_lr_train_step(make_mesh(n_data, 1), lr=lr)
    out = step(_t(feats), _t(labels), _t(w), _t(b))
    return None if out is None else out._asdict()


def multichip_train(n_data: int, n_time: int, batch: int, fps: float, mouth, audio, other, labels, w, b,
                    steps: int):
    """``steps`` fused DP x SP train steps from ``(w, b)`` -> one dict ``w, b,
    probs, loss`` per step."""
    mesh = make_mesh(n_data, n_time)
    step = pipeline.make_multichip_train_step(mesh, batch, mouth.shape[1], fps)
    if not mesh.active:
        return None
    args = [_t(a) for a in (mouth, audio, other, labels)]
    w, b = _t(w), _t(b)
    out = []
    for _ in range(steps):
        r = step(*args, w, b)
        w, b = r.w, r.b
        out.append(r._asdict())
    return out


def _tp(model: torch.nn.Module, tp: int, x: torch.Tensor):
    mesh = axis_mesh("model", tp)
    if not mesh.active:
        return None
    with torch.no_grad():
        return tensor.shard_params_tp(model.to(rank_device()), mesh)(x)


def tp_text_tower(tp: int, state, dim: int, depth: int, out_dim: int, ids):
    """The text tower with the torch state dict ``state`` (numpy), TP over
    ``tp`` ranks, on token ids ``[B, T]``."""
    from fvd_tpu_torch.models.encoders import TextTower

    model = TextTower(dim=dim, depth=depth, out_dim=out_dim)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return _tp(model, tp, _t(ids, torch.int64))


def tp_asr_encoder(tp: int, seed: int, dim: int, depth: int, heads: int, mel):
    """The ASR encoder at ``dim/depth/heads`` with weights from ``seed``, TP
    over ``tp`` ranks, on ``mel`` ``[B, T, 80]``."""
    from fvd_tpu_torch.models.asr import AsrEncoder

    enc = AsrEncoder(dim=dim, depth=depth, heads=heads)
    enc.load_state_dict(weights_mod.seeded_state_dict(enc, seed))
    return _tp(enc, tp, _t(mel))


def _residual_layer(params, x):
    w, b = params
    return x + torch.tanh(x @ w + b)


def pp_residual_stack(layers, xs, tgt=None, lr: float = 0.1):
    """The ``len(layers)``-stage GPipe ring over ``x + tanh(x @ w + b)``
    layers (numpy ``(w, b)`` pairs) on microbatches ``[M, B, D]`` -> dict:
    ``out``; with a target also this stage's ``grads`` (w, b) of the mean
    square loss, ``loss0`` and ``loss1`` after one SGD step of ``lr``."""
    S = len(layers)
    mesh = axis_mesh("stage", S)
    if not mesh.active:
        return None
    stacked = stages.stack_layer_params([tuple(_t(a) for a in layer) for layer in layers])
    w, b = (a.clone().requires_grad_(tgt is not None) for a in stages.stage_row(stacked, mesh.index("stage")))
    xs = _t(xs)
    out = stages.pipeline_forward(mesh, _residual_layer, (w, b), xs)
    if tgt is None:
        return {"out": out}
    tgt = _t(tgt)
    loss0 = torch.mean((out - tgt) ** 2)
    loss0.backward()
    with torch.no_grad():
        stepped = (w - lr * w.grad, b - lr * b.grad)
        loss1 = torch.mean((stages.pipeline_forward(mesh, _residual_layer, stepped, xs) - tgt) ** 2)
    return {"out": out, "grads": (w.grad, b.grad), "loss0": loss0.detach(), "loss1": loss1}


def pp_asr_encoder(state, dim: int, depth: int, mel):
    """``asr_encoder_pp`` of the ASR encoder with the torch state dict
    ``state`` (numpy), one block per stage over ``depth`` ranks."""
    from fvd_tpu_torch.models.asr import AsrEncoder

    mesh = axis_mesh("stage", depth)
    if not mesh.active:
        return None
    enc = AsrEncoder(dim=dim, depth=depth)
    enc.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    with torch.no_grad():
        return stages.asr_encoder_pp(enc.to(rank_device()), _t(mel), mesh)


def moe(ep: int, params, x, capacity_factor: float = 1.25, tgt=None):
    """The EP MoE FFN over ``ep`` ranks (``params``: the whole numpy dict;
    each rank keeps its experts) on tokens ``x [B, D]`` -> dict ``out``; with
    a target also the mean square loss's ``grads`` (this rank's experts, the
    whole gate)."""
    mesh = axis_mesh("expert", ep)
    if not mesh.active:
        return None
    local = {k: v.clone().requires_grad_(tgt is not None)
             for k, v in experts.local_experts({k: _t(v) for k, v in params.items()}, mesh).items()}
    out = experts.moe_forward(mesh, local, _t(x), capacity_factor)
    if tgt is None:
        return {"out": out}
    torch.mean((out - _t(tgt)) ** 2).backward()
    return {"out": out, "grads": {k: p.grad for k, p in local.items()}}
