"""Expert parallelism (GShard-style top-1 MoE) over an ``expert`` mesh axis:
the counterpart of ``fvd_tpu/parallel/experts.py``.

A mixture-of-experts FFN whose expert weights live on the rank that owns
them, ``E / ep`` experts a rank, with capacity-bounded dispatch and combine
matrices.  The routing (gate softmax, top-1 assignment, per-expert queue
slots) is tiny and runs replicated on every rank over the whole batch, so
queue slots follow token order as in the dense oracle.  The tokens are
sharded: each rank dispatches its own rows, one ``all_to_all`` carries each
expert's slab to its owner (each slot is filled by one token of one rank, so
the owner sums what arrives), the owner runs its experts, and a second
``all_to_all`` brings each rank the outputs of the slots its tokens took.
Both are ``torch.distributed.nn.functional.all_to_all``, whose backward runs
the same exchange in reverse.  The combined rows are gathered into a
replicated ``[B, D]``.

The output is replicated and every rank computes the same loss of it; the
gather's backward hands each rank the gradient of its own rows, and the
replicated inputs (the tokens and the gate) sum their per-rank gradients over
the axis, so every rank ends with the full gradient of its parameters.

Overflow tokens beyond an expert's capacity contribute zero (the top-1 drop
policy); callers keep a residual connection so dropped tokens pass through.
GELU is the tanh form (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from fvd_tpu_torch.parallel.mesh import Mesh


def init_moe_params(rng: np.random.RandomState, n_experts: int, d_model: int, d_hidden: int,
                    device=None) -> Dict[str, torch.Tensor]:
    """Gate + stacked expert-MLP weights (``[E, ...]`` leading expert axis),
    drawn from ``rng`` with JAX's scales: ``N(0, 1) / sqrt(fan_in)``, zero
    biases."""
    s1, s2 = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_hidden)
    arrays = {
        "gate": rng.randn(d_model, n_experts) * s1,
        "w1": rng.randn(n_experts, d_model, d_hidden) * s1,
        "b1": np.zeros((n_experts, d_hidden)),
        "w2": rng.randn(n_experts, d_hidden, d_model) * s2,
        "b2": np.zeros((n_experts, d_model)),
    }
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}


def _capacity(batch: int, n_experts: int, capacity_factor: float) -> int:
    return max(1, int(math.ceil(batch / n_experts * capacity_factor)))


def _routing(x: torch.Tensor, gate_w: torch.Tensor, n_experts: int, capacity: int):
    """-> (dispatch ``[B, E, C]`` 0/1, combine ``[B, E, C]`` gate-weighted).

    Top-1 GShard routing: each token goes to its argmax expert (the first on
    ties) if that expert's queue (in token order) has room, else it is
    dropped."""
    probs = torch.softmax(x @ gate_w, dim=-1)                    # [B, E]
    top = torch.argmax(probs, dim=-1)                           # first max on ties
    p_top = probs.gather(-1, top[:, None])[:, 0]
    onehot = F.one_hot(top, n_experts).to(x.dtype)              # [B, E]
    pos = torch.cumsum(onehot, dim=0) - onehot                  # queue slot
    keep = onehot * (pos < capacity)
    # a slot past the capacity one-hots to nothing, as jax.nn.one_hot does
    slot = F.one_hot(pos.long().clamp(max=capacity), capacity + 1)[..., :capacity].to(x.dtype)
    dispatch = keep[:, :, None] * slot                          # [B, E, C]
    return dispatch, dispatch * p_top[:, None, None]


def _experts(w1, b1, w2, b2, xin):
    """The expert MLPs over a slab ``[e, C, D]`` of experts' inputs."""
    h = F.gelu(torch.einsum("ecd,edh->ech", xin, w1) + b1[:, None], approximate="tanh")
    return torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None]


def moe_forward_dense(params, x: torch.Tensor, capacity_factor: float = 1.25) -> torch.Tensor:
    """Single-device reference with identical routing (the equality oracle)."""
    n_experts = params["gate"].shape[-1]
    dispatch, combine = _routing(x, params["gate"], n_experts, _capacity(x.shape[0], n_experts, capacity_factor))
    ex_in = torch.einsum("bd,bec->ecd", x, dispatch)
    ex_out = _experts(params["w1"], params["b1"], params["w2"], params["b2"], ex_in)
    return torch.einsum("ecd,bec->bd", ex_out, combine)


class _Replicated(torch.autograd.Function):
    """Identity on a value every rank holds; backward: the sum over the axis
    of each rank's partial gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), ctx.axis), None, None


class _GatherRows(torch.autograd.Function):
    """Rows of each rank -> all rows, replicated; backward: this rank's rows
    of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.rows = (mesh.index(axis) * x.shape[0], x.shape[0])
        return mesh.all_gather(x.contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        lo, n = ctx.rows
        return g[lo:lo + n], None, None


def local_experts(params, mesh: Mesh, axis: str = "expert") -> Dict[str, torch.Tensor]:
    """``params`` with the expert weights cut to this rank's ``E / ep``
    experts (the gate stays whole): what a rank of :func:`moe_forward`
    holds."""
    ep, i = mesh.shape[axis], mesh.index(axis)
    per = params["gate"].shape[-1] // ep
    return {k: (v if k == "gate" else v[i * per:(i + 1) * per]) for k, v in params.items()}


def moe_forward(mesh: Mesh, params, x: torch.Tensor, capacity_factor: float = 1.25,
                axis: str = "expert") -> torch.Tensor:
    """Token batch ``x [B, D]`` (the same on every rank) through the
    expert-parallel MoE FFN; ``params`` holds this rank's experts
    (:func:`local_experts`).  Returns ``[B, D]`` on every rank, equal to
    :func:`moe_forward_dense` up to reduction order.  E and B must divide by
    the axis size."""
    ep, me = mesh.shape[axis], mesh.index(axis)
    per = params["w1"].shape[0]
    n_experts = params["gate"].shape[-1]
    B = x.shape[0]
    if n_experts != per * ep:
        raise ValueError(f"{n_experts} experts not divisible by ep={ep}")
    if B % ep:
        raise ValueError(f"batch {B} not divisible by ep={ep}")
    x = _Replicated.apply(x, mesh, axis)
    gate = _Replicated.apply(params["gate"], mesh, axis)
    dispatch, combine = _routing(x, gate, n_experts, _capacity(B, n_experts, capacity_factor))
    rows = slice(me * (B // ep), (me + 1) * (B // ep))
    # my tokens' contributions to every expert's slab, sent to the owners
    ex_in = torch.einsum("bd,bec->ecd", x[rows], dispatch[rows])         # [E, C, D]
    slab = sum(mesh.all_to_all(list(ex_in.split(per)), axis))           # [E/ep, C, D]
    ex_out = _experts(params["w1"], params["b1"], params["w2"], params["b2"], slab)
    # each rank gets the outputs of the slots its tokens took
    taken = dispatch.reshape(ep, B // ep, ep, per, -1).sum(dim=1)[:, me]  # [ep, E/ep, C]
    back = mesh.all_to_all([ex_out * taken[r][..., None] for r in range(ep)], axis)
    out_rows = torch.einsum("ecd,bec->bd", torch.cat(back), combine[rows])
    return _GatherRows.apply(out_rows, mesh, axis)
