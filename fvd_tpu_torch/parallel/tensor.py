"""Tensor-parallel (TP) sharding for the transformer models: the counterpart
of ``fvd_tpu/parallel/tensor.py``.

Where JAX annotates the flax param tree with Megatron shardings and lets
GSPMD insert the collectives, the port splits the weights by hand and writes
the two all-reduces of each block out.  Per :class:`MHABlock` over mesh axis
``model``, on the port's ``nn.Linear`` layout (``weight`` is ``[out, in]``):

* attention q/k/v weights ``[H * Dh, D]`` and biases shard the *heads*
  (dim 0); the out-projection weight ``[D, H * Dh]`` shards its input side
  (dim 1), so each rank attends with its local heads and the out-projection
  gives a partial sum: one all-reduce, then the replicated out bias;
* the MLP up-projection ``[4D, D]`` and its bias shard the hidden axis, the
  down-projection ``[D, 4D]`` contracts it: one more all-reduce, then the
  replicated down bias;
* embeddings, layer norms and every other parameter stay replicated.

Activations stay replicated, so a TP forward has the single-device shapes and
equals it up to reduction order.  It covers every model built from
:class:`~fvd_tpu_torch.models.transformer.MHABlock`: the text tower, the CLIP
towers and the ASR encoder (a cross-attention block also splits its
cross-attention, with its own all-reduce).

Requires ``heads % tp == 0`` and ``mlp_hidden % tp == 0``.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
import torch.nn as nn

from fvd_tpu_torch.models.transformer import (MHABlock, MultiHeadDotProductAttention, attention_bias,
                                              dot_product_attention)
from fvd_tpu_torch.parallel.mesh import Mesh


def _param_dim(name: str) -> Optional[int]:
    """The dim a parameter of an MHABlock is sharded on, keyed on its
    state-dict name; ``None`` for a replicated one."""
    parts = name.split(".")
    if len(parts) < 2 or not any(p.startswith("MHABlock") for p in parts):
        return None
    mod, leaf = parts[-2], parts[-1]
    attention = len(parts) >= 3 and parts[-3].startswith("MultiHeadDotProductAttention")
    if attention and mod in ("query", "key", "value"):
        return 0
    if attention and mod == "out":
        return 1 if leaf == "weight" else None
    if mod == "Dense_0":
        return 0
    if mod == "Dense_1":
        return 1 if leaf == "weight" else None
    return None


def tp_shardings(model: nn.Module) -> Dict[str, Optional[int]]:
    """``{parameter name: sharded dim or None}`` over ``model``'s state dict:
    the Megatron split this module applies."""
    return {name: _param_dim(name) for name in model.state_dict()}


def validate_tp_divisibility(heads: int, mlp_hidden: int, tp: int) -> None:
    if heads % tp or mlp_hidden % tp:
        raise ValueError(
            f"tensor-parallel degree {tp} must divide heads={heads} "
            f"and mlp_hidden={mlp_hidden}")


def _shard_linear(lin: nn.Linear, dim: int, index: int, parts: int, bias: bool) -> nn.Linear:
    w = lin.weight.detach().chunk(parts, dim=dim)[index]
    out = nn.Linear(w.shape[1], w.shape[0], bias=bias).to(w.device, w.dtype)
    with torch.no_grad():
        out.weight.copy_(w)
        if bias:
            out.bias.copy_(lin.bias.detach().chunk(parts)[index])
    return out


class _RowParallel(nn.Module):
    """The input-sharded half of a Megatron pair: the local partial product,
    one all-reduce over ``model``, then the replicated bias."""

    def __init__(self, lin: nn.Linear, mesh: Mesh, axis: str):
        super().__init__()
        tp, i = mesh.shape[axis], mesh.index(axis)
        self.part = _shard_linear(lin, 1, i, tp, bias=False)
        self.bias = nn.Parameter(lin.bias.detach().clone())
        self.mesh, self.axis = mesh, axis

    def forward(self, x):
        return self.mesh.all_reduce(self.part(x), self.axis) + self.bias


class _TPAttention(nn.Module):
    """``MultiHeadDotProductAttention`` with this rank's ``heads / tp`` heads."""

    def __init__(self, attn: MultiHeadDotProductAttention, mesh: Mesh, axis: str):
        super().__init__()
        tp, i = mesh.shape[axis], mesh.index(axis)
        self.heads = attn.heads // tp
        self.query, self.key, self.value = (_shard_linear(getattr(attn, p), 0, i, tp, bias=True)
                                            for p in ("query", "key", "value"))
        self.out = _RowParallel(attn.out, mesh, axis)

    def forward(self, x, context, mask=None):
        b, tq, _ = x.shape
        h = self.heads
        q = self.query(x).view(b, tq, h, -1)
        k = self.key(context).view(b, context.shape[1], h, -1)
        v = self.value(context).view(b, context.shape[1], h, -1)
        bias = None if mask is None else attention_bias(mask, q.dtype)
        return self.out(dot_product_attention(q, k, v, bias).reshape(b, tq, -1))


def shard_params_tp(model: nn.Module, mesh: Mesh, model_axis: str = "model") -> nn.Module:
    """A copy of ``model`` whose MHABlocks hold this rank's shards and run
    the Megatron forward: same call, same output shapes, two all-reduces per
    block over ``mesh[model_axis]``."""
    tp = mesh.shape[model_axis]
    out = copy.deepcopy(model)
    for block in [m for m in out.modules() if isinstance(m, MHABlock)]:
        attns = [n for n, m in block.named_children() if isinstance(m, MultiHeadDotProductAttention)]
        validate_tp_divisibility(getattr(block, attns[0]).heads, block.Dense_0.out_features, tp)
        for name in attns:
            setattr(block, name, _TPAttention(getattr(block, name), mesh, model_axis))
        block.Dense_0 = _shard_linear(block.Dense_0, 0, mesh.index(model_axis), tp, bias=True)
        block.Dense_1 = _RowParallel(block.Dense_1, mesh, model_axis)
    return out
