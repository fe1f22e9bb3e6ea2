"""Pipeline parallelism (GPipe-style) over a homogeneous layer stack: the
counterpart of ``fvd_tpu/parallel/stages.py``.

Each rank of a ``stage`` mesh axis holds ONE layer's weights; microbatches
stream through the ring with a point-to-point activation hand-off per step.
A stack of S layers over M microbatches completes in ``M + S - 1`` steps (the
fill/drain bubble) while only ``1/S`` of the weights live on each device.

The schedule is JAX's step for step: at step ``t`` stage 0 takes microbatch
``t`` (clamped), every stage applies its layer, the last stage's result is
microbatch ``t - (S - 1)`` when that is in range, and the activations move
one stage along the ring.  The hand-off is a ``torch.autograd.Function``
whose backward sends the gradient back the other way round the ring (the
transpose of ``ppermute``), so a loss on the output trains the stack.  The
output is replicated: the last stage's emissions are summed over the ring
(``lax.psum``), and since every rank then holds the same loss, that sum's
backward hands each rank the gradient unchanged.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from fvd_tpu_torch.parallel.mesh import Mesh


class _RingShift(torch.autograd.Function):
    """``mesh.ppermute(x, axis, perm)``; backward: the inverse permutation."""

    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return mesh.ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.ppermute(g.contiguous(), ctx.axis, [(d, s) for s, d in ctx.perm]), None, None, None


class _SumReplicated(torch.autograd.Function):
    """All-reduce sum into a replicated value; backward: identity (every rank
    holds the same loss of the replicated value).

    ``ties`` (the ring's hand-offs on this rank) get a zero gradient: that
    puts every hand-off of every rank on its rank's backward path, so every
    rank runs every reverse hand-off, in the same order, and the gradients
    of the other stages, which reach a rank only through them, arrive."""

    @staticmethod
    def forward(ctx, x, mesh, axis, *ties):
        ctx.tie_shapes = [(t.shape, t.dtype, t.device) for t in ties]
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        zeros = [torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.tie_shapes]
        return (g, None, None, *zeros)


def pipeline_forward(mesh: Mesh, layer_apply: Callable, stage_params, microbatches: torch.Tensor,
                     axis: str = "stage") -> torch.Tensor:
    """Run ``microbatches`` ``[M, B, D]`` through ``S`` layers, one per rank.

    ``layer_apply(params_i, x) -> y`` applies ONE layer and keeps the
    activation shape; ``stage_params`` is THIS rank's layer (row
    ``mesh.index(axis)`` of :func:`stack_layer_params`).  Returns ``[M, B,
    D]`` on every rank: the stack's output per microbatch, equal to applying
    layers ``0..S-1`` in turn up to reduction order."""
    S = mesh.shape[axis]
    M = microbatches.shape[0]
    s = mesh.index(axis)
    ring = [(i, (i + 1) % S) for i in range(S)]   # stage i -> i+1
    act = torch.zeros_like(microbatches[0])
    emitted, hand_offs = [], []
    for t in range(M + S - 1):
        # stage 0 ingests microbatch t (clamped; out-of-range fill/drain
        # slots are never emitted)
        x_in = microbatches[min(t, M - 1)] if s == 0 else act
        y = layer_apply(stage_params, x_in)
        # the LAST stage's result at step t is microbatch t-(S-1)
        if s == S - 1 and 0 <= t - (S - 1) < M:
            emitted.append(y)
        act = _RingShift.apply(y, mesh, axis, ring)
        hand_offs.append(act)
    out = torch.stack(emitted) if emitted else torch.zeros_like(microbatches)
    return _SumReplicated.apply(out, mesh, axis, *hand_offs)


def stack_layer_params(params_list: Sequence):
    """``[params_0, ..., params_{S-1}]`` (tuples or dicts of tensors of the
    same structure) -> the same structure of stacked ``[S, ...]`` tensors;
    row ``i`` is layer ``i``, the row :func:`pipeline_forward` runs on stage
    ``i``."""
    first = params_list[0]
    if isinstance(first, dict):
        return {k: torch.stack([p[k] for p in params_list]) for k in first}
    return type(first)(torch.stack(leaves) for leaves in zip(*params_list))


def stage_row(stacked, i: int):
    """Row ``i`` of :func:`stack_layer_params`' output: layer ``i``."""
    if isinstance(stacked, dict):
        return {k: v[i] for k, v in stacked.items()}
    return type(stacked)(v[i] for v in stacked)


def asr_encoder_pp(encoder, mel: torch.Tensor, mesh: Mesh, microbatches: int = 0,
                   axis: str = "stage") -> torch.Tensor:
    """The ASR encoder (``models/asr.py`` :class:`AsrEncoder`) with its
    transformer block stack pipeline-parallel over ``mesh[axis]``: the conv
    frontend, positions and final LayerNorm run replicated, block ``i`` on
    stage ``i`` through :func:`pipeline_forward`.  Output equals
    ``encoder(mel)``.

    ``mel``: [B, T, 80]; the batch is split into ``microbatches`` groups
    (default: the stage count) to fill the pipeline."""
    from fvd_tpu_torch.models.asr import _positions
    from fvd_tpu_torch.models.transformer import gelu

    S = mesh.shape[axis]
    if encoder.depth != S:
        raise ValueError(f"one block per stage: depth={encoder.depth} vs stage={S}")
    x = gelu(encoder.Conv_0(mel.transpose(1, 2)))
    x = gelu(encoder.Conv_1(x)).transpose(1, 2)
    x = x + _positions(x.shape[1], encoder.dim, x.device)

    M = microbatches or S
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    xs = x.reshape(M, B // M, *x.shape[1:])
    block = getattr(encoder, f"MHABlock_{mesh.index(axis)}")
    ys = pipeline_forward(mesh, lambda blk, a: blk(a), block, xs, axis=axis)
    return encoder.LayerNorm_0(ys.reshape(B, *ys.shape[2:]))

