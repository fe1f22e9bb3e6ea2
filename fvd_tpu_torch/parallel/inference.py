"""Data-parallel sharded inference for batched model forwards: the
counterpart of ``fvd_tpu/parallel/inference.py``.

Any batched forward whose items are independent (detector frames, landmark
and pose crops, OCR images) can split its leading batch dimension over the
``data`` axis of an in-process :class:`~fvd_tpu_torch.parallel.mesh.Mesh`.
Where JAX places the batch with a sharding and lets the jitted program run
SPMD, the port does it in one process by hand: each shard goes to its
device, runs the forward there on that device's replica of the model, and
the results are concatenated on the input's device.

Usage: ``set_inference_mesh(make_mesh(n_data=len(devices), devices=devices))``
once; providers call their forwards through :func:`shard_for_inference`.
With no mesh, a 1-device mesh or a batch that does not divide by the
``data`` size, the forward runs as it would without one: same call, same
device, same results.  The cross-video coalescing buckets are powers of two,
so coalesced batches divide over any power-of-two mesh.
"""

from __future__ import annotations

import copy
import threading
import weakref
from typing import Callable, Optional

import torch
import torch.nn as nn

_lock = threading.Lock()
_inference_mesh = None
_replicas: "weakref.WeakKeyDictionary[nn.Module, dict]" = weakref.WeakKeyDictionary()


def set_inference_mesh(mesh) -> Optional[object]:
    """Install the mesh used for sharded batched inference; returns the
    previous one (``None`` disables)."""
    global _inference_mesh
    with _lock:
        prev = _inference_mesh
        _inference_mesh = mesh
    return prev


def get_inference_mesh():
    return _inference_mesh


def replica(model: nn.Module, device: torch.device) -> nn.Module:
    """``model`` on ``device``: the model itself where it already lives
    there, else a copy made on first use and kept (it does not follow later
    changes to ``model``'s weights)."""
    if next(model.parameters()).device == device:
        return model
    with _lock:
        per = _replicas.setdefault(model, {})
        if device not in per:
            per[device] = copy.deepcopy(model).to(device)
        return per[device]


def _concat(outs, device):
    if isinstance(outs[0], torch.Tensor):
        return torch.cat([o.to(device) for o in outs])
    return type(outs[0])(_concat(list(parts), device) for parts in zip(*outs))


def shard_for_inference(fn: Callable, model: nn.Module, x: torch.Tensor):
    """``fn(model, x)``, with ``x``'s leading dim split over the mesh's
    ``data`` devices when one is installed: ``fn(replica(model, d), x_d)`` per
    device ``d``, the outputs (a tensor or a tuple of tensors, batch-leading)
    concatenated on ``x``'s device."""
    mesh = _inference_mesh
    if mesh is None or mesh.size <= 1:
        return fn(model, x)
    n_data = mesh.shape.get("data", 1)
    if n_data <= 1 or x.shape[0] % n_data != 0:
        return fn(model, x)
    data = mesh.axis_names.index("data")
    devices = mesh.devices.take(range(n_data), axis=data).reshape(n_data, -1)[:, 0]
    outs = [fn(replica(model, d), shard.to(d)) for d, shard in zip(devices, x.chunk(n_data))]
    return _concat(outs, x.device)
