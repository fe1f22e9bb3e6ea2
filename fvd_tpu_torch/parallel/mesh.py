"""Device meshes and the collectives over their axes: the counterpart of
``fvd_tpu/parallel/mesh.py``.

A :class:`Mesh` is a named grid, as ``jax.sharding.Mesh`` is:

* ``data``  — videos / frame batches (DP);
* ``time``  — the sample axis of per-video signal tracks (SP, the lip-sync
  halo exchange);
* and, built with :func:`axis_mesh`, ``model`` (TP), ``stage`` (PP) and
  ``expert`` (EP).

JAX's one mesh covers two mechanisms, and the port gives each its torch form:

* **In one process** (sharded inference, :mod:`.inference`): the grid holds
  ``torch.device`` entries, and a batch is split over the ``data`` devices.
* **One rank per grid entry** (the ``shard_map`` programs of
  :mod:`.pipeline`, :mod:`.tensor`, :mod:`.stages`, :mod:`.experts`): under an
  initialised process group the grid holds ranks, the mesh carries the
  ``DeviceMesh`` of ``init_device_mesh`` with the JAX axis names and one
  process group per axis, and the collectives below run on those groups.  A
  mesh smaller than the world takes ranks ``0..size-1``; the other ranks
  build it too (group creation is collective) and are not :attr:`Mesh.active`.

Gloo takes host tensors for every collective, and CUDA tensors for some:
all-reduce and all-gather take them, point-to-point sends abort the rank
and all-to-all raises (``tests/test_torch_cuda.py``
``test_gloo_collectives_on_card_tensors``).  Where gloo took them, its own
CUDA path was slower than copying by hand on an H100 (PERF.md), so
on the gloo backend every collective copies a CUDA tensor to host memory and
its result back, explicitly; NCCL takes the CUDA tensors as they are.
Nothing here switches backend or device on failure.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def visible_devices() -> List[torch.device]:
    """Every visible card; raises where there is none (``devices`` must then
    be named, e.g. ``["cpu"] * 4``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card to place the mesh on; "
                           "name its devices (e.g. devices=['cpu'] * 4)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def check_devices(devices: Sequence) -> List[torch.device]:
    """``devices`` as ``torch.device`` entries in the form tensors report
    (``cuda:i`` with its index, ``cpu`` without one); raises for a card that
    is not present."""
    out = []
    for d in map(torch.device, devices):
        if d.type == "cuda":
            if not torch.cuda.is_available() or (d.index or 0) >= torch.cuda.device_count():
                raise RuntimeError(f"device {d} was asked for but only {torch.cuda.device_count()} CUDA "
                                   "devices are visible")
            d = torch.device("cuda", d.index if d.index is not None else torch.cuda.current_device())
        elif d.type == "cpu":
            d = torch.device("cpu")
        out.append(d)
    return out


class Mesh:
    """A named device grid.  ``devices`` is the grid (``torch.device``
    entries in one process, ranks under a process group); ``device_mesh``
    the ``DeviceMesh`` of a rank program, else ``None``."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...], device_mesh=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.device_mesh = device_mesh
        self.backend = dist.get_backend() if device_mesh is not None else None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def active(self) -> bool:
        """Whether this rank is in the grid (always, in one process)."""
        return self.device_mesh is None or self.device_mesh.get_coordinate() is not None

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        return int(self.device_mesh.get_local_rank(axis))

    # ---------------------------------------------------------- collectives
    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` for NCCL, a host copy of it for gloo."""
        return t.cpu() if self.backend == "gloo" else t

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over ``axis`` (``lax.psum``), on ``t``'s device."""
        # a dense copy: the ranks' buffers must share one layout element for element
        buf = self._stage(t).clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group(axis))
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``[k, ...]`` from each rank of ``axis`` -> ``[n * k, ...]`` in
        coordinate order (``lax.all_gather`` then a reshape)."""
        src = self._stage(t).contiguous()
        out = torch.empty((self.shape[axis] * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out, src, group=self.group(axis))
        return out.to(t.device)

    def ppermute(self, t: torch.Tensor, axis: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``lax.ppermute``: for each ``(src, dst)`` coordinate pair along
        ``axis`` the rank at ``dst`` receives ``t`` of the rank at ``src``;
        a rank that no pair sends to gets zeros.  One ``batch_isend_irecv``
        of the point-to-point sends."""
        me = self.index(axis)
        ranks = dist.get_process_group_ranks(self.group(axis))
        src = self._stage(t).contiguous()
        out = torch.zeros_like(src)
        ops = []
        for s, d in perm:
            if s == me and d == me:
                out.copy_(src)
            elif s == me:
                ops.append(dist.P2POp(dist.isend, src, ranks[d]))
            elif d == me:
                ops.append(dist.P2POp(dist.irecv, out, ranks[s]))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out.to(t.device)

    def all_to_all(self, chunks: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
        """Chunk ``j`` goes to coordinate ``j`` of ``axis``; returns the chunk
        each coordinate sent here.  Differentiable
        (``torch.distributed.nn.functional.all_to_all``): the gradient goes
        back the same way."""
        from torch.distributed.nn.functional import all_to_all

        dev = chunks[0].device
        src = [self._stage(c).contiguous() for c in chunks]
        outs = all_to_all([torch.empty_like(c) for c in src], src, group=self.group(axis))
        return [o.to(dev) for o in outs]


def _grid_mesh(shape: Sequence[int], names: Sequence[str], devices) -> Mesh:
    """A mesh of ``shape`` over ``devices`` in one process, or over ranks
    ``0..prod(shape)-1`` of the initialised process group when ``devices``
    is None there."""
    need = int(np.prod(shape))
    label = "x".join(str(s) for s in shape)
    if devices is None and dist.is_available() and dist.is_initialized():
        total = dist.get_world_size()
        if need > total:
            raise ValueError(f"mesh {label} needs {need} devices, have {total}")
        from torch.distributed.device_mesh import init_device_mesh

        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        dm = init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))
        return Mesh(np.arange(need).reshape(shape), names, dm)
    devices = check_devices(devices) if devices is not None else visible_devices()
    if need > len(devices):
        raise ValueError(f"mesh {label} needs {need} devices, have {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(shape), names, None)


def make_mesh(
    n_data: Optional[int] = None,
    n_time: int = 1,
    devices: Optional[Sequence] = None,
    data_axis: str = "data",
    time_axis: str = "time",
) -> Mesh:
    """A ``(data, time)`` mesh.  ``devices`` defaults to every visible card,
    or to the ranks of the process group where one is initialised;
    ``n_data`` defaults to all of them over ``n_time``."""
    if devices is None and dist.is_available() and dist.is_initialized():
        total = dist.get_world_size()
    else:
        devices = check_devices(devices) if devices is not None else visible_devices()
        total = len(devices)
    if n_data is None:
        if total % n_time != 0:
            raise ValueError(f"{total} devices not divisible by time={n_time}")
        n_data = total // n_time
    return _grid_mesh((n_data, n_time), (data_axis, time_axis), devices)


def axis_mesh(axis: str, size: int, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh of ``size`` along ``axis`` (``Mesh(devices[:size],
    (axis,))``): the ``model``, ``stage`` and ``expert`` meshes."""
    return _grid_mesh((size,), (axis,), devices)
