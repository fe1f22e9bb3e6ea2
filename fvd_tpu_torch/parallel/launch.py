"""Start ``n`` ranks under ``torch.distributed`` and run programs on them.

A :class:`RankGroup` spawns ``n`` processes (the ``spawn`` start method: the
caller may hold threads, CUDA or JAX state that a fork would copy), each of
which joins one process group through a ``FileStore`` in a directory the
caller names, so no TCP port is shared between concurrent groups.  The
caller picks the backend (``"gloo"`` or ``"nccl"``) and each rank's device;
the code never switches either.  :meth:`RankGroup.run` hands every rank the
same program, a function importable by path (the ranks import it by name,
so define it in a module that imports no JAX), and returns each rank's
result with tensors as numpy arrays.

Failure ends the group: a rank that raises, exits or misses the deadline of
:meth:`RankGroup.run` gets every rank killed (the others may be waiting in a
collective) and the parent raises.  The process group also carries its own
``timeout``, so a collective that hangs fails in the rank.  Ranks run
torch on one thread: several groups on one host share its cores.

    with RankGroup(4, "gloo", "cpu", store_dir) as group:
        results = group.run(module.program, *args)   # one result per rank
"""

from __future__ import annotations

import datetime
import os
import queue
import time
import traceback
import uuid
from typing import Any, Callable, List, Optional, Sequence, Union

#: this rank's device, set in each rank before its programs run
_DEVICE = None
#: seconds the ranks may take to start and join the process group
START_TIMEOUT = 180.0


def rank_device():
    """The device of the calling rank (as named by its :class:`RankGroup`)."""
    if _DEVICE is None:
        raise RuntimeError("rank_device() is only defined inside a rank of a RankGroup")
    return _DEVICE


def to_host(value):
    """``value`` with every tensor as a numpy array, through tuples, lists and
    dicts."""
    import torch

    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, (list, tuple)):
        return type(value)(to_host(v) for v in value)
    if isinstance(value, dict):
        return {k: to_host(v) for k, v in value.items()}
    return value


def _rank_main(rank, world, backend, device, store_path, pg_timeout_s, tasks, results):
    global _DEVICE
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        _DEVICE = torch.device(device)
        if _DEVICE.type == "cuda":
            torch.cuda.set_device(_DEVICE)
        store = dist.FileStore(store_path, world)
        kwargs = {"device_id": _DEVICE} if backend == "nccl" else {}
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=pg_timeout_s), **kwargs)
    except Exception:  # report and end this rank; the parent kills the group
        results.put((rank, "error", traceback.format_exc()))
        return
    results.put((rank, "ready", None))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                out = ("ok", to_host(fn(*args)))
            except Exception:  # the parent raises it and ends the group
                out = ("error", traceback.format_exc())
            results.put((rank,) + out)
            if out[0] == "error":
                break
    finally:
        dist.destroy_process_group()


class RankGroup:
    """``n`` ranks of one process group; see the module docstring.

    ``device``: one device for every rank (e.g. ``"cpu"``, or ``"cuda:0"``
    for ranks sharing one card, which NCCL refuses and gloo takes) or one per
    rank.  ``timeout``: seconds the process group waits in a collective, and
    the default deadline of :meth:`run`.
    """

    def __init__(self, n: int, backend: str, device: Union[str, Sequence[str]], store_dir: str,
                 timeout: float = 120.0):
        import multiprocessing as mp

        devices = [str(device)] * n if isinstance(device, str) else [str(d) for d in device]
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} ranks")
        os.makedirs(store_dir, exist_ok=True)
        self.n, self.backend, self.devices, self.timeout = n, backend, devices, timeout
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(n)]
        store = os.path.join(store_dir, f"store-{uuid.uuid4().hex}")
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, n, backend, devices[r], store, timeout, self._tasks[r], self._results))
                       for r in range(n)]
        self._closed = False
        for p in self._procs:
            p.start()
        try:
            self._collect("ready", START_TIMEOUT)
        except BaseException:
            self.kill()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _collect(self, kind: str, timeout: float) -> List[Any]:
        """One message of ``kind`` from each rank, in rank order; kills the
        group and raises on an error, a dead rank or the deadline."""
        got = {}
        deadline = time.monotonic() + timeout
        while len(got) < self.n:
            try:
                rank, status, value = self._results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if r not in got and p.exitcode is not None]
                if dead:
                    self.kill()
                    raise RuntimeError(f"ranks {dead} of {self.n} exited "
                                       f"(exit codes {[self._procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    self.kill()
                    raise TimeoutError(f"{self.n - len(got)} of {self.n} ranks ({self.backend}) gave no "
                                       f"{kind!r} within {timeout:.0f} s")
                continue
            if status == "error":
                self.kill()
                raise RuntimeError(f"rank {rank} of {self.n} ({self.backend}, {self.devices[rank]}) failed:\n{value}")
            got[rank] = value
        return [got[r] for r in range(self.n)]

    def run(self, fn: Callable, *args, timeout: Optional[float] = None) -> List[Any]:
        """``fn(*args)`` on every rank; each rank's result, in rank order."""
        if self._closed:
            raise RuntimeError("this RankGroup is closed")
        for q in self._tasks:
            q.put((fn, args))
        return self._collect("ok", self.timeout if timeout is None else timeout)

    def kill(self) -> None:
        self._closed = True
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)

    def close(self, timeout: float = 30.0) -> None:
        """Ask every rank to leave its process group and exit; kill what is
        left at the deadline."""
        if self._closed:
            return
        self._closed = True
        for q in self._tasks:
            q.put(None)
        deadline = time.monotonic() + timeout
        for p in self._procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        self.kill()

