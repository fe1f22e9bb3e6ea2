"""Time the C1 stage, ``lip_sync_score_batch``, on the card, and count the
device ops one call dispatches.

    python3 fvd_tpu_torch/c1_timing.py [--tree DIR]

Prints one JSON line per shape of :data:`SHAPES`, and one for the analyzer's
single-video call: the median milliseconds of 50 CUDA-event-fenced calls
after warm-up (what a caller pays), the device time per call of 100 calls
replayed from one CUDA graph (:func:`graph_ms`), the device ops one call
dispatched
(counted by :class:`DeviceOpCounter`) and the kernel launches it made.  With
``--tree`` it times the ``fvd_tpu_torch`` package of another checkout, for
example an older commit unpacked with ``git archive``, so that two versions
can be compared in one run on one card.  ``chip_smoke.py`` uses the shapes
and the helpers here.  Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: (case, batch, n, fps, kind): the analyzer's and the serving batch's shapes,
#: the DAG node's (60 s, coalesced groups of 64 and of the program
#: coalescer's 16, 10 min; all at 30 fps), a short signal, silent and static
#: rows, and a row whose window scores tie
SHAPES = [
    ("entry: 1x50 @5fps, W25 L2, 3 windows", 1, 50, 5.0, "speech"),
    ("30fps 10s: 1x300, W150 L15", 1, 300, 30.0, "speech"),
    ("short: 1x40 @30fps < W150, norm_div 150", 1, 40, 30.0, "speech"),
    ("silent and static: 3x300 @30fps", 3, 300, 30.0, "silent"),
    ("serving: 64x50 @5fps", 64, 50, 5.0, "speech"),
    ("DAG 60s: 1x1800 @30fps, 23 windows", 1, 1800, 30.0, "speech"),
    ("DAG group: 64x1800 @30fps", 64, 1800, 30.0, "speech"),
    ("DAG coalesced group: 16x1800 @30fps (max_total 16)", 16, 1800, 30.0, "speech"),
    ("DAG 10min: 1x18000 @30fps, 239 windows", 1, 18000, 30.0, "speech"),
    ("ties: 2x600 @30fps, repeating windows", 2, 600, 30.0, "ties"),
]


def make_signals(batch: int, n: int, fps: float, kind: str, rng: np.random.RandomState):
    """Raw ``(mouth, audio)`` float32 ``[batch, n]``.

    ``speech``: an audio envelope gated at 2 Hz plus noise; even rows' mouth
    follows it 0.1 s late, odd rows' mouth is noise.  ``silent``: row 0's
    audio and row 1's mouth are constant, row 2's audio is constant over its
    first window.  ``ties``: both signals repeat with the window hop, so
    every window of row 0 scores the same; row 1's mouth is noise."""
    t = np.arange(n) / fps
    if kind == "ties":
        hop = max(int(5.0 * fps) // 2, 1)
        audio = np.tile(rng.rand(batch, hop), (1, -(-n // hop)))[:, :n]
        mouth = audio.copy()
        mouth[1::2] = rng.rand(len(mouth[1::2]), n)
        return mouth.astype(np.float32), audio.astype(np.float32)
    phase = rng.rand(batch, 1) * 2 * np.pi
    audio = np.clip(0.5 * (1 + np.sin(2 * np.pi * 2 * t + phase)) + 0.1 * rng.rand(batch, n), 0, 1)
    mouth = np.roll(audio, int(0.1 * fps), axis=1) + 0.05 * rng.rand(batch, n)
    mouth[1::2] = rng.rand(len(mouth[1::2]), n)
    if kind == "silent":
        audio[0] = 0.25
        mouth[1] = 0.5
        audio[2, :min(int(5.0 * fps), n)] = 0.125
    return mouth.astype(np.float32), audio.astype(np.float32)


class DeviceOpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched inside it that do device work: views
    and ``empty`` (an allocation from the caching allocator) are left out.
    Kernels launched through ctypes are not aten ops and are not counted."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if not func.is_view and not name.startswith("aten.empty"):
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


def count_device_ops(fn) -> collections.Counter:
    """The device ops one call of ``fn()`` dispatches."""
    with DeviceOpCounter() as counter:
        fn()
    return counter.ops


def interleaved_ms(fns: dict, warmup: int = 5, rounds: int = 50) -> dict:
    """Median milliseconds per call of each ``fns[name]()`` on the card, each
    call fenced by CUDA events: the time a caller pays per call, host work
    included where the card waits for it.  Each round calls every function
    once, in an order that rotates from round to round, so drift in the
    host's speed falls on all of them alike."""
    names = list(fns)
    for _ in range(warmup):
        for name in names:
            fns[name]()
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def graph_ms(fn, reps: int = 100, replays: int = 10) -> float:
    """Device milliseconds per call of ``fn()``: ``reps`` calls captured in
    one CUDA graph, the median of ``replays`` CUDA-event-timed replays divided
    by ``reps``.  No host work is left in a replay, so this is the kernel
    time plus the graph's gap between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="root of the checkout whose fvd_tpu_torch is timed (default: this one)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("c1_timing: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.ops.lipsync import lip_sync_score, lip_sync_score_batch

    rng = np.random.RandomState(0)
    cases = []
    for case, batch, n, fps, kind in SHAPES:
        mouth, audio = (torch.from_numpy(x).cuda() for x in make_signals(batch, n, fps, kind, rng))
        cases.append((case, lambda m=mouth, a=audio, f=fps: lip_sync_score_batch(m, a, f)))
        if case.startswith("entry"):  # the analyzer's own call: one video's [N] pair
            cases.append(("entry, one [N] pair through lip_sync_score",
                          lambda m=mouth[0], a=audio[0], f=fps: lip_sync_score(m, a, f)))
    for case, stage in cases:
        stage()
        torch.cuda.synchronize()
        before = sum(_kernels.LAUNCHES.values())
        ops = count_device_ops(stage)
        launches = sum(_kernels.LAUNCHES.values()) - before
        print(json.dumps({"case": case, "tree": args.tree, "ms": interleaved_ms({"ms": stage})["ms"],
                          "device_ms": graph_ms(stage), "device_ops": sum(ops.values()),
                          "launches": launches,
                          "ops": dict(ops)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
