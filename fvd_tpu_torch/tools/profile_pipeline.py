"""Per-node pipeline profiler:

    python -m fvd_tpu_torch.tools.profile_pipeline [--duration 30] [--fps 30] [--trace DIR] [--models] [--cpu]

The counterpart of the JAX package's ``tools/profile_pipeline.py``, with
its flags.  It runs the 16-node pipeline twice, a warm-up and then a
measured run, and prints a per-node wall-time table from the structured
tracer (:mod:`fvd_tpu_torch.runtime.tracer`).  The default is hermetic: a
``make_synthetic_video`` clip and the deterministic providers of
``synthetic.hermetic_providers``.  ``--models`` draws a
``make_face_video`` clip and loads the production bundle of
``checkpoints/`` (no LLM, no search); ``--video`` profiles a given raw-RGBA
AVI instead of a synthetic clip.  Everything runs on the card unless
``--cpu`` is given; without a card that raises.

``--trace DIR`` records the measured run with ``torch.profiler`` (the
card's kernels where there is one, the host's ops of every thread, and each
node's span as a ``record_function`` range) and writes it to ``DIR/trace.json`` as a
Chrome trace (``chrome://tracing`` or Perfetto reads it), where the JAX
tool writes a ``jax.profiler`` trace; a relative ``DIR`` is taken from the
directory the tool started in.  The synthetic clip and the run's files go to
a temporary working directory, removed at the end, and the tool returns to
the directory it started in.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def _scratch_cwd():
    """A temporary working directory for the run, left and removed at the end."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="fvd_profile_") as work:
        os.chdir(work)
        try:
            yield work
        finally:
            os.chdir(cwd)


def main(argv=None) -> dict:
    """-> {"total_s", "fake_probability", "summary": {span: seconds},
    "trace": path or None}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--video", help="profile a real video instead of synthetic")
    ap.add_argument("--trace", help="directory for a torch.profiler trace")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--models", action="store_true", help="real-model path: face video + trained checkpoints")
    args = ap.parse_args(argv)

    from fvd_tpu_torch import resolve_device
    from fvd_tpu_torch.synthetic import make_face_video, make_synthetic_video

    device = resolve_device("cpu" if args.cpu else "cuda")
    trace_dir = os.path.abspath(args.trace) if args.trace else None   # before the chdir below
    print(f"backend: {device.type}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    with contextlib.nullcontext() if args.video else _scratch_cwd():
        if args.video:
            video = os.path.abspath(args.video)
        else:
            make = make_face_video if args.models else make_synthetic_video
            video = make("media", duration=args.duration, fps=args.fps, width=args.width, height=args.height)
        return _profile(args, device, video, trace_dir)


def _profile(args, device, video, trace_dir) -> dict:
    """A warm-up and a measured run of the 16 nodes on ``video``, the table
    printed -> :func:`main`'s result."""
    from fvd_tpu_torch.config import EvidenceConfig, default_config
    from fvd_tpu_torch.graph import build_graph
    from fvd_tpu_torch.runtime.scheduler import Scheduler
    from fvd_tpu_torch.runtime.tracer import Tracer, get_tracer, set_tracer
    from fvd_tpu_torch.state import State
    from fvd_tpu_torch.synthetic import hermetic_providers

    config = dataclasses.replace(default_config(), evidence=EvidenceConfig(rate_limit_s=0.0, max_workers=4))
    if args.models:
        from fvd_tpu_torch.providers.factory import production_providers

        providers = production_providers(checkpoint_dir=os.path.join(REPO, "checkpoints"), use_llm=False,
                                         use_search=False, device=device)
    else:
        providers = hermetic_providers(fps=args.fps, device=device)
    dag = build_graph(config, providers, device=device)

    print("warmup (compiling)...")
    t0 = time.perf_counter()
    Scheduler(dag).invoke(State(input_path=video))
    print(f"warmup: {time.perf_counter() - t0:.2f}s")

    previous = get_tracer()
    tracer = set_tracer(Tracer(use_profiler_annotations=bool(args.trace)))
    recording = contextlib.nullcontext()
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        from torch._C._profiler import _ExperimentalConfig

        # every thread's host ops: the scheduler runs each node in a pool thread
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        recording = profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True))
    try:
        with recording as prof:
            t0 = time.perf_counter()
            final = Scheduler(dag).invoke(State(input_path=video))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            total = time.perf_counter() - t0
    finally:
        set_tracer(previous)
    trace = None
    if args.trace:
        os.makedirs(trace_dir, exist_ok=True)
        trace = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"device trace written to {args.trace}")

    summary = tracer.summary()
    print(f"\ntotal wall: {total:.3f}s   fake_probability={final.fake_probability}")
    print(f"{'node':14s} {'wall s':>8s} {'% of total':>11s}")
    for name, secs in sorted(summary.items(), key=lambda kv: -kv[1]):
        print(f"{name:14s} {secs:8.3f} {100 * secs / total:10.1f}%")
    print("(concurrent nodes overlap: per-node times can sum past the total)")
    return {"total_s": total, "fake_probability": final.fake_probability, "summary": summary, "trace": trace}


if __name__ == "__main__":
    main()
