"""Interleaved A/B throughput benchmark for the package's environment switches:

    python -m fvd_tpu_torch.tools.ab_bench NAME=VALUE [NAME=VALUE ...] [--passes 8] [--n-videos 8]
        [--duration 30] [--concurrency 8] [--b-first] [--cpu]

The counterpart of the JAX package's ``tools/ab_bench.py``, with its flags.
The time of a pass moves between runs and between machines, so a switch is
never judged from two separate benchmark runs.  This tool runs the batch
harness's overlapped passes over bench.py's real-model corpus with the
switch toggled PER PASS (A/B/A/B...) inside one process: both arms see the
same card, host and moment, and their bests and medians compare like with
like.

The switches are environment assignments set on B passes and removed on A
passes (every switch is read at call time, e.g. ``FVD_TPU_FUSED_DETLM=1``,
``FVD_TPU_NO_FUSED_POSE=1``, ``FVD_TPU_NO_STACK_MEMO=1``,
``FVD_TPU_NO_DEVICE_OCR=1``, ``FVD_TPU_NO_ARTIFACT_CACHE=1``); several given
together toggle as one arm.  The corpus is bench.py's: ``make_face_video``
clips ``clip0..clip{n-1}`` (seeds ``0..n-1``, 320x240 at 30 fps, OpenCV's
shapes) speaking bench's eight sentences in the shipped ASR's domain; the
bundle is ``production_providers(recorded_services=True)`` wrapped by
``coalesce_providers``, with no E1 rate limit and 4 E2 workers.  Both arms
are warmed up first.  The clips and the runs' files go to a temporary
working directory, removed at the end, and the tool returns to the directory
it started in.  Everything runs on the card unless ``--cpu`` is given;
without a card that raises.

Logs go to stderr (the backend, the card's name and power limit as
``nvidia-smi`` prints them, one line a pass, and the nodes' progress lines,
which the JAX tool leaves on stdout); stdout gets one JSON line:
  {"lever": ..., "a_best": ..., "b_best": ..., "a_med": ..., "b_med": ...,
   "speedup_best": ..., "speedup_med": ..., "passes": [...]}
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

from fvd_tpu_torch.batch import run_pipeline_many

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: bench.py's eight sentences (``bench.py:338-347``)
SENTENCES = (
    "the mayor said the city will cut taxes next year",
    "the river level rose two feet after the storm",
    "the new bridge opened to traffic last month",
    "the school board voted to extend the year",
    "the state added nine thousand jobs in july",
    "the court ruled the ban can not take effect",
    "the team won the final game by six points",
    "the museum opened a wing for modern art",
)
FPS = 30.0


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or f"nvidia-smi rc {out.returncode}: {out.stderr.strip()}"


def _corpus(n_videos: int, duration: float, ckpt_dir: str):
    """bench.py's real-model clips in ``media/``, speech in the domain of the
    ASR checkpoint the bundle loads."""
    from fvd_tpu_torch.providers.factory import asr_speech_domain
    from fvd_tpu_torch.synthetic import make_face_video

    renderer = asr_speech_domain(ckpt_dir)
    log(f"generating {n_videos} face videos ({duration}s @ {FPS}fps, {renderer} speech)...")
    speech = "formant_gated" if renderer == "formant" else "tone"
    return [make_face_video("media", name=f"clip{i}", duration=duration, fps=FPS, width=320, height=240, seed=i,
                            speech_text=SENTENCES[i % len(SENTENCES)], speech=speech, opencv=True)
            for i in range(n_videos)]


def _bundle(ckpt_dir: str, device):
    """(providers, config, close): the production bundle with the recorded
    services, wrapped for cross-video coalescing, and bench.py's config."""
    from fvd_tpu_torch.config import EvidenceConfig, default_config
    from fvd_tpu_torch.providers.coalesce import coalesce_providers
    from fvd_tpu_torch.providers.factory import production_providers

    providers = production_providers(checkpoint_dir=ckpt_dir, recorded_services=True, device=device)
    providers, close = coalesce_providers(providers)
    config = dataclasses.replace(default_config(), evidence=EvidenceConfig(rate_limit_s=0.0, max_workers=4))
    return providers, config, close


def _warm(providers, config, video: str, device) -> float:
    """One video through the 16 nodes: the fake probability."""
    from fvd_tpu_torch.graph import build_graph
    from fvd_tpu_torch.runtime.scheduler import Scheduler
    from fvd_tpu_torch.state import State

    return Scheduler(build_graph(config, providers, device=device)).invoke(State(input_path=video)).fake_probability


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("levers", nargs="+", help="NAME=VALUE env levers for the B arm")
    ap.add_argument("--passes", type=int, default=8, help="total interleaved passes (half per arm)")
    ap.add_argument("--n-videos", type=int, default=8)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--b-first", action="store_true", help="start with the lever-ON arm")
    args = ap.parse_args(argv)

    levers = []
    for spec in args.levers:
        name, _, val = spec.partition("=")
        if not name or not val:
            ap.error(f"lever must be NAME=VALUE: {spec!r}")
        levers.append((name, val))

    from fvd_tpu_torch import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    log(f"backend: {device.type}")
    if device.type == "cuda":
        log(f"card: {card_line()}")
    ckpt_dir = os.path.join(REPO, "checkpoints")

    def set_arm(on: bool) -> None:
        for name, val in levers:
            if on:
                os.environ[name] = val
            else:
                os.environ.pop(name, None)

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="fvd_ab_") as work, contextlib.ExitStack() as stack:
        os.chdir(work)
        stack.callback(os.chdir, cwd)
        # the nodes' progress lines are logs too: stdout keeps the JSON line alone
        stack.enter_context(contextlib.redirect_stdout(sys.stderr))
        videos = _corpus(args.n_videos, args.duration, ckpt_dir)
        providers, config, close_coalesce = _bundle(ckpt_dir, device)
        stack.callback(close_coalesce)
        stack.callback(set_arm, False)

        # Warm both arms, so every pass after this runs on warm caches and
        # chosen convolution algorithms.
        for arm_on in (False, True):
            set_arm(arm_on)
            t0 = time.perf_counter()
            p = _warm(providers, config, videos[0], device)
            log(f"warmup arm={'B' if arm_on else 'A'}: {time.perf_counter() - t0:.2f}s p={p:.4f}")

        results = []  # (arm, elapsed)
        for i in range(args.passes):
            arm_on = (i % 2 == 0) == args.b_first
            set_arm(arm_on)
            t0 = time.perf_counter()
            run_pipeline_many(videos, config, providers, concurrency=args.concurrency, device=device)
            elapsed = time.perf_counter() - t0
            vpm = 60.0 / (elapsed / args.n_videos)
            results.append(("B" if arm_on else "A", elapsed))
            log(f"pass {i + 1} arm={'B' if arm_on else 'A'}: {elapsed:.2f}s ({vpm:.1f} videos/min)")

    a = sorted(e for arm, e in results if arm == "A")
    b = sorted(e for arm, e in results if arm == "B")
    out = {
        "lever": " ".join(f"{n}={v}" for n, v in levers),
        "a_best": round(min(a), 2), "b_best": round(min(b), 2),
        "a_med": round(statistics.median(a), 2),
        "b_med": round(statistics.median(b), 2),
        "speedup_best": round(min(a) / min(b), 3),
        "speedup_med": round(statistics.median(a) / statistics.median(b), 3),
        "passes": [[arm, round(e, 2)] for arm, e in results],
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
