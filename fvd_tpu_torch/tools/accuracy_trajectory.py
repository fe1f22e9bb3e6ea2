"""Record the end-to-end accuracy trajectory under online LR training:

    python -m fvd_tpu_torch.tools.accuracy_trajectory --workdir traj --runs 10
    python -m fvd_tpu_torch.tools.accuracy_trajectory --cpu --runs 3 --baseline-eval --hard-reals 4

The counterpart of the JAX package's ``tools/accuracy_trajectory.py``, with
its flags and output.  It mirrors the reference's defining experiment:
repeated labeled batch runs with ``--train`` online SGD, the accuracy
climbing run over run (``results/batch_results1.txt`` ...
``batch_results10.txt``, ``batch_test.py:158-189``).  Everything is
hermetic: the procedural-face corpus of ``make_labeled_corpus`` (made in
``<workdir>/videos`` unless it holds clips), the shipped checkpoints, and
the recorded LLM and search.  The tool works in ``--workdir`` (it changes
into it), runs ``batch.main`` once per run into
``results/batch_results<run>.txt``, and ends with a ``trajectory:`` line of
accuracies and an ``attempts:`` line of the SGD retries per run.  It runs
on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re

from fvd_tpu_torch.providers.factory import production_providers

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default="traj_run")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--n-real", type=int, default=6)
    ap.add_argument("--n-fake", type=int, default=6)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--ambiguous", type=int, default=0,
                    help="additional feature-ambiguous fakes (subtle manipulations at "
                         "feature-sensitivity edges: run-1 accuracy starts below 100%%)")
    ap.add_argument("--hard-reals", type=int, default=0,
                    help="additional noisy genuine clips with no verifiable claims "
                         "(false-positive hard cases: under the pretrained weights they "
                         "start on the fake side, so run-1 accuracy starts below 100%%)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--baseline-eval", action="store_true",
                    help="record a run 0 without --train first: the pre-training "
                         "accuracy baseline")
    ap.add_argument("--fresh-weights", action="store_true",
                    help="start from all-zero LR weights instead of the shipped "
                         "pretrained ones: the full online-learning climb")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    os.makedirs(args.workdir, exist_ok=True)
    os.chdir(args.workdir)

    from fvd_tpu_torch.tools.make_labeled_corpus import build_corpus

    if not os.path.isdir("videos") or not os.listdir("videos"):
        print("generating labeled corpus...")
        build_corpus("videos", args.n_real, args.n_fake, args.duration,
                     n_ambiguous=args.ambiguous, n_hard_real=args.hard_reals)

    from fvd_tpu_torch import batch
    from fvd_tpu_torch.providers import set_providers

    set_providers(production_providers(checkpoint_dir=os.path.join(REPO, "checkpoints"),
                                       recorded_services=True, device=device))

    if args.fresh_weights and not os.path.exists("lr_weights.json"):
        from fvd_tpu_torch.ops.fusion import FEATURE_ORDER

        with open("lr_weights.json", "w") as f:
            json.dump({"bias": 0.0, **{k: 0.0 for k in FEATURE_ORDER}}, f)
        print("starting from all-zero LR weights")

    accs = []
    attempts = []
    runs = [(r, True) for r in range(1, args.runs + 1)]
    if args.baseline_eval:
        runs.insert(0, (0, False))
    for run, train in runs:
        results = f"results/batch_results{run}.txt"
        print(f"=== run {run}/{args.runs} ({'--train' if train else 'eval baseline'}) ===",
              flush=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            batch.main((["--train"] if train else []) + ["--results", results]
                       + (["--cpu"] if args.cpu else []))
        out = buf.getvalue()
        print(out, flush=True)
        with open(results) as f:
            table = f.read()
        m = re.search(r"Total Accuracy: ([0-9.]+)%", table)
        accs.append(float(m.group(1)) if m else float("nan"))
        # total SGD retries this run: the online-learning effort curve
        attempts.append(sum(int(a) for a in re.findall(r"attempts=(\d+)", out)))
        print(f"run {run}: accuracy {accs[-1]}% (total attempts {attempts[-1]})",
              flush=True)

    print("trajectory:", " -> ".join(f"{a:.2f}%" for a in accs))
    print("attempts:  ", " -> ".join(str(a) for a in attempts))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
