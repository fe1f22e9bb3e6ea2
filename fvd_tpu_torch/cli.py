"""CLI entry point: the port of ``fvd_tpu/cli.py``.

Mirrors the reference CLI contract (``main.py:345-411``):

    python -m fvd_tpu_torch.cli <input_path> [label] [--debug] [--cpu]
    python -m fvd_tpu_torch.cli <input_path> --stream [--chunk-seconds S] [--cpu]
    python -m fvd_tpu_torch.cli [input_path] --frontend [--port N] [--cpu]
    python -m fvd_tpu_torch.cli [input_path] --frontend-term [--debug] [--cpu]

runs the 16-node DAG on the card (``--cpu``: on the CPU) and prints
``Fake probability: <p>`` on the last line (the batch harness parses this,
reference batch_test.py:118-121).  A label of 0 or 1 runs LR's online update.
The input is a raw-RGBA AVI with its audio in a sibling ``.wav``; a URL or
another container fails in IN with a message naming it.

``--stream`` scores growing prefixes chunk by chunk
(``fvd_tpu_torch/streaming.py``), one ``[t s  pct%] lip_sync=... p=...``
line per chunk, and ends with ``Fake probability: <p>``.  ``--frontend``
serves the web UI (``ui/web.py``) at ``http://127.0.0.1:<port>/``;
``--frontend-term`` runs the terminal UI (``ui/app.py``), which asks for a
path on stdin when none is given.
"""

from __future__ import annotations

import argparse
import sys

from fvd_tpu_torch.config import default_config
from fvd_tpu_torch.graph import NODE_ORDER, build_graph
from fvd_tpu_torch.runtime.scheduler import Scheduler
from fvd_tpu_torch.runtime.status import StatusBoard
from fvd_tpu_torch.state import State


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Fake Video Detection Engine (PyTorch/CUDA)")
    parser.add_argument("input_path", nargs="?", help="Path to a raw-RGBA AVI video file")
    parser.add_argument("label", nargs="?", type=int, help="Optional label (0 or 1)")
    parser.add_argument("--debug", action="store_true", help="Enable debug mode")
    parser.add_argument("--frontend", action="store_true", help="Launch the web UI")
    parser.add_argument("--frontend-term", action="store_true",
                        help="Launch the terminal UI instead of the web UI")
    parser.add_argument("--port", type=int, default=8861, help="web UI port")
    parser.add_argument("--stream", action="store_true",
                        help="progressive analysis: print a running "
                             "fake-probability as the video is processed "
                             "chunk by chunk (vision+audio features)")
    parser.add_argument("--chunk-seconds", type=float, default=5.0,
                        help="prefix chunk size for --stream")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    # Entry points run the production bundle (the reference CLI loads every
    # real model, main.py:345-411); tests inject providers into build_graph.
    from fvd_tpu_torch.providers.factory import bootstrap_production

    bootstrap_production(device=device)

    if args.frontend_term:
        from fvd_tpu_torch.ui.app import serve

        serve(prefill_url=args.input_path, debug=args.debug, device=device)
        return 0

    if args.frontend:
        from fvd_tpu_torch.ui.web import serve_web

        serve_web(port=args.port, prefill_url=args.input_path, device=device)
        return 0

    if not args.input_path:
        parser.error("input_path is required when not using --frontend mode")
    if args.label is not None and args.label not in (0, 1):
        print("Label must be 0 or 1 if provided.")
        return 1

    if args.stream:
        from fvd_tpu_torch.streaming import analyze_progressive

        if args.input_path.startswith(("http://", "https://")):
            print("--stream analyzes a local file as it is read; download "
                  "the URL first (or run without --stream to ingest it).")
            return 1
        if args.label is not None:
            print("Note: --stream is scoring-only; the label is ignored "
                  "(run without --stream for an online training update).")

        last = None
        for u in analyze_progressive(args.input_path, chunk_seconds=args.chunk_seconds, device=device):
            last = u
            print(f"[{u.t_end:6.1f}s {100 * u.fraction:5.1f}%] "
                  f"lip_sync={u.features['lip_sync']:.3f} "
                  f"p={u.fake_probability:.4f}", flush=True)
        if last is None:
            print("No analyzable frames (missing landmark model or video).")
            return 1
        print("Fake probability:", last.fake_probability)
        return 0

    state = State(input_path=args.input_path, debug=args.debug)
    if args.label is not None:
        state.label = args.label

    config = default_config().replace(debug=args.debug)
    dag = build_graph(config, device=device)
    board = StatusBoard(NODE_ORDER, dag.edges())

    print(f"Starting processing with debug={'ON' if args.debug else 'OFF'}...")
    final_state = None
    for ev in Scheduler(dag).stream(state):
        if ev.node == "__end__":
            if ev.status == "error":
                print(f"Pipeline failed: {ev.error}")
                return 1
            final_state = ev.delta["__final_state__"]
        elif ev.status == "done":
            board.mark_done([ev.node])
            if args.debug:
                print("  ".join(board.render_lines()))
        elif ev.status == "error":
            print(f"Node {ev.node} failed: {ev.error}")

    if final_state is None:
        return 1
    if args.debug:
        print("Final features:", final_state.features)
    print("Fake probability:", final_state.fake_probability)
    return 0


if __name__ == "__main__":
    sys.exit(main())
