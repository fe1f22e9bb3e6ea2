"""CLI entry point: the port of ``fvd_tpu/cli.py``.

Mirrors the reference CLI contract (``main.py:345-411``):

    python -m fvd_tpu_torch.cli <input_path> [label] [--debug] [--cpu]

runs the 16-node DAG on the card (``--cpu``: on the CPU) and prints
``Fake probability: <p>`` on the last line (the batch harness parses this,
reference batch_test.py:118-121).  A label of 0 or 1 runs LR's online update.
The input is a raw-RGBA AVI with its audio in a sibling ``.wav``; a URL or
another container fails in IN with a message naming it.  The web and
terminal UIs (``--frontend``, ``--frontend-term``) and progressive analysis
(``--stream``) are not ported yet.
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
    parser.add_argument("input_path", help="Path to a raw-RGBA AVI video file")
    parser.add_argument("label", nargs="?", type=int, help="Optional label (0 or 1)")
    parser.add_argument("--debug", action="store_true", help="Enable debug mode")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)

    if args.label is not None and args.label not in (0, 1):
        print("Label must be 0 or 1 if provided.")
        return 1
    device = "cpu" if args.cpu else "cuda"

    # Entry points run the production bundle (the reference CLI loads every
    # real model, main.py:345-411); tests inject providers into build_graph.
    from fvd_tpu_torch.providers.factory import bootstrap_production

    bootstrap_production(device=device)

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
