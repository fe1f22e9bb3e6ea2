"""Terminal frontend: the port of ``fvd_tpu/ui/app.py``.

The reference ships a Streamlit app (``app.py``) with a live dependency-aware
status board, a Graphviz DAG render and a results panel.  This frontend
renders the same status board live in the terminal and prints the same
results summary.  The board logic is the shared
:class:`fvd_tpu_torch.runtime.status.StatusBoard`; the DAG runs on
``device`` (default the card).
"""

from __future__ import annotations

import sys
from typing import Optional

from fvd_tpu_torch.config import default_config
from fvd_tpu_torch.graph import NODE_ORDER, build_graph
from fvd_tpu_torch.runtime.scheduler import Scheduler
from fvd_tpu_torch.runtime.status import StatusBoard
from fvd_tpu_torch.state import State


def _render_results(state: State) -> None:
    p = state.fake_probability
    verdict = "FAKE" if (p or 0.0) > 0.5 else "REAL"  # reference app.py:332-334
    print("\n=== Result ===")
    print(f"Verdict: {verdict}   fake_probability={p}")
    if state.features:
        print("Features:")
        for k, v in state.features.items():
            print(f"  {k:22s} {v:.4f}")
    if state.claims:
        print("Claims:")
        for c in state.claims:
            if isinstance(c, dict):
                print(f"  - {c.get('claim_text', '')[:70]} -> {c.get('verdict', '?')} "
                      f"({c.get('evidence_score', 0.0)})")
    if state.metadata:
        meta = state.metadata
        print(f"Media: duration={meta.get('duration')}s fps={meta.get('fps')} "
              f"size={meta.get('size')}")


def serve(prefill_url: Optional[str] = None, debug: bool = False, device=None) -> None:
    """Analyze ``prefill_url`` (asked for on stdin when not given) with a live
    status line, then print the results."""
    if not prefill_url:
        print("Enter a video path or URL:")
        prefill_url = input("> ").strip()
        if not prefill_url:
            print("Nothing to analyze.")
            return

    config = default_config().replace(debug=debug)
    dag = build_graph(config, device=device)
    board = StatusBoard(NODE_ORDER, dag.edges())
    state = State(input_path=prefill_url, debug=debug)

    final_state = None
    for ev in Scheduler(dag).stream(state):
        if ev.node == "__end__":
            if ev.status == "error":
                print(f"\nPipeline failed: {ev.error}")
                return
            final_state = ev.delta["__final_state__"]
            continue
        if ev.status == "done":
            board.mark_done([ev.node])
        line = "  ".join(board.render_lines())
        sys.stdout.write("\r" + line)
        sys.stdout.flush()
    print()
    if final_state is not None:
        _render_results(final_state)
