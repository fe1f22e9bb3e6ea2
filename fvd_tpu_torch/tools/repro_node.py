"""Single-node repro harness:

    python -m fvd_tpu_torch.tools.repro_node C1 --data-dir processed/video_XXX \
        --state-json extra_state.json [--debug] [--cpu]

The counterpart of the JAX package's ``tools/repro_node.py``, with its
flags.  It re-runs ONE node against a saved run directory: the state is
built from ``--data-dir`` (where the nodes find their per-node debug
artifacts) plus whatever JSON ``--state-json`` holds, so a failing node can
be iterated on without re-running the pipeline.  A node with device work of
its own (A1, A3, C1, V5) runs on the card unless ``--cpu`` is given;
without a card that raises.  Nodes behind provider seams get the process's
default bundle, as in the JAX tool.  Deferred artifact writes are flushed,
then the node's delta is printed one key a line.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json

from fvd_tpu_torch.config import default_config
from fvd_tpu_torch.state import State

NODE_MODULES = {
    "IN": "fvd_tpu_torch.nodes.ingest",
    "A1": "fvd_tpu_torch.nodes.a1_standardize",
    "A2": "fvd_tpu_torch.nodes.a2_asr",
    "A3": "fvd_tpu_torch.nodes.a3_onsets",
    "V1": "fvd_tpu_torch.nodes.v1_faces",
    "V2": "fvd_tpu_torch.nodes.v2_ocr",
    "V3": "fvd_tpu_torch.nodes.v3_landmarks",
    "V4": "fvd_tpu_torch.nodes.v4_dynamics",
    "V5": "fvd_tpu_torch.nodes.v5_forensics",
    "C1": "fvd_tpu_torch.nodes.c1_lipsync",
    "C2": "fvd_tpu_torch.nodes.c2_gesture",
    "C3": "fvd_tpu_torch.nodes.c3_claims",
    "E1": "fvd_tpu_torch.nodes.e1_evidence",
    "E2": "fvd_tpu_torch.nodes.e2_reliability",
    "E3": "fvd_tpu_torch.nodes.e3_scorer",
    "LR": "fvd_tpu_torch.nodes.lr_fusion",
}


def main(argv=None) -> dict:
    """-> the node's delta."""
    ap = argparse.ArgumentParser(description="Re-run one node in isolation")
    ap.add_argument("node", choices=sorted(NODE_MODULES))
    ap.add_argument("--data-dir", help="processed/video_XXX run directory")
    ap.add_argument("--state-json", help="JSON file with extra state fields")
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run the node's device work on the CPU instead of the card")
    args = ap.parse_args(argv)

    state_dict = {"debug": args.debug}
    if args.data_dir:
        state_dict["data_dir"] = args.data_dir
    if args.state_json:
        with open(args.state_json) as f:
            state_dict.update(json.load(f))
    state = State.from_dict(state_dict)

    module = importlib.import_module(NODE_MODULES[args.node])
    kwargs = {"config": default_config().replace(debug=args.debug)}
    if "device" in inspect.signature(module.run).parameters:
        kwargs["device"] = "cpu" if args.cpu else "cuda"
    delta = module.run(state, **kwargs)

    from fvd_tpu_torch.runtime.io_pool import flush_artifacts

    for err in flush_artifacts(None):  # nodes may defer viz writes
        print(f"WARNING: deferred artifact write failed: {err}")

    def show(v):
        s = repr(v)
        return s if len(s) < 300 else s[:300] + f"... ({len(s)} chars)"

    print(f"\n=== {args.node} delta ===")
    for k, v in (delta or {}).items():
        print(f"{k}: {show(v)}")
    return delta or {}


if __name__ == "__main__":
    main()
