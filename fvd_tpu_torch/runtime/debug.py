"""Per-node debug artifacts: the port's copy of ``fvd_tpu/runtime/debug.py``
(``_jsonable``'s ``tolist`` branch also takes a torch tensor).

Keeps the reference's artifact contract (``nodes/__init__.py:5-22``): each
node may persist ``<data_dir>/<NODE>_debug.json`` and append a line to
``<data_dir>/debug_log.txt``.  Failures never break the pipeline.  The LR
fusion node relies on these files as a recovery path when upstream state keys
were lost (reference ``lr_node.py:34-47,65-79``), so the format is load-bearing.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional


def _jsonable(obj: Any) -> Any:
    try:
        json.dumps(obj)
        return obj
    except TypeError:
        if hasattr(obj, "tolist"):
            return obj.tolist()
        if isinstance(obj, dict):
            return {k: _jsonable(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_jsonable(v) for v in obj]
        return repr(obj)


def dump_node_debug(data_dir: Optional[str], node_name: str, payload: Dict[str, Any]) -> None:
    """Persist lightweight debug info for a node inside ``data_dir``."""
    if not data_dir:
        return
    try:
        path = os.path.join(data_dir, f"{node_name}_debug.json")
        with open(path, "w") as f:
            json.dump(_jsonable(payload), f, indent=2)
        log_path = os.path.join(data_dir, "debug_log.txt")
        with open(log_path, "a") as f:
            f.write(f"Node {node_name} completed. Keys: {list(payload.keys())}\n")
    except Exception:
        # Debug writing must not break the pipeline.
        pass


def read_node_debug(data_dir: Optional[str], node_name: str) -> Optional[Dict[str, Any]]:
    if not data_dir:
        return None
    path = os.path.join(data_dir, f"{node_name}_debug.json")
    try:
        with open(path) as f:
            return json.load(f)
    except Exception:
        return None
