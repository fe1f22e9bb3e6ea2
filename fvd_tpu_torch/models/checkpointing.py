"""Training-state checkpoints: the counterpart of
``fvd_tpu/models/checkpointing.py`` (orbax there, ``torch.save`` here).

A checkpoint is ``path/<step>/train_state.pt`` holding the step, the model's
state dict and the optimizer's; the newest :data:`MAX_TO_KEEP` steps are
kept.  The npz files of ``save_params`` stay the interchange format with the
JAX package and the providers; these files are read by the port only.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

MAX_TO_KEEP = 3
_FILE = "train_state.pt"


def _steps(path: str):
    if not os.path.isdir(path):
        return []
    return sorted(int(d) for d in os.listdir(path)
                  if d.isdigit() and os.path.isfile(os.path.join(path, d, _FILE)))


def save_train_state(path: str, step: int, model: torch.nn.Module, opt: torch.optim.Optimizer) -> None:
    """Write the state at ``step`` to ``path/<step>/`` (through a temporary
    file, so a reader never sees half of one) and drop all but the newest
    :data:`MAX_TO_KEEP` steps."""
    step_dir = os.path.join(path, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, _FILE + ".tmp")
    torch.save({"step": int(step), "params": model.state_dict(), "opt_state": opt.state_dict()}, tmp)
    os.replace(tmp, os.path.join(step_dir, _FILE))
    for old in _steps(path)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(path, str(old)), ignore_errors=True)


def load_train_state(path: str, model: torch.nn.Module, opt: torch.optim.Optimizer) -> Optional[int]:
    """Load the newest step under ``path`` into ``model`` and ``opt`` (in
    place, onto the model's device); -> that step, or None where there is
    none."""
    steps = _steps(path)
    if not steps:
        return None
    device = next(model.parameters()).device
    state = torch.load(os.path.join(path, str(steps[-1]), _FILE), map_location=device, weights_only=True)
    model.load_state_dict(state["params"])
    opt.load_state_dict(state["opt_state"])
    return int(state["step"])
