"""What the three HF trainers (``pretrain_hf_{minilm,whisper,clip}``) share:
loading a checkpoint directory into the port's model for training, writing
it back as Flax writes it, ``--promote``'s float16 copy, the save on
SIGTERM and the optimiser.

The JAX tools load ``Flax*.from_pretrained(out, dtype=jnp.bfloat16)`` and
train float32 copies of the parameters; :func:`load_for_training` gives the
port's model computing in bfloat16 on float32 parameters, every leaf of the
file loaded (the pooler and ``logit_scale`` included).  :func:`save_tree`
writes ``flax_model.msgpack`` through :func:`fvd_tpu_torch.weights.hf_tree`,
so a file the port writes loads in transformers' Flax classes, and in the
port's providers.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
from typing import Callable

import numpy as np
import torch

from fvd_tpu_torch.models.optim import adamw_warmup_cosine
from fvd_tpu_torch.utils.msgpack import read_msgpack, write_msgpack
from fvd_tpu_torch.weights import HF_UNUSED, hf_state_dict, hf_tree

MSGPACK = "flax_model.msgpack"


def read_config(path: str) -> dict:
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        return json.load(f)


def training_model(model_cls, family: str, cfg: dict, compute_dtype=None):
    """``model_cls(cfg)`` with the leaves only training keeps (BERT's pooler,
    CLIP's ``logit_scale``) and the compute dtype."""
    unused = {"unused": True} if HF_UNUSED[family] else {}
    return model_cls(cfg, compute_dtype=compute_dtype, **unused)


def load_for_training(model_cls, family: str, path: str, device, compute_dtype=torch.bfloat16):
    """:func:`training_model` with every leaf of ``path``'s msgpack,
    widened to float32, on ``device``."""
    model = training_model(model_cls, family, read_config(path), compute_dtype)
    model.load_state_dict(hf_state_dict(read_msgpack(os.path.join(path, MSGPACK)), family, unused=True),
                          strict=True)
    return model.to(device)


def save_tree(model: torch.nn.Module, family: str, path: str, dtype=np.float32) -> None:
    """``path``/flax_model.msgpack: ``model``'s parameters as Flax's tree in
    ``dtype``."""
    write_msgpack(os.path.join(path, MSGPACK), hf_tree(model.state_dict(), family, dtype=dtype))


def write_meta(path: str, meta: dict) -> None:
    with open(os.path.join(path, "fvd_train_meta.json"), "w") as f:
        json.dump(meta, f)


def promote_f16(model: torch.nn.Module, family: str, out: str, dest: str) -> None:
    """``--promote``: ``dest`` replaced by the parameters in float16 and
    ``out``'s ``.json`` and ``.txt`` files (config, tokenizer, meta)."""
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    if os.path.isdir(dest):
        shutil.rmtree(dest)
    os.makedirs(dest)
    save_tree(model, family, dest, np.float16)
    for name in os.listdir(out):
        if name.endswith((".json", ".txt")) and not os.path.exists(os.path.join(dest, name)):
            shutil.copy2(os.path.join(out, name), os.path.join(dest, name))


@contextlib.contextmanager
def save_on_sigterm(save: Callable[[str], None]):
    """While inside: SIGTERM saves (``save("-sig")``) and ends the process
    with 0, as the JAX tools do; the earlier handler comes back on leaving.
    Off the main thread no handler can be set, and none is."""
    def on_term(signum, frame):
        print(f"signal {signum}: saving before exit", flush=True)
        save("-sig")
        os._exit(0)

    try:
        previous = signal.signal(signal.SIGTERM, on_term)
    except ValueError:
        previous = None
    try:
        yield
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)


def hf_optimizer(model: torch.nn.Module, lr: float, warmup: int, steps: int):
    """The HF tools' chain: ``clip_by_global_norm(1.0)`` + ``adamw(
    warmup_cosine_decay_schedule(0, lr, warmup, max(steps, warmup + 1),
    end_value=lr * 0.03), b2=0.98, weight_decay=0.01)`` -> (optimiser,
    schedule) for :func:`fvd_tpu_torch.models.optim.clipped_adamw_step`."""
    return adamw_warmup_cosine(model, lr, warmup, steps, weight_decay=0.01, end_value=lr * 0.03, b2=0.98)


def symmetric_ce(logits: torch.Tensor) -> torch.Tensor:
    """The HF tools' symmetric InfoNCE of a square ``logits`` matrix: the
    mean of both directions' cross-entropy on the diagonal."""
    idx = torch.arange(logits.shape[0], device=logits.device)
    la = -torch.log_softmax(logits, dim=1)[idx, idx].mean()
    lb = -torch.log_softmax(logits, dim=0)[idx, idx].mean()
    return (la + lb) / 2


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is where it is wider (float64 runs): the
    JAX tools' ``.astype(jnp.float32)`` of the compute-dtype outputs."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def unit(x: torch.Tensor) -> torch.Tensor:
    """``x / (||x|| + 1e-8)`` over the last axis."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def device_line(device: torch.device) -> str:
    return f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())



def loss_curve(losses, points: int = 20) -> list:
    """About ``points`` evenly spaced losses of the run, the last included."""
    step = max(1, len(losses) // points)
    picked = list(losses[::step]) + ([losses[-1]] if (len(losses) - 1) % step else [])
    return [float(x) for x in picked]
