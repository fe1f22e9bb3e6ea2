"""The trainers' optimiser: ``optax.chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, max(steps, warmup + 1),
end_value=end_value), b2=b2, weight_decay=weight_decay))`` on
``torch.optim.AdamW``.  ``tools/pretrain_fan.py`` runs it at end_value
``lr * 0.05``, b2 0.999 and weight decay 1e-4, the HF trainers
(``tools/pretrain_hf_{minilm,whisper,clip}.py``) at ``lr * 0.03``, 0.98 and
0.01.

* :func:`warmup_cosine_decay` is optax's schedule: a linear warmup from
  ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine decay
  to ``end_value`` at ``decay_steps``.  optax reads it at its update count,
  0 for the first update, so the first update of a warmup from 0 moves
  nothing; the ``LambdaLR`` of :func:`adamw_warmup_cosine` is read the same
  way (stepped after each update).
* :func:`clip_by_global_norm_` is optax's clipping: the gradients scaled by
  ``max_norm / norm`` where their global norm is at least ``max_norm``
  (``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm +
  1e-6)`` whatever the norm is below).
* ``torch.optim.AdamW`` decays every parameter by ``lr * weight_decay``
  outside the Adam step, which is ``optax.adamw`` with no mask, but it skips
  a parameter whose ``.grad`` is None.  optax differentiates every leaf: one
  the loss never reads (BERT's pooler) or reads behind ``stop_gradient``
  (Whisper's encoder positions) gets a zero gradient, so a zero Adam step
  and the decay.  :func:`clipped_adamw_step` gives such parameters zero
  gradients for the same result.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn


def warmup_cosine_decay(count: int, init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0) -> float:
    """``optax.warmup_cosine_decay_schedule(init_value, peak_value,
    warmup_steps, decay_steps, end_value)`` at ``count``."""
    if count < warmup_steps:
        frac = 1.0 - count / warmup_steps
        return (init_value - peak_value) * frac + peak_value
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    steps = decay_steps - warmup_steps
    t = min(count - warmup_steps, steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / steps)) if steps > 0 else 1.0
    return peak_value * ((1.0 - alpha) * cosine + alpha)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the ``.grad`` of ``params`` in place as ``optax.clip_by_global_norm
    (max_norm)`` does; -> the global norm before clipping (on the device, no
    host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def adamw_warmup_cosine(model: nn.Module, lr: float, warmup: int, steps: int, weight_decay: float = 1e-4,
                        end_value: Optional[float] = None, b2: float = 0.999
                        ) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """``optax.adamw(warmup_cosine_decay_schedule(0, lr, warmup, max(steps,
    warmup + 1), end_value=end_value), b2=b2, weight_decay=weight_decay)``
    over ``model``'s parameters (``end_value`` None: ``lr * 0.05``) ->
    (optimiser, schedule); step the schedule after every optimiser step."""
    end_value = lr * 0.05 if end_value is None else end_value
    opt = torch.optim.AdamW(model.parameters(), lr=1.0, betas=(0.9, b2), eps=1e-8, weight_decay=weight_decay)
    decay = max(steps, warmup + 1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: warmup_cosine_decay(count, 0.0, lr, warmup, decay, end_value=end_value))
    return opt, sched


def clipped_adamw_step(loss_fn: Callable, model: nn.Module, opt: torch.optim.Optimizer,
                       sched: torch.optim.lr_scheduler.LRScheduler, *args, max_norm: float = 1.0) -> torch.Tensor:
    """One step of ``clip_by_global_norm(max_norm)`` + ``opt`` on
    ``loss_fn(model, *args)``, then the schedule's count; -> the loss before
    the update, detached (no host sync).  A parameter the loss does not
    reach gets a zero gradient, as optax gives it."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, *args)
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm_(model.parameters(), max_norm)
    opt.step()
    sched.step()
    return loss.detach()
