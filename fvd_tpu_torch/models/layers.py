"""flax.linen layer semantics the port's models need.

* :class:`SameConv2d` pads like flax ``padding="SAME"``: the total pad of a
  spatial axis of size ``n`` is ``max((ceil(n/s) - 1) * s + k - n, 0)``, with
  the smaller half first.  It depends on the input size, so it is computed in
  ``forward`` (a stride-2 3x3 conv pads (0, 1) on 300 but (1, 1) on 75).
  :class:`SameConv1d` is the same for a 1-D conv over [B, C, T].
* :func:`group_norm` is flax's ``GroupNorm(num_groups=8)``: eps 1e-6, where
  torch defaults to 1e-5.
* :func:`in_dtype` is the model with every parameter cast to the compute
  dtype, as the reference casts its params tree inside each jitted forward.
* :func:`conv_in_dtype` and :func:`group_norm_in_dtype` are flax's ``Conv``
  and ``GroupNorm`` with ``dtype=`` (bfloat16 on float32 parameters): the
  weights cast to the input's dtype inside the forward, differentiably, so
  training updates the float32 parameters as optax does.
* :func:`adam` is ``optax.adam`` as a ``torch.optim.Adam`` and
  :func:`adam_step` one ``value_and_grad`` + update of a train step.
"""

from __future__ import annotations

import copy
import threading
import weakref

import torch
import torch.nn as nn
import torch.nn.functional as F

_cast_lock = threading.Lock()
_cast: "weakref.WeakKeyDictionary[nn.Module, dict]" = weakref.WeakKeyDictionary()


def in_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``model`` with its parameters and buffers in ``dtype``: a copy cast on
    the first call for each dtype and kept, so later calls cast nothing; the
    model itself where its first parameter already has ``dtype``.  Calling a
    module is safe from several threads at once (concurrent videos share one
    provider); swapping its parameters per call, as
    ``torch.func.functional_call`` does, is not.  The copy is cast again
    when ``model``'s weights have changed in place since (an optimizer step,
    ``load_state_dict``): every in-place write bumps a tensor's version
    counter, and the copy keeps the counters it was cast at."""
    if next(model.parameters()).dtype == dtype:
        return model
    stamp = tuple(t._version for t in model.state_dict(keep_vars=True).values())
    with _cast_lock:
        per = _cast.setdefault(model, {})
        if per.get(dtype, (None,))[0] != stamp:
            per[dtype] = (stamp, copy.deepcopy(model).to(dtype))
        return per[dtype][1]


def same_pads(n: int, k: int, s: int):
    """(low, high) padding of flax "SAME" for one axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, k, stride=stride, padding=0, bias=bias)

    def pad_same(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [B, C, H, W] padded as flax "SAME" pads it for this conv."""
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = same_pads(x.shape[-2], k, s)
        left, right = same_pads(x.shape[-1], k, s)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(self.pad_same(x))


class SameConv1d(nn.Conv1d):
    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, k, stride=stride, padding=0, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        left, right = same_pads(x.shape[-1], self.kernel_size[0], self.stride[0])
        if left or right:
            x = F.pad(x, (left, right))
        return super().forward(x)


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(8, channels, eps=1e-6)


def conv_in_dtype(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """flax's conv computing in ``x``'s dtype: the convolution with the
    weights cast to it, rounded to it, then the bias added in it."""
    if isinstance(conv, SameConv2d):
        x = conv.pad_same(x)
    dt = x.dtype
    return F.conv2d(x, conv.weight.to(dt), None, conv.stride, conv.padding) + conv.bias.to(dt)[:, None, None]


def group_norm_in_dtype(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """flax's ``GroupNorm`` with ``dtype`` ``x.dtype``: the statistics and the
    normalisation in float32 (float64 for float64), the result in ``x``'s
    dtype."""
    st = torch.promote_types(x.dtype, torch.float32)
    return F.group_norm(x.to(st), gn.num_groups, gn.weight.to(st), gn.bias.to(st), gn.eps).to(x.dtype)


def adam(model: nn.Module, lr: float = 1e-3) -> torch.optim.Adam:
    """``optax.adam(lr)`` over ``model``'s parameters: b1 0.9, b2 0.999 and
    eps 1e-8 added outside the square root, as both libraries add it."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def adam_step(loss_fn, model: nn.Module, opt: torch.optim.Optimizer, *args) -> torch.Tensor:
    """One step of ``opt`` on ``loss_fn(model, *args)``; -> the loss before
    the update, detached (no host sync).  The step's gradients stay in
    ``p.grad`` until the next step."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, *args)
    loss.backward()
    opt.step()
    return loss.detach()
