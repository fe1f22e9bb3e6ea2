"""Layers of the Hugging Face models with Flax's ``dtype=``: the compute
dtype of transformers' Flax modules created with ``dtype=jnp.bfloat16`` on
float32 parameters, as the JAX package's HF trainers run them.

Each layer keeps torch's own forward while its ``compute_dtype`` is None
(inference: the parameters' dtype throughout).  With a dtype set by
:func:`set_compute_dtype`:

* :class:`Linear` and the convolutions cast the input and the parameters to
  it inside the forward (differentiably, so the float32 parameters get the
  gradient), multiply in it, round, then add the bias in it, as ``nn.Dense``
  and ``nn.Conv`` do;
* :class:`Embedding` looks up the table cast to it (``nn.Embed``);
  :meth:`Embedding.table` is the cast table, for the models' direct reads;
* :class:`LayerNorm` takes its statistics and normalises in float32 (float64
  for float64) and gives the result in the compute dtype, as ``nn.LayerNorm``
  with ``dtype=`` does.

The attention softmax follows the scores' dtype (``dot_product_attention``'s
``softmax_dtype``), as ``dot_product_attention_weights(..., dtype=)`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = x.to(dt) @ self.weight.to(dt).T
        return y if self.bias is None else y + self.bias.to(dt)


class Conv1d(nn.Conv1d):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.conv1d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)
        return y if self.bias is None else y + self.bias.to(dt)[:, None]


class Conv2d(nn.Conv2d):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class Embedding(nn.Embedding):
    compute_dtype: Optional[torch.dtype] = None

    def table(self) -> torch.Tensor:
        """The embedding table in the compute dtype."""
        return self.weight if self.compute_dtype is None else self.weight.to(self.compute_dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.table())


class LayerNorm(nn.LayerNorm):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        st = torch.promote_types(dt, torch.float32)
        return F.layer_norm(x.to(st), self.normalized_shape, self.weight.to(st), self.bias.to(st),
                            self.eps).to(dt)


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Set the compute dtype of every layer of this module in ``model``
    (None: the parameters' dtype); -> ``model``."""
    for m in model.modules():
        if isinstance(m, (Linear, Conv1d, Conv2d, Embedding, LayerNorm)):
            m.compute_dtype = dtype
    model.compute_dtype = dtype
    return model
