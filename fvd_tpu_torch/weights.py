"""Checkpoint import: flax parameter trees -> torch state dicts.

``fvd_tpu`` saves a flax params tree as an npz whose keys are
``jax.tree_util.keystr`` paths, e.g. ``"['params']['ConvBlock_0']['Conv_0']['kernel']"``
(``fvd_tpu/models/face_ssd.py`` ``save_params``).  The port's modules name
their submodules after the flax auto-names (``ConvBlock_0``, ``Conv_0``,
``GroupNorm_0``), so a key maps to a state-dict key by joining the path with
dots and renaming the leaf:

* conv ``kernel`` [H, W, I, O] -> ``weight`` [O, I, H, W], and a 1-D conv's
  [K, I, O] -> [O, I, K];
* ``Dense`` ``kernel`` [I, O] -> ``nn.Linear`` ``weight`` [O, I];
* the ``DenseGeneral`` projections of a ``MultiHeadDotProductAttention_*``:
  ``query``/``key``/``value`` kernels [D, H, Dh] -> ``nn.Linear`` weights
  [H * Dh, D] and their biases [H, Dh] -> [H * Dh]; ``out``'s kernel
  [H, Dh, D] -> [D, H * Dh].  These kernels are 3-D like a 1-D conv's, so
  the module name decides;
* GroupNorm and LayerNorm ``scale`` -> ``weight``; ``Embed`` ``embedding``
  -> ``nn.Embedding`` ``weight``;
* ``bias`` stays ``bias``, and the raw params ``cls`` and ``logit_scale``
  keep their names.

:func:`hf_state_dict` does the same for the Hugging Face Flax trees of
``checkpoints/hf/*/flax_model.msgpack`` (read by
:mod:`fvd_tpu_torch.utils.msgpack`), whose modules the port names as the
Flax classes do, and :func:`hf_tree` turns a state dict back into such a
tree, which :func:`fvd_tpu_torch.utils.msgpack.write_msgpack` writes.

:func:`seeded_state_dict` gives a module weights drawn from a numpy seed,
for runs at a model's geometry without a checkpoint, and
:func:`from_state_dict` turns a trained model (or its gradients) back into
the flat npz tree.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_KEY_PART = re.compile(r"\['([^']*)'\]")


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """The flat ``{keystr: array}`` tree of an npz checkpoint."""
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


def flatten(tree: Mapping) -> Dict[str, np.ndarray]:
    """A nested params mapping (a flax tree converted to numpy) as the flat
    ``{keystr: array}`` form the npz files use; a flat one passes through."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}['{k}']")
            else:
                out[f"{prefix}['{k}']"] = np.asarray(v)

    if all(isinstance(k, str) and k.startswith("['") for k in tree):
        return {k: np.asarray(v) for k, v in tree.items()}
    walk(tree, "")
    return out


#: the raw ``self.param`` leaves of the port's models, kept as they are
_RAW_PARAMS = ("cls", "logit_scale")


def _leaf(path, value: np.ndarray):
    *mods, leaf = path
    attention = len(mods) >= 2 and mods[-2].startswith("MultiHeadDotProductAttention")
    if attention and mods[-1] in ("query", "key", "value"):
        if leaf == "kernel":                      # [D, H, Dh]
            return mods + ["weight"], value.reshape(value.shape[0], -1).T
        if leaf == "bias":                        # [H, Dh]
            return mods + ["bias"], value.reshape(-1)
    if attention and mods[-1] == "out" and leaf == "kernel":   # [H, Dh, D]
        return mods + ["weight"], value.reshape(-1, value.shape[-1]).T
    if leaf == "kernel":
        if value.ndim == 4:
            return mods + ["weight"], value.transpose(3, 2, 0, 1)
        if value.ndim == 3 and mods and mods[-1].startswith("Conv"):
            return mods + ["weight"], value.transpose(2, 1, 0)
        if value.ndim == 2:
            return mods + ["weight"], value.T
        raise ValueError(f"{'.'.join(path)}: only conv [H,W,I,O] or [K,I,O], Dense [I,O] and attention "
                         f"kernels are supported, not {value.shape}")
    if leaf in ("scale", "embedding"):
        return mods + ["weight"], value
    if leaf == "bias" or leaf in _RAW_PARAMS:
        return mods + [leaf], value
    raise ValueError(f"unexpected parameter leaf {'.'.join(path)}")


def to_state_dict(tree: Mapping, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Torch state dict (``dtype``, CPU) of a flax params tree, flat or nested."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flatten(tree).items():
        path = _KEY_PART.findall(key)
        if path and path[0] == "params":
            path = path[1:]
        name, arr = _leaf(path, value)
        sd[".".join(name)] = torch.tensor(arr, dtype=dtype)
    return sd


def from_state_dict(sd, dtype: torch.dtype = torch.float32,
                    model: Optional[torch.nn.Module] = None) -> Dict[str, np.ndarray]:
    """The flat ``{keystr: array}`` flax tree (``dtype``) of a state dict, which
    ``np.savez(path, **tree)`` writes as the JAX package's npz: the inverse
    of :func:`to_state_dict`.  ``sd`` is a module (its state dict) or a
    state dict of ``model``'s entries (its gradients, say); the module
    decides each entry's kind, so ``to_state_dict(from_state_dict(m)) ==
    m.state_dict()`` for every model of the port:

    * a conv ``weight`` [O, I, H, W] -> ``kernel`` [H, W, I, O] (a 1-D
      conv's [O, I, K] -> [K, I, O]), an ``nn.Linear`` ``weight`` [O, I] ->
      ``kernel`` [I, O];
    * the ``query``/``key``/``value`` projections of a
      ``MultiHeadDotProductAttention_*`` [H * Dh, D] -> ``kernel`` [D, H, Dh]
      and their biases -> [H, Dh]; ``out``'s [D, H * Dh] -> [H, Dh, D], with
      H the attention module's ``heads``;
    * an ``nn.Embedding`` ``weight`` -> ``embedding`` as it is; a norm's 1-D
      ``weight`` -> ``scale``;
    * ``bias`` and the raw params ``cls`` and ``logit_scale`` as they are.

    Without a module only the conv, Dense and norm entries can be told
    apart: an attention projection or an embedding raises."""
    if isinstance(sd, torch.nn.Module):
        model, sd = model or sd, sd.state_dict()
    tree: Dict[str, np.ndarray] = {}
    for name, value in sd.items():
        *mods, leaf = name.split(".")
        arr = value.detach().to("cpu", dtype).numpy()
        attention = len(mods) >= 2 and mods[-2].startswith("MultiHeadDotProductAttention")
        if model is None and (attention or (mods and mods[-1].startswith("Embed"))):
            raise ValueError(f"{name}: an attention projection or an embedding needs the model")
        if leaf in _RAW_PARAMS:
            pass
        elif attention and mods[-1] in ("query", "key", "value", "out"):
            heads = model.get_submodule(".".join(mods[:-1])).heads
            if leaf == "weight":
                leaf = "kernel"
                arr = arr.T.reshape(arr.shape[1], heads, -1) if mods[-1] != "out" else \
                    arr.T.reshape(heads, -1, arr.shape[0])
            elif mods[-1] != "out":
                arr = arr.reshape(heads, -1)
        elif leaf == "weight" and model is not None and isinstance(_owner(model, name), torch.nn.Embedding):
            leaf = "embedding"
        elif leaf == "weight":
            leaf = "scale" if arr.ndim == 1 else "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        elif leaf != "bias":
            raise ValueError(f"unexpected state dict entry {name}")
        tree["['params']" + "".join(f"['{m}']" for m in mods + [leaf])] = np.array(arr, order="C")
    return tree


def save_npz(path: str, model: torch.nn.Module) -> None:
    """Write ``model`` as the JAX package's flat npz (its ``save_params``)."""
    np.savez(path, **from_state_dict(model))


def load_npz(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load an npz checkpoint into ``model`` (in place, strict); -> ``model``."""
    model.load_state_dict(to_state_dict(read_npz(path)), strict=True)
    return model


def kernel_width(tree: Mapping, module: str) -> int:
    """Output channels of the conv kernel of ``module``, a dotted submodule
    path such as ``"ConvBlock_0.Conv_0"``: how ``__graft_entry__.entry()``
    reads a checkpoint's width."""
    key = "['params']" + "".join(f"['{m}']" for m in module.split(".")) + "['kernel']"
    return int(flatten(tree)[key].shape[-1])


#: leaves of the HF Flax trees that no provider reads, skipped by
#: :func:`hf_state_dict`: BERT's pooler (the text encoder mean-pools the last
#: hidden state) and CLIP's ``logit_scale`` (the provider takes the
#: cosines).  The models built for inference have no place for them; built
#: with ``unused=True`` they hold them as parameters, because the HF
#: trainers train them and write them back (``hf_state_dict(...,
#: unused=True)``, :func:`hf_tree`).
HF_UNUSED = {"bert": ("pooler",), "clip": ("logit_scale",), "whisper": ()}

#: the ``Embed`` modules of the HF Flax trees: an ``embedding`` table, not a
#: ``Dense`` kernel, though both are 2-D
HF_EMBEDDINGS = ("word_embeddings", "position_embeddings", "token_type_embeddings", "token_embedding",
                 "position_embedding", "embed_tokens", "embed_positions")


def hf_state_dict(tree: Mapping, family: str, unused: bool = False) -> Dict[str, torch.Tensor]:
    """Torch state dict (float32, CPU) of a Hugging Face Flax params tree of
    ``family`` ("bert", "clip" or "whisper"): ``Dense`` kernels [I, O] ->
    [O, I]; CLIP's patch conv [H, W, I, O] -> [O, I, H, W] and Whisper's
    ``conv1``/``conv2`` [K, I, O] -> [O, I, K]; ``Embed`` ``embedding`` and
    LayerNorm ``scale`` -> ``weight``; ``bias`` and CLIP's raw
    ``class_embedding`` and ``logit_scale`` keep their names; float16
    widens to float32 exactly, and a float64 tree stays float64.  The leaves of :data:`HF_UNUSED` are skipped
    unless ``unused``; any other leaf name raises."""
    from fvd_tpu_torch.utils.msgpack import leaves

    skip = () if unused else HF_UNUSED[family]
    sd: Dict[str, torch.Tensor] = {}
    for path, value in leaves(tree):
        if path[0] in skip:
            continue
        *mods, leaf = path
        value = np.asarray(value)
        if leaf == "kernel":
            if value.ndim == 2:
                value = value.T
            elif value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)
            elif value.ndim == 3 and mods[-1].startswith("conv"):
                value = value.transpose(2, 1, 0)
            else:
                raise ValueError(f"{'.'.join(path)}: unexpected kernel of shape {value.shape}")
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        elif leaf not in ("bias", "class_embedding", "logit_scale"):
            raise ValueError(f"unexpected parameter leaf {'.'.join(path)}")
        sd[".".join(mods + [leaf])] = torch.tensor(value, dtype=torch.float64 if value.dtype == np.float64
                                                   else torch.float32)
    return sd


def hf_tree(sd: Mapping[str, torch.Tensor], family: str, extra: Optional[Mapping] = None,
            dtype=np.float32) -> dict:
    """The Hugging Face Flax params tree of a state dict of ``family``'s
    model (or of its gradients): the inverse of :func:`hf_state_dict`.
    ``weight`` -> ``kernel`` (a ``Linear``'s [O, I] -> [I, O], a conv's
    [O, I, H, W] -> [H, W, I, O] and [O, I, K] -> [K, I, O]), ``scale`` (a
    LayerNorm's 1-D weight) or ``embedding`` (the modules of
    :data:`HF_EMBEDDINGS`); ``bias``, ``class_embedding`` and ``logit_scale``
    as they are; every leaf a C-order numpy array of ``dtype``.  ``extra``,
    a nested tree, adds leaves the state dict lacks (the :data:`HF_UNUSED`
    ones of a model loaded for inference); the tree must end up holding
    those.  Every level's keys are sorted, the order of the trees the JAX
    package's trainers write (``jax.tree.map`` sorts a dict's keys)."""
    tree: dict = {}
    for name, value in sd.items():
        *mods, leaf = name.split(".")
        arr = value.detach().to("cpu", torch.float64 if value.dtype == torch.float64 else torch.float32).numpy()
        if leaf == "weight":
            if arr.ndim == 1:
                leaf = "scale"
            elif mods[-1] in HF_EMBEDDINGS:
                leaf = "embedding"
            else:
                leaf = "kernel"
                arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.transpose(2, 1, 0)
        elif leaf not in ("bias", "class_embedding", "logit_scale"):
            raise ValueError(f"unexpected state dict entry {name}")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.array(arr, dtype=dtype, order="C")

    def merge(dst: dict, src: Mapping) -> None:
        for k, v in src.items():
            if isinstance(v, Mapping):
                merge(dst.setdefault(k, {}), v)
            else:
                dst.setdefault(k, np.array(v, dtype=dtype, order="C"))

    merge(tree, extra or {})
    missing = [k for k in HF_UNUSED[family] if k not in tree]
    if missing:
        raise ValueError(f"hf_tree: the {family} tree lacks {missing}; pass them in extra")

    def ordered(node):
        return {k: ordered(node[k]) for k in sorted(node)} if isinstance(node, dict) else node

    return ordered(tree)


def seeded_state_dict(module: torch.nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Weights for every parameter of ``module`` from ``RandomState(seed)``,
    at flax's default scales: kernels ``N(0, 1 / fan_in)``, biases 0, norm
    scales 1, embeddings ``N(0, 1)``; the same on every device."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("bias"):
            arr = np.zeros(shape)
        elif isinstance(_owner(module, name), (torch.nn.GroupNorm, torch.nn.LayerNorm)):
            arr = np.ones(shape)
        elif isinstance(_owner(module, name), torch.nn.Embedding):
            arr = rng.randn(*shape)
        else:
            arr = rng.randn(*shape) / np.sqrt(max(1, int(np.prod(shape[1:]))))
        sd[name] = torch.tensor(arr, dtype=torch.float32)
    return sd


def seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """``module`` with :func:`seeded_state_dict` weights loaded (in place)."""
    module.load_state_dict(seeded_state_dict(module, seed))
    return module


def _owner(module: torch.nn.Module, name: str) -> torch.nn.Module:
    return module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
