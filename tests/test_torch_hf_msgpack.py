"""``fvd_tpu_torch/utils/msgpack.py`` against ``flax.serialization``: the
three shipped HF checkpoints and small trees of every dtype, 0-d and empty
arrays, scalars, lists and chunked arrays restore bit-equal (same tree, same
dtypes and shapes, same bytes); a bfloat16 leaf comes back as the float32
of the same values."""

import os

import flax.serialization as fs
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvd_tpu_torch.utils import msgpack as tmsgpack
from fvd_tpu_torch.weights import HF_UNUSED, hf_state_dict

HF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints", "hf")


def _assert_same(a, b, path=""):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, np.generic):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


@pytest.mark.parametrize("kind", ["minilm", "clip", "whisper"])
def test_shipped_checkpoints_restore_bit_equal(kind):
    path = os.path.join(HF, kind, "flax_model.msgpack")
    with open(path, "rb") as f:
        ref = fs.msgpack_restore(f.read())
    _assert_same(tmsgpack.read_msgpack(path), ref)


def test_every_dtype_and_shape_restores_bit_equal():
    rng = np.random.RandomState(0)
    tree = {"params": {
        **{str(np.dtype(d)): (rng.randn(3, 4) * 100).astype(d) for d in
           (np.float16, np.float32, np.float64, np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
            np.uint32, np.uint64, np.bool_, np.complex64)},
        "zero_d": np.array(1.5, np.float16), "empty": np.zeros((0, 7), np.float32),
        "big_dims": np.arange(24, dtype=np.int32).reshape(1, 2, 3, 4),
        "scalar": np.float32(2.25), "py": [1, -3, 2 ** 40, -(2 ** 40), 0.5, "txt", None, True, False, b"\x00\xff"],
        "nested": {"0": {"1": np.ones(3, np.float32)}}, "cplx": 1 - 2j,
    }}
    data = fs.msgpack_serialize(tree)
    _assert_same(tmsgpack.restore(data), fs.msgpack_restore(data))


def test_chunked_and_bfloat16_leaves(monkeypatch):
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)   # flax splits arrays above it
    big = np.arange(100, dtype=np.float32).reshape(10, 10)
    data = fs.msgpack_serialize({"big": big, "bf": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3})
    ref = fs.msgpack_restore(data)
    got = tmsgpack.restore(data)
    _assert_same(got["big"], ref["big"])
    assert got["bf"].dtype == np.float32
    np.testing.assert_array_equal(got["bf"], np.asarray(ref["bf"], np.float32))


def test_truncated_or_foreign_data_raises(tmp_path):
    data = fs.msgpack_serialize({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError):
        tmsgpack.restore(data[:-3])
    with pytest.raises(ValueError):
        tmsgpack.restore(data + b"\x01")
    empty = tmp_path / "empty.msgpack"
    empty.write_bytes(b"")
    with pytest.raises(ValueError):
        tmsgpack.read_msgpack(str(empty))


@pytest.mark.parametrize("family,kind", [("bert", "minilm"), ("clip", "clip"), ("whisper", "whisper")])
def test_hf_state_dict_takes_every_leaf_but_the_unused(family, kind):
    """Each leaf is carried across transposed as its kind requires, in
    float32; only the documented unused leaves are left out."""
    tree = tmsgpack.read_msgpack(os.path.join(HF, kind, "flax_model.msgpack"))
    sd = hf_state_dict(tree, family)
    leaves = dict(tmsgpack.leaves(tree))
    kept = {p: v for p, v in leaves.items() if p[0] not in HF_UNUSED[family]}
    assert len(sd) == len(kept)
    for path, value in kept.items():
        name = ".".join(path[:-1] + ({"kernel": "weight", "scale": "weight", "embedding": "weight"}
                                     .get(path[-1], path[-1]),))
        w = sd[name]
        assert w.dtype == torch.float32
        v = np.asarray(value, np.float32)
        if path[-1] == "kernel":
            v = v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.transpose(2, 1, 0)
        np.testing.assert_array_equal(w.numpy(), v)


def test_hf_state_dict_refuses_an_unknown_leaf():
    with pytest.raises(ValueError, match="unexpected parameter leaf"):
        hf_state_dict({"encoder": {"dense": {"kernel": np.ones((2, 2)), "gamma": np.ones(2)}}}, "bert")
    with pytest.raises(ValueError, match="unexpected kernel"):
        hf_state_dict({"encoder": {"dense": {"kernel": np.ones((2, 2, 2))}}}, "bert")
