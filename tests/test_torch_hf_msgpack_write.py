"""The writer of ``fvd_tpu_torch/utils/msgpack.py`` against
``flax.serialization.to_bytes``, and ``fvd_tpu_torch/weights.hf_tree``
against the shipped HF trees: the shipped MiniLM, Whisper and CLIP files
read and written again are the same bytes; trees of every dtype, 0-d and
empty arrays, numpy and Python scalars, strings and bytes of every length
class, lists, complex numbers and chunked arrays give flax's bytes; and
``hf_tree(hf_state_dict(t))`` plus the unused leaves is ``t``, bit for bit
and in the same key order."""

import json
import os

import flax.serialization as fs
import numpy as np
import pytest

from fvd_tpu_torch.models.hf_bert import BertModel
from fvd_tpu_torch.providers import hf_models
from fvd_tpu_torch.utils import msgpack as tmsgpack
from fvd_tpu_torch.weights import HF_UNUSED, hf_state_dict, hf_tree

HF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints", "hf")
KINDS = [("bert", "minilm"), ("whisper", "whisper"), ("clip", "clip")]


def _shipped(kind):
    path = os.path.join(HF, kind, "flax_model.msgpack")
    if not os.path.exists(path):
        pytest.skip(f"{path} is not in this checkout")
    return path


@pytest.mark.parametrize("kind", ["minilm", "whisper", "clip"])
def test_shipped_files_round_trip_byte_for_byte(kind):
    path = _shipped(kind)
    with open(path, "rb") as f:
        data = f.read()
    assert tmsgpack.to_bytes(tmsgpack.read_msgpack(path)) == data


def _trees():
    rng = np.random.RandomState(0)
    dtypes = {str(np.dtype(d)): (rng.randn(3, 4) * 100).astype(d) for d in
              (np.float16, np.float32, np.float64, np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
               np.uint32, np.uint64, np.bool_, np.complex64)}
    return {
        "dtypes": {"params": dtypes},
        "zero_d_and_empty": {"logit_scale": np.array(2.6592, np.float32), "h": np.array(1.5, np.float16),
                             "empty": np.zeros((0, 7), np.float32), "dims": np.arange(24).reshape(1, 2, 3, 4)},
        "scalars": {"f": np.float32(2.25), "i": np.int64(-7), "py_f": 0.5, "py_c": 1 - 2j, "none": None,
                    "t": True, "f_": False},
        "ints": {str(i): v for i, v in enumerate([0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                                                   2 ** 63, -1, -32, -33, -128, -129, -32768, -32769,
                                                   -(2 ** 31), -(2 ** 31) - 1, -(2 ** 63)])},
        "strings": {"s0": "", "s31": "x" * 31, "s32": "y" * 32, "s255": "z" * 255, "s256": "w" * 256,
                    "s70k": "v" * 70000, "u": "café ☺", "b0": b"", "b255": b"\x00" * 255,
                    "b256": b"\xff" * 256, "b70k": b"\x01" * 70000},
        "lists": {"l": [1, -3, 0.5, "txt", [np.ones(2, np.float32), {"k": np.zeros(1)}]] * 4,
                  "t": (np.float32(1), 2)},
        "sizes": {"fixmap": {str(i): np.float32(i) for i in range(15)},
                  "map16": {str(i): np.ones(i % 5, np.float16) for i in range(16)},
                  "ext_fixed": {str(n): np.zeros(n, np.uint8) for n in (1, 2, 4, 8, 16)},
                  "big": rng.randn(300, 300).astype(np.float32)},
    }


@pytest.mark.parametrize("case", sorted(_trees()))
def test_trees_give_flax_bytes(case):
    tree = _trees()[case]
    assert tmsgpack.to_bytes(tree) == fs.to_bytes(tree)


def test_chunked_arrays_give_flax_bytes(monkeypatch):
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tmsgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(10, 10), "small": np.ones(3, np.float64),
            "nested": {"big16": np.arange(70, dtype=np.float16)}}
    data = tmsgpack.to_bytes(tree)
    assert data == fs.to_bytes(tree)
    back = tmsgpack.restore(data)
    np.testing.assert_array_equal(back["big"], tree["big"])
    np.testing.assert_array_equal(back["nested"]["big16"], tree["nested"]["big16"])


def test_write_msgpack_reads_back(tmp_path):
    tree = {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)}, "s": np.array(1.0, np.float16)}
    path = str(tmp_path / "m.msgpack")
    tmsgpack.write_msgpack(path, tree)
    assert os.listdir(tmp_path) == ["m.msgpack"]
    with open(path, "rb") as f:
        assert fs.msgpack_restore(f.read())["a"]["kernel"].tolist() == tree["a"]["kernel"].tolist()


@pytest.mark.parametrize("family,kind", KINDS)
def test_hf_tree_inverts_hf_state_dict(family, kind):
    """Bit for bit and in the same key order, with the unused leaves given
    as ``extra`` or carried in the state dict."""
    path = _shipped(kind)
    tree = tmsgpack.read_msgpack(path)
    with open(path, "rb") as f:
        data = f.read()
    full = hf_state_dict(tree, family, unused=True)
    assert tmsgpack.to_bytes(hf_tree(full, family, dtype=np.float16)) == data
    used = {k: v for k, v in full.items() if k.split(".")[0] not in HF_UNUSED[family]}
    assert used.keys() == hf_state_dict({k: v for k, v in tree.items() if k not in HF_UNUSED[family]}, family).keys()
    extra = {k: tree[k] for k in HF_UNUSED[family]}
    rebuilt = hf_tree(used, family, extra, np.float16)
    assert [p for p, _ in tmsgpack.leaves(rebuilt)] == [p for p, _ in tmsgpack.leaves(tree)]
    for (_, a), (_, b) in zip(tmsgpack.leaves(rebuilt), tmsgpack.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_hf_tree_needs_the_unused_leaves():
    cfg = {"vocab_size": 50, "hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2,
           "intermediate_size": 16, "max_position_embeddings": 16, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
           "hidden_act": "gelu"}
    with pytest.raises(ValueError, match="pooler"):
        hf_tree(BertModel(cfg).state_dict(), "bert")
    model = BertModel(cfg, unused=True)
    tree = hf_tree(model.state_dict(), "bert")
    assert list(tree) == ["embeddings", "encoder", "pooler"]
    np.testing.assert_array_equal(tree["pooler"]["dense"]["kernel"], model.pooler.dense.weight.detach().numpy().T)
    assert tree["embeddings"]["word_embeddings"]["embedding"].shape == (50, 8)
    assert tree["embeddings"]["LayerNorm"]["scale"].shape == (8,)


def test_providers_still_skip_the_unused_leaves(tmp_path):
    """An inference model has no pooler and no ``logit_scale``; a load skips
    them in the file and refuses a checkpoint that lacks any other leaf."""
    path = os.path.dirname(_shipped("minilm"))
    model = BertModel(hf_models._json(path, "config.json"))
    assert not hasattr(model, "pooler")
    hf_models._load(model, path, "bert", "cpu")
    assert not any(k.startswith("pooler") for k in model.state_dict())
    with open(os.path.join(HF, "clip", "config.json")) as f:
        assert not hasattr(hf_models.CLIPModel(json.load(f)), "logit_scale")
    tree = tmsgpack.read_msgpack(os.path.join(path, "flax_model.msgpack"))
    np.testing.assert_array_equal(model.embeddings.word_embeddings.weight.detach().numpy(),
                                  tree["embeddings"]["word_embeddings"]["embedding"].astype(np.float32))
    tree = {k: v for k, v in tree.items() if k != "encoder"}
    os.makedirs(tmp_path / "bad")
    tmsgpack.write_msgpack(str(tmp_path / "bad" / "flax_model.msgpack"), tree)
    with pytest.raises(RuntimeError, match="Missing key"):
        hf_models._load(BertModel(hf_models._json(path, "config.json")), str(tmp_path / "bad"), "bert", "cpu")
