"""``fvd_tpu_torch/utils/hf_tokenizers.py`` against the ``transformers``
tokenizers the JAX providers load from ``checkpoints/hf``: token ids and
attention masks equal (exact) on fixed strings and on ``hypothesis`` text
for MiniLM (WordPiece) and CLIP (byte-level BPE); Whisper's decode equal to
``WhisperProcessor.batch_decode(..., skip_special_tokens=True)``; BPE merges
equal to the ``tokenizers`` library's on a tokenizer with merges.

``fvd_tpu_torch/utils/_tokenizer_unicode.py`` lists the characters whose
Unicode class the ``tokenizers`` library (its Rust crates' tables) gives
otherwise than Python's ``unicodedata``; ``python
tests/test_torch_hf_tokenizers.py`` writes it anew from the installed
library, and a test here holds it to the library on every code point.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

pytest.importorskip("transformers")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fvd_tpu_torch.utils import _tokenizer_unicode as unicode_tables  # noqa: E402
from fvd_tpu_torch.utils import hf_tokenizers as ht  # noqa: E402

HF = os.path.join(ROOT, "checkpoints", "hf")
LENGTHS = {"minilm": 128, "clip": 77}

FIXED = [
    "", "Hello, World! it's", "The Ministry said taxes FELL 3.5% in 2023.",
    "Crème brûlée, naïve café, Ångström, ÆØÅ ß ĳ ﬁ", "日本語のテキスト 中文 한국어",
    "tabs\tand\nnew\r\nlines  and   spaces ", "ctrl\x00\x01\x1b\x7f\x85\u200b\ufeff\ufffd chars",
    "[CLS] [PAD] [UNK] <|endoftext|> <|startoftext|> literal specials",
    "'s 't 're 've 'm 'll 'd 'S 'LL don't",
    "ΣΑΣ σας İstanbul ǅ", "½ Ⅻ ① ٣ ๓ 𝟘", "emoji \U0001F600\U0001F44D\U0001F3FD \U0001F9D1\u200d\U0001F33E",
    "word " * 200, "x" * 300, "a" * 100 + " " + "b" * 101,
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers; see
    ``tests/test_torch_train_losses.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tokenizers():
    from transformers import AutoTokenizer

    return {k: (AutoTokenizer.from_pretrained(os.path.join(HF, k)), ht.Tokenizer.from_dir(os.path.join(HF, k)))
            for k in LENGTHS}


def _hf(tok, texts, n):
    enc = tok(list(texts), padding="max_length", truncation=True, max_length=n, return_tensors="np")
    return enc["input_ids"], enc["attention_mask"]


def _check(tokenizers, kind, texts):
    ref, port = tokenizers[kind]
    ids, mask = _hf(ref, texts, LENGTHS[kind])
    got = port(texts, LENGTHS[kind])
    assert got["input_ids"].dtype == ids.dtype and got["attention_mask"].dtype == mask.dtype
    np.testing.assert_array_equal(got["input_ids"], ids)
    np.testing.assert_array_equal(got["attention_mask"], mask)


@pytest.mark.parametrize("kind", sorted(LENGTHS))
def test_fixed_strings_give_the_same_ids_and_masks(tokenizers, kind):
    _check(tokenizers, kind, FIXED)


@pytest.mark.parametrize("kind", sorted(LENGTHS))
@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(texts=st.lists(st.text(max_size=60), min_size=1, max_size=4))
def test_hypothesis_text_gives_the_same_ids_and_masks(tokenizers, kind, texts):
    _check(tokenizers, kind, texts)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.sampled_from(list("ab c'é一") + ["xy", "!?", "12", "\u0301"]), max_size=40).map("".join))
def test_bpe_merges_follow_the_library(tmp_path_factory, text):
    """A byte-level BPE whose merges overlap and chain: ids equal."""
    ref, port = _merges_tokenizer(str(tmp_path_factory.getbasetemp()))
    np.testing.assert_array_equal(port([text], 24)["input_ids"], _hf(ref, [text], 24)[0])


_MERGES_CACHE = {}


def _merges_tokenizer(base):
    if "tok" not in _MERGES_CACHE:
        from transformers import PreTrainedTokenizerFast

        with open(os.path.join(HF, "clip", "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        g = ht.bytes_to_unicode()
        merges = [(g[ord("a")], g[ord("b")]), (g[ord("a")] + g[ord("b")], g[ord("c")]), (g[ord("a")], g[ord("a")]),
                  (g[ord(" ")], g[ord("a")]), (g[ord("b")], g[ord("a")]), ("Ġ", "b"), ("!", "?"),
                  (g[ord("a")] + g[ord("a")], g[ord("a")] + g[ord("a")]), ("1", "2"), ("x", "y")]
        vocab = dict(spec["model"]["vocab"])
        for a, b in merges:
            vocab.setdefault(a + b, len(vocab))
        spec["model"]["vocab"] = vocab
        spec["model"]["merges"] = [f"{a} {b}" for a, b in merges]
        path = os.path.join(base, "merges_tokenizer.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(spec, f)
        ref = PreTrainedTokenizerFast(tokenizer_file=path, pad_token="<|endoftext|>")
        _MERGES_CACHE["tok"] = (ref, ht.Tokenizer(spec, "<|endoftext|>"))
    return _MERGES_CACHE["tok"]


@pytest.fixture(scope="module")
def whisper():
    from transformers import WhisperProcessor

    path = os.path.join(HF, "whisper")
    return WhisperProcessor.from_pretrained(path), ht.Tokenizer.from_dir(path)


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(ids=st.lists(st.integers(0, 51864) | st.sampled_from([0, 1]), max_size=40))
def test_whisper_decode_equals_the_processor(whisper, ids):
    proc, port = whisper
    ref = proc.batch_decode(np.asarray([ids], np.int64).reshape(1, -1), skip_special_tokens=True)[0]
    assert ht.whisper_decode(port, ids) == ref


def test_whisper_decode_of_bytes_strips_specials_and_timestamps(whisper):
    proc, port = whisper
    g = ht.bytes_to_unicode()
    text = "tax <|1.00|> café ÿ"
    ids = [1] + [port.vocab[g[b]] for b in text.encode("utf-8")] + [0, 0]
    ref = proc.batch_decode(np.asarray([ids]), skip_special_tokens=True)[0]
    assert ht.whisper_decode(port, ids) == ref == "tax  café ÿ"
    cut = ids[:-4]   # a multi-byte character cut in half
    assert ht.whisper_decode(port, cut) == proc.batch_decode(np.asarray([cut]), skip_special_tokens=True)[0]


# --- the Unicode tables ---------------------------------------------------
def library_tables():
    """The ranges where the ``tokenizers`` library classes a code point
    otherwise than the port's unicodedata rules do:
    ``(BERT_NORMALIZED, BERT_PUNCT, GPT2_CLASS)``."""
    from tokenizers import normalizers, pre_tokenizers

    chars = [chr(cp) for cp in range(0x110000) if not 0xD800 <= cp <= 0xDFFF and chr(cp) != "|"]
    # BertNormalizer one character at a time: '|' is left alone and no
    # normalization step reaches across it
    norm = normalizers.BertNormalizer(clean_text=True, handle_chinese_chars=True, strip_accents=None, lowercase=True)
    lib = norm.normalize_str("|".join(chars)).split("|")
    base = ht.Tokenizer.from_dir(os.path.join(HF, "minilm"))._normalize_run("|".join(chars)).split("|")
    normalized = {}
    for c, a, b in zip(chars, lib, base):
        if a != b:
            if len(a) > 1:
                raise AssertionError(f"{c!r}: the library gives {a!r}")
            normalized[ord(c)] = unicode_tables.DROP if a == "" else ord(a) - ord(c)

    def piece_ids(pre, text):
        pieces = pre.pre_tokenize_str(text)
        pid = np.full(len(text), -1, np.int64)
        for k, (_, (a, b)) in enumerate(pieces):
            pid[a:b] = k
        return pid

    # BertPreTokenizer: a punctuation character is a piece of its own
    pid = piece_ids(pre_tokenizers.BertPreTokenizer(), "".join("a" + c + "a " for c in chars))
    pos = 4 * np.arange(len(chars)) + 1
    alone = (pid[pos] >= 0) & (pid[pos] != pid[pos - 1]) & (pid[pos] != pid[pos + 1])
    punct = {ord(c): bool(a) for c, a in zip(chars, alone)
             if not c.isspace() and bool(a) != ht.base_bert_punct(c)}

    # GPT-2's split: a character joins the run of a letter, a number or an
    # "other" before it exactly when it is of that class
    byte_level = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    pos = 3 * np.arange(len(chars)) + 1
    same = {}
    for lead in "a1!":
        pid = piece_ids(byte_level, "".join(lead + c + "\x00" for c in chars))
        same[lead] = pid[pos] == pid[pos - 1]
    cls = np.where(same["a"], "L", np.where(same["1"], "N", np.where(same["!"], "o", "s")))
    gpt2 = {ord(c): str(k) for c, k in zip(chars, cls) if str(k) != ht.base_gpt2_class(c)}
    return tuple(_ranges(t) for t in (normalized, punct, gpt2))


def _ranges(table):
    out = []
    for cp in sorted(table):
        if out and out[-1][1] == cp - 1 and out[-1][2] == table[cp]:
            out[-1][1] = cp
        else:
            out.append([cp, cp, table[cp]])
    return [tuple(r) for r in out]


def test_unicode_tables_are_the_library_s():
    assert library_tables() == (unicode_tables.BERT_NORMALIZED, unicode_tables.BERT_PUNCT,
                                unicode_tables.GPT2_CLASS)


def _render(tables) -> str:
    import tokenizers

    def rows(name, table):
        body = "".join(f"    (0x{lo:05X}, 0x{hi:05X}, {v!r}),\n" for lo, hi, v in table)
        return f"{name} = [\n{body}]\n"

    normalized, punct, gpt2 = tables
    return (
        '"""Code points whose Unicode class the ``tokenizers`` library gives otherwise\n'
        "than Python's ``unicodedata`` does (the library's Rust crates carry their own\n"
        "tables, older or newer than Python's), as sorted ``(first, last, value)``\n"
        "ranges for :mod:`fvd_tpu_torch.utils.hf_tokenizers`:\n\n"
        "* ``BERT_NORMALIZED``: what ``BertNormalizer`` (clean text, CJK, accents\n"
        "  stripped, lowercase) makes of the character alone: ``DROP`` or the\n"
        "  offset of the one character it gives;\n"
        "* ``BERT_PUNCT``: whether ``BertPreTokenizer`` isolates it as punctuation;\n"
        "* ``GPT2_CLASS``: its class in GPT-2's split, \"L\", \"N\", \"o\" or \"s\".\n\n"
        f"Written by ``python tests/test_torch_hf_tokenizers.py`` from tokenizers\n"
        f"{tokenizers.__version__} on Python {sys.version_info[0]}.{sys.version_info[1]}; "
        "that test file holds the tables to the library.\n"
        '"""\n\n'
        'DROP = "drop"\n\n'
        + rows("BERT_NORMALIZED", normalized) + "\n" + rows("BERT_PUNCT", punct) + "\n" + rows("GPT2_CLASS", gpt2))


if __name__ == "__main__":
    target = os.path.join(ROOT, "fvd_tpu_torch", "utils", "_tokenizer_unicode.py")
    with open(target, "w", encoding="utf-8") as f:
        f.write(_render(library_tables()))
    print(f"wrote {target}")
