"""The three Hugging Face tokenizers of ``checkpoints/hf``, read from their
``tokenizer.json`` for a machine without ``transformers`` or ``tokenizers``.

:class:`Tokenizer` implements the pieces those files name, as the
``tokenizers`` library runs them, and raises on any other:

* added tokens: the special tokens (``"normalized": false``) are found in
  the raw text first, longest match leftmost, and keep their ids;
* normalizer ``BertNormalizer`` (MiniLM): drop NUL, U+FFFD and control
  characters, whitespace to a space, spaces around CJK ideographs, NFD with
  the nonspacing marks removed when ``strip_accents`` is true or (null and)
  ``lowercase`` is, then lowercase character by character (so a final
  capital sigma becomes σ, as Rust's ``char::to_lowercase`` gives);
* pre-tokenizers ``BertPreTokenizer`` (split on whitespace, punctuation
  isolated) and ``ByteLevel`` with GPT-2's split (``'s|'t|'re|'ve|'m|'ll|'d|
  ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, written out
  with :mod:`unicodedata` because the ``re`` module has no ``\\p{...}``),
  alone or in a ``Sequence``;
* models ``WordPiece`` (greedy longest match, ``##`` continuations, the
  unknown token for a word past ``max_input_chars_per_word`` or with a piece
  out of the vocabulary) and ``BPE`` over the byte alphabet with the file's
  merges (an empty list here, so a word is its bytes);
* post-processor ``TemplateProcessing`` of a single sequence;
* decoder ``ByteLevel`` (Whisper's transcripts).

``__call__`` is what the JAX providers get from ``tok(texts,
padding="max_length", truncation=True, max_length=n, return_tensors="np")``:
the sequence cut to leave room for the template's special tokens, padded
with the pad token, int64 ids and attention mask.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from fvd_tpu_torch.utils import _tokenizer_unicode as _unicode

#: Unicode's White_Space property: ``char::is_whitespace`` and Oniguruma's ``\s``
_WHITESPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
                        "\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")

_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
               (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_control(c: str) -> bool:
    return c not in "\t\n\r" and unicodedata.category(c) in ("Cc", "Cf", "Co", "Cs")


def _is_cjk(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _override(table, c: str):
    """The value ``table`` (sorted ``(lo, hi, value)`` ranges) gives ``c``,
    else None."""
    cp = ord(c)
    k = bisect.bisect_right(table, (cp, 0x110000)) - 1
    if k >= 0 and table[k][0] <= cp <= table[k][1]:
        return table[k][2]
    return None


def base_bert_punct(c: str) -> bool:
    """``BertPreTokenizer``'s punctuation test on unicodedata's tables."""
    return (c.isascii() and not c.isalnum() and c.isprintable() and c != " ") \
        or unicodedata.category(c)[0] == "P"


def _is_bert_punct(c: str) -> bool:
    fixed = _override(_unicode.BERT_PUNCT, c)
    return base_bert_punct(c) if fixed is None else fixed


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 bytes to printable characters."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) \
        + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def base_gpt2_class(c: str) -> str:
    """GPT-2 split class of a character on unicodedata's tables: "s"
    whitespace, "L" letter, "N" number or "o" other."""
    if c in _WHITESPACE:
        return "s"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "o"


def _class(c: str) -> str:
    fixed = _override(_unicode.GPT2_CLASS, c)
    return base_gpt2_class(c) if fixed is None else fixed


_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def gpt2_split(text: str) -> List[str]:
    """``text`` split by GPT-2's pattern, the alternatives tried in order."""
    out: List[str] = []
    i, n = 0, len(text)
    cls = [_class(c) for c in text]
    while i < n:
        if text[i] == "'":
            hit = next((s for s in _CONTRACTIONS if text.startswith(s, i + 1)), None)
            if hit:
                out.append(text[i:i + 1 + len(hit)])
                i += 1 + len(hit)
                continue
        start = i
        if text[i] == " " and i + 1 < n and cls[i + 1] != "s":
            i += 1                       # ' ?' before a letter, number or other run
        if cls[i] != "s":
            kind = cls[i]
            while i < n and cls[i] == kind:
                i += 1
            out.append(text[start:i])
            continue
        j = i
        while j < n and cls[j] == "s":
            j += 1
        # \s+(?!\S) backs off one character before a non-space; a single
        # space before one is \s+ alone
        end = j if j == n or j - i == 1 else j - 1
        out.append(text[i:end])
        i = end
    return out


class Tokenizer:
    """A ``tokenizer.json`` of the kinds the module docstring lists, with the
    pad token of ``tokenizer_config.json``."""

    def __init__(self, spec: dict, pad_token: str = None):
        self.spec = spec
        self.added = {t["content"]: t["id"] for t in spec.get("added_tokens") or []}
        self.special_ids = {t["id"] for t in spec.get("added_tokens") or [] if t.get("special")}
        self._split_on = sorted((t["content"] for t in spec.get("added_tokens") or []
                                 if not t.get("normalized", True)), key=len, reverse=True)
        if any(t.get("normalized", True) for t in spec.get("added_tokens") or []):
            raise NotImplementedError("added tokens matched after normalization")
        model = spec["model"]
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})
        self.unk_id = self.vocab.get(model.get("unk_token")) if model.get("unk_token") else None
        self.model_type = model["type"]
        if self.model_type == "BPE":
            for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
                if model.get(key):
                    raise NotImplementedError(f"BPE with {key}")
            if model.get("byte_fallback") or model.get("ignore_merges") or model.get("fuse_unk"):
                raise NotImplementedError("BPE with byte_fallback, ignore_merges or fuse_unk")
            merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in model["merges"]]
            self.ranks = {m: r for r, m in enumerate(merges)}
        elif self.model_type != "WordPiece":
            raise NotImplementedError(f"tokenizer model {self.model_type}")
        self.normalizer = spec.get("normalizer")
        if self.normalizer and self.normalizer["type"] != "BertNormalizer":
            raise NotImplementedError(f"normalizer {self.normalizer['type']}")
        pre = spec.get("pre_tokenizer")
        pres = pre["pretokenizers"] if pre and pre["type"] == "Sequence" else [pre] if pre else []
        for p in pres:
            if p["type"] == "ByteLevel" and (p.get("add_prefix_space") or not p.get("use_regex", True)):
                raise NotImplementedError("ByteLevel pre-tokenizer other than GPT-2's split")
            if p["type"] not in ("ByteLevel", "BertPreTokenizer"):
                raise NotImplementedError(f"pre-tokenizer {p['type']}")
        self.pre_tokenizers = [p["type"] for p in pres]
        post = spec.get("post_processor")
        self.prefix: List[int] = []
        self.suffix: List[int] = []
        if post:
            if post["type"] != "TemplateProcessing":
                raise NotImplementedError(f"post-processor {post['type']}")
            seen = False
            for piece in post["single"]:
                if "Sequence" in piece:
                    seen = True
                    continue
                ids = post["special_tokens"][piece["SpecialToken"]["id"]]["ids"]
                (self.suffix if seen else self.prefix).extend(ids)
        self.pad_id = self.added.get(pad_token, self.vocab.get(pad_token)) if pad_token else None
        dec = spec.get("decoder")
        if dec and dec["type"] != "ByteLevel":
            raise NotImplementedError(f"decoder {dec['type']}")
        self.byte_level = "ByteLevel" in self.pre_tokenizers or (dec or {}).get("type") == "ByteLevel"

    @classmethod
    def from_dir(cls, path: str) -> "Tokenizer":
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        pad = None
        cfg = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg):
            with open(cfg, encoding="utf-8") as f:
                pad = json.load(f).get("pad_token")
            if isinstance(pad, dict):
                pad = pad["content"]
        return cls(spec, pad)

    # -- encode ------------------------------------------------------------
    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """``text`` cut at the special tokens: ``(piece, is_added)`` pairs."""
        out: List[Tuple[str, bool]] = []
        i = last = 0
        while i < len(text):
            hit = next((t for t in self._split_on if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            if i > last:
                out.append((text[last:i], False))
            out.append((hit, True))
            i = last = i + len(hit)
        if last < len(text):
            out.append((text[last:], False))
        return out

    def _normalize(self, text: str) -> str:
        if not self.normalizer:
            return text
        # characters the library's Unicode tables see otherwise than
        # unicodedata does take the library's output as they are
        out, run = [], []
        for c in text:
            fixed = _override(_unicode.BERT_NORMALIZED, c)
            if fixed is None:
                run.append(c)
                continue
            out.append(self._normalize_run("".join(run)))
            run = []
            out.append("" if fixed == _unicode.DROP else chr(ord(c) + fixed))
        out.append(self._normalize_run("".join(run)))
        return "".join(out)

    def _normalize_run(self, text: str) -> str:
        """The normalizer on unicodedata's tables."""
        n = self.normalizer
        if n.get("clean_text", True):
            text = "".join(" " if c in _WHITESPACE else c for c in text
                           if not (c in "\x00\ufffd" or _is_control(c)))
        if n.get("handle_chinese_chars", True):
            text = "".join(f" {c} " if _is_cjk(c) else c for c in text)
        strip = n.get("strip_accents")
        if strip or (strip is None and n.get("lowercase", True)):
            text = "".join(c for c in unicodedata.normalize("NFD", text) if unicodedata.category(c) != "Mn")
        if n.get("lowercase", True):
            text = "".join(c.lower() for c in text)
        return text

    def _pre_tokenize(self, text: str) -> List[str]:
        words = [text]
        for kind in self.pre_tokenizers:
            nxt: List[str] = []
            for w in words:
                if kind == "BertPreTokenizer":
                    cur = ""
                    for c in w:
                        if c in _WHITESPACE:
                            if cur:
                                nxt.append(cur)
                            cur = ""
                        elif _is_bert_punct(c):
                            if cur:
                                nxt.append(cur)
                            nxt.append(c)
                            cur = ""
                        else:
                            cur += c
                    if cur:
                        nxt.append(cur)
                else:
                    table = bytes_to_unicode()
                    nxt += ["".join(table[b] for b in piece.encode("utf-8")) for piece in gpt2_split(w)]
            words = nxt
        return words

    def _wordpiece(self, word: str) -> List[int]:
        model = self.spec["model"]
        if len(word) > model.get("max_input_chars_per_word", 100):
            return [self.unk_id]
        prefix = model.get("continuing_subword_prefix", "##")
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            while start < end:
                piece = word[start:end] if start == 0 else prefix + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            if start == end:
                return [self.unk_id]
            start = end
        return ids

    def _bpe(self, word: str) -> List[int]:
        parts = list(word)
        while len(parts) > 1:
            ranked = [(self.ranks[p], k) for k, p in enumerate(zip(parts, parts[1:])) if p in self.ranks]
            if not ranked:
                break
            at = min(ranked)[1]                  # the best-ranked pair, leftmost
            first, second = parts[at], parts[at + 1]
            merged: List[str] = []
            k = 0
            while k < len(parts):
                if k + 1 < len(parts) and parts[k] == first and parts[k + 1] == second:
                    merged.append(first + second)
                    k += 2
                else:
                    merged.append(parts[k])
                    k += 1
            parts = merged
        ids = [self.vocab.get(p, self.unk_id) for p in parts]
        if None in ids:
            raise KeyError(f"{word!r}: a piece is out of the vocabulary and there is no unknown token")
        return ids

    def encode_ids(self, text: str) -> List[int]:
        """The ids of ``text`` without the template's special tokens."""
        model = self._wordpiece if self.model_type == "WordPiece" else self._bpe
        ids: List[int] = []
        for piece, is_added in self._split_added(text):
            if is_added:
                ids.append(self.added[piece])
                continue
            for word in self._pre_tokenize(self._normalize(piece)):
                ids += model(word)
        return ids

    def __call__(self, texts: Sequence[str], max_length: int) -> Dict[str, np.ndarray]:
        """``input_ids`` and ``attention_mask`` [len(texts), max_length]
        int64: each text cut to fit the template, padded to the length."""
        room = max_length - len(self.prefix) - len(self.suffix)
        ids = np.full((len(texts), max_length), self.pad_id, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            row = self.prefix + self.encode_ids(text)[:room] + self.suffix
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    # -- decode ------------------------------------------------------------
    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        """ByteLevel decode of ``ids``: tokens joined, characters mapped back
        to bytes (a token with a character outside the byte alphabet as its
        UTF-8), invalid UTF-8 replaced by U+FFFD."""
        if not self.byte_level:
            raise NotImplementedError("decode of a tokenizer without a ByteLevel decoder")
        inverse = {c: b for b, c in bytes_to_unicode().items()}
        out = bytearray()
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self.special_ids:
                continue
            token = self.id_to_token[i]
            if all(c in inverse for c in token):
                out += bytes(inverse[c] for c in token)
            else:
                out += token.encode("utf-8")
        return out.decode("utf-8", errors="replace")


#: ``WhisperTokenizer.timestamp_pat``: decoded text loses such spans
_TIMESTAMP = re.compile(r"<\|(\d+\.\d+)\|>")


def whisper_decode(tok: Tokenizer, ids: Sequence[int]) -> str:
    """``WhisperTokenizerFast.decode(ids, skip_special_tokens=True)``: a
    sequence that starts with the ``<|startofprev|>`` id (the unknown id
    where the vocabulary has none) keeps only what follows its
    ``<|startoftranscript|>``, the specials go, and timestamp spans are cut
    from the text."""
    ids = [int(i) for i in ids]
    prompt = tok.added.get("<|startofprev|>", tok.vocab.get("<|startofprev|>", tok.unk_id))
    start = tok.added.get("<|startoftranscript|>", tok.vocab.get("<|startoftranscript|>", tok.unk_id))
    if ids and ids[0] == prompt:
        ids = ids[ids.index(start):] if start in ids else []
    return _TIMESTAMP.sub("", tok.decode(ids, skip_special_tokens=True))
