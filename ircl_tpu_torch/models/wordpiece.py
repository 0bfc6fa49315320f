"""WordPiece tokenizer (offline): greedy longest-match subwords.

Counterpart of ``ircl_tpu/models/wordpiece.py``, carried over line for
line: ``ircl_tpu.models`` loads JAX through its package ``__init__``, and
this port runs where JAX is not installed. The greedy longest-match loop is
the module function ``greedy_pieces``, which the HuggingFace BERT tokenizer
(``models/hf_tokenizer.py``) shares.

One addition: ``encode_batch`` encodes every pair whose texts are both
ASCII in one call of the port's native C++ encoder
(``csrc/wordpiece.cpp::ircl_wordpiece_encode_pairs``, built by
``utils/native_build.py`` when missing or older than its source), which
gives ids, mask and types bit-identical to ``encode_pair``'s. A pair with a
non-ASCII text takes ``encode_pair`` into its own row (the C++ word split
knows only ASCII's character classes), as does the whole batch where the
library cannot be built or loaded. ``native_rows`` and ``python_rows``
count the rows each path encoded.

Replaces the downloaded HF tokenizers the reference relies on
(``contrastive_module.py:32``, ``src/QA/dataset.py:75``). Works from any
vocab: a cached ``vocab.txt`` if one exists locally, or a vocabulary trained
from the corpus (whole words + suffix pieces by frequency) so the whole
framework runs with zero downloads.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ircl_tpu_torch.corpus.tokenizer import default_tokenizer

PAD, UNK, CLS, SEP, MSK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MSK]


def greedy_pieces(word: str, vocab, unk: str = UNK, prefix: str = "##",
                  max_input_chars: int = 100) -> List[str]:
    """Greedy longest-match subwords of ``word``, continuations marked with
    ``prefix``; ``[unk]`` for a word over ``max_input_chars`` characters or
    one with a part no piece matches."""
    if len(word) > max_input_chars:
        return [unk]
    out = []
    start = 0
    while start < len(word):
        end = len(word)
        cur = None
        while start < end:
            sub = word[start:end]
            if start > 0:
                sub = prefix + sub
            if sub in vocab:
                cur = sub
                break
            end -= 1
        if cur is None:
            return [unk]
        out.append(cur)
        start = end
    return out


_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.cache
def _native_encoder():
    """The WordPiece library (``csrc/wordpiece.cpp``), built first if it is
    missing or older than its source, or None where it cannot be."""
    from ircl_tpu_torch.utils.native_build import build_native

    path = build_native(lib="wordpiece")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.ircl_wordpiece_vocab_new.argtypes = [ctypes.c_char_p, _I64P, _I32P,
                                                 ctypes.c_int64]
        lib.ircl_wordpiece_vocab_new.restype = ctypes.c_void_p
        lib.ircl_wordpiece_vocab_free.argtypes = [ctypes.c_void_p]
        lib.ircl_wordpiece_vocab_free.restype = None
        lib.ircl_wordpiece_encode_pairs.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, _I64P, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _I32P, ctypes.POINTER(ctypes.c_float), _I32P]
        lib.ircl_wordpiece_encode_pairs.restype = None
    except (OSError, AttributeError):  # not loadable, or without the symbols
        return None
    return lib


def _packed(texts: List[str]) -> Tuple[bytes, np.ndarray]:
    """ASCII texts back to back, and their offsets (length n+1)."""
    offsets = np.zeros(len(texts) + 1, np.int64)
    np.cumsum([len(t) for t in texts], out=offsets[1:])
    return "".join(texts).encode("ascii"), offsets


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], max_input_chars: int = 100):
        self.vocab = vocab
        self.inv = {i: t for t, i in vocab.items()}
        self.max_input_chars = max_input_chars
        for s in SPECIALS:
            assert s in vocab, f"missing special token {s}"
        self.native_rows = 0
        self.python_rows = 0
        self._table = None  # the native vocabulary table, built on first use

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_table"] = None  # a pointer into this process
        return state

    # -- vocab construction -------------------------------------------------

    @classmethod
    def train(
        cls,
        texts: Iterable[str],
        vocab_size: int = 8192,
        min_count: int = 2,
    ) -> "WordPieceTokenizer":
        """Frequency-based vocab: all chars + frequent words and suffixes."""
        word_counts: Counter = Counter()
        for text in texts:
            for w in default_tokenizer().tokenize(text).words(uncased=True):
                word_counts[w] += 1

        pieces: Counter = Counter()
        for w, c in word_counts.items():
            pieces[w] += c
            for i in range(1, len(w)):
                pieces["##" + w[i:]] += c

        vocab: Dict[str, int] = {s: i for i, s in enumerate(SPECIALS)}
        # single chars first (guarantee tokenizability)
        chars = sorted({ch for w in word_counts for ch in w})
        for ch in chars:
            for tok in (ch, "##" + ch):
                if tok not in vocab:
                    vocab[tok] = len(vocab)
        for tok, c in pieces.most_common():
            if len(vocab) >= vocab_size:
                break
            if c >= min_count and tok not in vocab:
                vocab[tok] = len(vocab)
        return cls(vocab)

    @classmethod
    def from_vocab_file(cls, path: str) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab)

    def save_vocab(self, path: str) -> None:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for tok, _ in sorted(self.vocab.items(), key=lambda kv: kv[1]):
                f.write(tok + "\n")

    # -- tokenization -------------------------------------------------------

    def _wordpiece(self, word: str) -> List[str]:
        return greedy_pieces(word, self.vocab, max_input_chars=self.max_input_chars)

    def tokenize(self, text: str) -> List[str]:
        words = default_tokenizer().tokenize(text).words(uncased=True)
        out: List[str] = []
        for w in words:
            out.extend(self._wordpiece(w))
        return out

    def encode_pair(
        self,
        text_a: str,
        text_b: Optional[str] = None,
        max_length: int = 128,
    ) -> Tuple[List[int], List[int], List[int]]:
        """[CLS] a [SEP] (b [SEP]) with padding: (ids, mask, type_ids)."""
        ta = self.tokenize(text_a)
        tb = self.tokenize(text_b) if text_b is not None else []
        # truncate (longest-first, like HF truncation='longest_first')
        budget = max(max_length - (3 if tb else 2), 0)
        while len(ta) + len(tb) > budget:
            if len(ta) >= len(tb):
                ta = ta[:-1]
            else:
                tb = tb[:-1]
        toks = [CLS] + ta + [SEP]
        types = [0] * len(toks)
        if tb:
            toks += tb + [SEP]
            types += [1] * (len(tb) + 1)
        ids = [self.vocab.get(t, self.vocab[UNK]) for t in toks]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        ids += [self.vocab[PAD]] * pad
        mask += [0] * pad
        types += [0] * pad
        return ids, mask, types

    def _native_table(self):
        """(library, table handle) of this vocabulary, or None without the
        native encoder. The table is freed with the tokenizer."""
        lib = _native_encoder()
        if lib is None:
            return None
        if self._table is None:
            keys = [k for k in self.vocab if k.isascii()]  # no other key can match
            packed, offsets = _packed(keys)
            ids = np.asarray([self.vocab[k] for k in keys], np.int32)
            handle = lib.ircl_wordpiece_vocab_new(
                packed, offsets.ctypes.data_as(_I64P), ids.ctypes.data_as(_I32P), len(keys))
            weakref.finalize(self, lib.ircl_wordpiece_vocab_free, handle)
            self._table = handle
        return lib, self._table

    def encode_batch(
        self,
        pairs: Sequence[Tuple[str, Optional[str]]],
        max_length: int = 128,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``encode_pair`` of every pair, stacked: (ids int32, mask float32,
        types int32). Pairs whose texts are both ASCII are encoded natively
        in one call, the others by ``encode_pair``."""
        rows = [r for r, (a, b) in enumerate(pairs)
                if a.isascii() and (b is None or b.isascii())]
        # under 2, encode_pair's [CLS] [SEP] rows outgrow max_length
        native = self._native_table() if rows and max_length >= 2 else None
        if native is None:
            self.python_rows += len(pairs)
            return self._encode_python(pairs, max_length)
        out = self._encode_native(*native, [pairs[r] for r in rows], max_length)
        self.native_rows += len(rows)
        if len(rows) == len(pairs):
            return out
        rest = sorted(set(range(len(pairs))).difference(rows))
        self.python_rows += len(rest)
        mixed = tuple(np.empty((len(pairs), max_length), x.dtype) for x in out)
        py = self._encode_python([pairs[r] for r in rest], max_length)
        for m, x, y in zip(mixed, out, py):
            m[rows] = x
            m[rest] = y
        return mixed

    def _encode_python(self, pairs, max_length: int):
        ids, masks, types = [], [], []
        for a, b in pairs:
            i, m, t = self.encode_pair(a, b, max_length)
            ids.append(i)
            masks.append(m)
            types.append(t)
        return (
            np.asarray(ids, np.int32),
            np.asarray(masks, np.float32),
            np.asarray(types, np.int32),
        )

    def _encode_native(self, lib, table, pairs, max_length: int):
        packed, offsets = _packed([t or "" for pair in pairs for t in pair])
        ids = np.empty((len(pairs), max_length), np.int32)
        mask = np.empty((len(pairs), max_length), np.float32)
        types = np.empty((len(pairs), max_length), np.int32)
        v = self.vocab
        lib.ircl_wordpiece_encode_pairs(
            table, packed, offsets.ctypes.data_as(_I64P), len(pairs), max_length,
            self.max_input_chars, v[UNK], v[CLS], v[SEP], v[PAD],
            ids.ctypes.data_as(_I32P), mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            types.ctypes.data_as(_I32P))
        return ids, mask, types

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
