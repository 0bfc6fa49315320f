"""WordPiece tokenizer (offline): greedy longest-match subwords.

Counterpart of ``ircl_tpu/models/wordpiece.py``, carried over line for
line: ``ircl_tpu.models`` loads JAX through its package ``__init__``, and
this port runs where JAX is not installed. The greedy longest-match loop is
the module function ``greedy_pieces``, which the HuggingFace BERT tokenizer
(``models/hf_tokenizer.py``) shares.

Replaces the downloaded HF tokenizers the reference relies on
(``contrastive_module.py:32``, ``src/QA/dataset.py:75``). Works from any
vocab: a cached ``vocab.txt`` if one exists locally, or a vocabulary trained
from the corpus (whole words + suffix pieces by frequency) so the whole
framework runs with zero downloads.
"""

from __future__ import annotations

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


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], max_input_chars: int = 100):
        self.vocab = vocab
        self.inv = {i: t for t, i in vocab.items()}
        self.max_input_chars = max_input_chars
        for s in SPECIALS:
            assert s in vocab, f"missing special token {s}"

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

    def encode_batch(
        self,
        pairs: Sequence[Tuple[str, Optional[str]]],
        max_length: int = 128,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
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

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
