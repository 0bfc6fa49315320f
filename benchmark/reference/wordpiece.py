"""Frozen WordPiece: the vocabulary trained from a corpus, and pair ids.

The reference's own copy of the WordPiece the verdict classifier reads its
pairs with: a vocabulary of the five specials, every character alone and
as a continuation, then whole words and ``##`` suffixes by corpus
frequency (ties in first-seen order) down to ``min_count``, up to
``vocab_size``; greedy longest-match pieces; ``[CLS] a [SEP] b [SEP]``,
truncated longest-first to ``max_length`` and padded with ``[PAD]``, with
token type 1 on ``b [SEP]`` and 0 elsewhere. Words
are the simple tokenizer's, uncased (``text.tokens``), on ASCII text.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from benchmark.reference.text import ascii_only, tokens

PAD, UNK, CLS, SEP, MSK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MSK]


def train(texts: Sequence[str], vocab_size: int, min_count: int) -> Dict[str, int]:
    ascii_only(texts)
    word_counts: Counter = Counter()
    for t in texts:
        word_counts.update(tokens(t))
    pieces: Counter = Counter()
    for w, c in word_counts.items():
        pieces[w] += c
        for i in range(1, len(w)):
            pieces["##" + w[i:]] += c
    vocab = {s: i for i, s in enumerate(SPECIALS)}
    for ch in sorted({ch for w in word_counts for ch in w}):
        for tok in (ch, "##" + ch):
            vocab.setdefault(tok, len(vocab))
    for tok, c in pieces.most_common():
        if len(vocab) >= vocab_size:
            break
        if c >= min_count and tok not in vocab:
            vocab[tok] = len(vocab)
    return vocab


def pieces(word: str, vocab: Dict[str, int], max_chars: int = 100) -> List[str]:
    if len(word) > max_chars:
        return [UNK]
    out, start = [], 0
    while start < len(word):
        end = len(word)
        while end > start:
            sub = word[start:end] if start == 0 else "##" + word[start:end]
            if sub in vocab:
                out.append(sub)
                break
            end -= 1
        else:
            return [UNK]
        start = end
    return out


def encode_pairs(pairs: Sequence[Tuple[str, str]], vocab: Dict[str, int], max_length: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ids [n, L] int64, mask [n, L] float32, types [n, L] int64) of each
    (claim, evidence)."""
    ids = np.full((len(pairs), max_length), vocab[PAD], np.int64)
    mask = np.zeros((len(pairs), max_length), np.float32)
    types = np.zeros((len(pairs), max_length), np.int64)
    for r, (a, b) in enumerate(pairs):
        ascii_only([a, b])
        ta = [p for w in tokens(a) for p in pieces(w, vocab)]
        tb = [p for w in tokens(b) for p in pieces(w, vocab)]
        budget = max(max_length - (3 if tb else 2), 0)
        while len(ta) + len(tb) > budget:
            if len(ta) >= len(tb):
                ta.pop()
            else:
                tb.pop()
        toks = [CLS] + ta + [SEP] + (tb + [SEP] if tb else [])
        ids[r, :len(toks)] = [vocab.get(t, vocab[UNK]) for t in toks]
        mask[r, :len(toks)] = 1.0
        types[r, len(ta) + 2:len(toks)] = 1
    return ids, mask, types
