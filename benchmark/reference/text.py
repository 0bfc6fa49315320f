"""Frozen text features of the sparse index: tokens, ngrams, hashes, counts.

The retrieval references' own copy of the feature pipeline that DrQA's
``build_tfidf.py`` fixes (``count``, ``text2spvec``): the simple tokenizer
(alphanumeric runs, else one non-space character), uncased 1..2-grams with
the "any" filter (drop a gram that holds a stopword or a punctuation-only
token), MurmurHash3 x86_32 with seed 0 of the gram's UTF-8 bytes, modulo the
number of buckets. It is written for the benchmark's generated text, which
is ASCII: ``ascii_only`` refuses anything else rather than guess at the
Unicode classes. The hash runs over NumPy arrays, a length group at a time,
so that a corpus's million distinct grams hash in a second; ``murmur3_32``'s
scalar twin in the tests holds it to the published algorithm.

Nothing here imports the program: the reference rebuilds what the program
derived from the same text.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

STOPWORDS = frozenset({
    'i', 'me', 'my', 'myself', 'we', 'our', 'ours', 'ourselves', 'you', 'your',
    'yours', 'yourself', 'yourselves', 'he', 'him', 'his', 'himself', 'she',
    'her', 'hers', 'herself', 'it', 'its', 'itself', 'they', 'them', 'their',
    'theirs', 'themselves', 'what', 'which', 'who', 'whom', 'this', 'that',
    'these', 'those', 'am', 'is', 'are', 'was', 'were', 'be', 'been', 'being',
    'have', 'has', 'had', 'having', 'do', 'does', 'did', 'doing', 'a', 'an',
    'the', 'and', 'but', 'if', 'or', 'because', 'as', 'until', 'while', 'of',
    'at', 'by', 'for', 'with', 'about', 'against', 'between', 'into', 'through',
    'during', 'before', 'after', 'above', 'below', 'to', 'from', 'up', 'down',
    'in', 'out', 'on', 'off', 'over', 'under', 'again', 'further', 'then',
    'once', 'here', 'there', 'when', 'where', 'why', 'how', 'all', 'any',
    'both', 'each', 'few', 'more', 'most', 'other', 'some', 'such', 'no', 'nor',
    'not', 'only', 'own', 'same', 'so', 'than', 'too', 'very', 's', 't', 'can',
    'will', 'just', 'don', 'should', 'now', 'd', 'll', 'm', 'o', 're', 've',
    'y', 'ain', 'aren', 'couldn', 'didn', 'doesn', 'hadn', 'hasn', 'haven',
    'isn', 'ma', 'mightn', 'mustn', 'needn', 'shan', 'shouldn', 'wasn', 'weren',
    'won', 'wouldn', "'ll", "'re", "'ve", "n't", "'s", "'d", "'m", "''", "``",
})

# On ASCII text the simple tokenizer's classes are: letters and digits for
# [\p{L}\p{N}\p{M}]+, and any printable non-space character for
# [^\p{Z}\p{C}] (space is Zs; \x00-\x1f and \x7f are Cc).
TOKEN_RE = re.compile(r"[A-Za-z0-9]+|[!-~]")
PUNCT = frozenset(c for c in map(chr, range(128)) if unicodedata.category(c).startswith("P"))


def ascii_only(texts: Sequence[str]) -> None:
    bad = next((i for i, t in enumerate(texts) if not t.isascii()), None)
    if bad is not None:
        raise ValueError(f"text {bad} is not ASCII: the reference tokenizer reads ASCII only")


def tokens(text: str) -> List[str]:
    """The simple tokenizer's words of an ASCII text, uncased."""
    return [w.lower() for w in TOKEN_RE.findall(text)]


def filtered(word: str) -> bool:
    """A stopword or a token of punctuation alone."""
    return word in STOPWORDS or all(c in PUNCT for c in word)


_C1, _C2 = np.uint32(0xCC9E2D51), np.uint32(0x1B873593)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def murmur3_32(keys: Sequence[bytes], seed: int = 0) -> np.ndarray:
    """MurmurHash3 x86_32 of each key, unsigned, as ``uint32``."""
    n = len(keys)
    out = np.empty(n, np.uint32)
    if not n:
        return out
    lens = np.fromiter(map(len, keys), np.int64, n)
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    buf = np.frombuffer(b"".join(keys) + b"\0", np.uint8)
    for length in np.unique(lens):
        idx = np.flatnonzero(lens == length)
        rows = buf[starts[idx, None] + np.arange(length)].astype(np.uint32)
        h = np.full(len(idx), seed, np.uint32)
        nblocks = int(length) // 4
        for b in range(nblocks):
            k = (rows[:, 4 * b] | (rows[:, 4 * b + 1] << np.uint32(8))
                 | (rows[:, 4 * b + 2] << np.uint32(16)) | (rows[:, 4 * b + 3] << np.uint32(24)))
            k = _rotl(k * _C1, 15) * _C2
            h = _rotl(h ^ k, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        tail = int(length) & 3
        if tail:
            k = np.zeros(len(idx), np.uint32)
            for j in reversed(range(tail)):
                k ^= rows[:, 4 * nblocks + j] << np.uint32(8 * j)
            h ^= _rotl(k * _C1, 15) * _C2
        h ^= np.uint32(length)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
        out[idx] = h
    return out


def hashed_counts(texts: Sequence[str], hash_size: int, max_terms: int | None = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every text's hashed 1..2-gram counts, text-major and bucket-sorted:
    ``(text index, bucket, count)`` as int64, int64, int64 arrays.
    ``max_terms`` keeps a text's first (smallest) buckets only, as a query
    vector padded to that many terms keeps them."""
    ascii_only(texts)
    vocab: Dict[str, int] = {}
    ids: List[int] = []
    lens = np.empty(len(texts), np.int64)
    for i, t in enumerate(texts):
        ws = tokens(t)
        lens[i] = len(ws)
        ids.extend(vocab.setdefault(w, len(vocab)) for w in ws)
    words = list(vocab)
    tok = np.asarray(ids, np.int64)
    text_of = np.repeat(np.arange(len(texts), dtype=np.int64), lens)
    keep = ~np.fromiter(map(filtered, words), bool, len(words))
    uni_hash = murmur3_32([w.encode() for w in words]).astype(np.int64) % hash_size

    live = keep[tok]
    uni_text, uni_bucket = text_of[live], uni_hash[tok[live]]
    # bigrams: neighbours in one text, neither token filtered
    pair = live[:-1] & live[1:] & (text_of[:-1] == text_of[1:])
    codes = tok[:-1][pair] * len(words) + tok[1:][pair]
    uniq, inv = np.unique(codes, return_inverse=True)
    grams = [f"{words[c // len(words)]} {words[c % len(words)]}".encode() for c in uniq.tolist()]
    bi_bucket = (murmur3_32(grams).astype(np.int64) % hash_size)[inv]
    bi_text = text_of[:-1][pair]

    key = np.concatenate([uni_text, bi_text]) * hash_size + np.concatenate([uni_bucket, bi_bucket])
    key, count = np.unique(key, return_counts=True)
    text_idx, bucket = key // hash_size, key % hash_size
    if max_terms is not None:
        first = np.searchsorted(text_idx, np.arange(len(texts)))
        rank = np.arange(len(key)) - first[text_idx]
        sel = rank < max_terms
        text_idx, bucket, count = text_idx[sel], bucket[sel], count[sel]
    return text_idx, bucket, count.astype(np.int64)
