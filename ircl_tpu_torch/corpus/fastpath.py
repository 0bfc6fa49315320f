"""Native batch vectorization: text -> hashed-ngram (bucket, count) runs.

Counterpart of ``ircl_tpu/corpus/fastpath.py``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package.

The query/document feature pipeline (tokenize -> 1..n-grams -> filter ->
murmur3 -> unique+counts) is the host-side hot path of both index build and
query serving; per-string Python regex work caps throughput at ~1k texts/s.
The C++ fast path (``native/src/ircl_native.cpp:ircl_vectorize_ascii``)
reproduces it bit-exactly for pure-ASCII input (~100x faster); strings with
non-ASCII bytes fall back to the Python pipeline, so mixed batches stay
exact. Parity is enforced by tests over both paths.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np

from ircl_tpu_torch.corpus import hashing
from ircl_tpu_torch.corpus.filters import filter_ngram, normalize
from ircl_tpu_torch.corpus.tokenizer import default_tokenizer


def _python_vectorize_one(
    text: str, hash_size: int, ngram: int
) -> Tuple[np.ndarray, np.ndarray]:
    tokens = default_tokenizer().tokenize(text)
    grams = tokens.ngrams(n=ngram, uncased=True, filter_fn=filter_ngram)
    if not grams:
        return np.empty(0, np.int64), np.empty(0, np.int32)
    hashed = hashing.hash_tokens(grams, hash_size)
    uniq, counts = np.unique(hashed, return_counts=True)
    return uniq.astype(np.int64), counts.astype(np.int32)


def _native_vectorizer():
    return hashing.get_native(
        "ircl_vectorize_ascii",
        [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ],
        ctypes.c_int64,
    )


def batch_vectorize(
    texts: Sequence[str], hash_size: int, ngram: int = 2, pre_normalized: bool = False
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per text: (sorted unique hashed-ngram buckets, counts).

    Equivalent to the reference's per-doc ``count`` / per-query ``text2spvec``
    hashing stages (``drqa/build_tfidf.py:64-83``,
    ``tfidf_doc_ranker.py:92-126``). Input is NFD-normalized here unless
    ``pre_normalized``.
    """
    if not pre_normalized:
        texts = [normalize(t) for t in texts]

    lib = _native_vectorizer()
    results: List = [None] * len(texts)

    ascii_idx = []
    if lib is not None:
        for i, t in enumerate(texts):
            if t.isascii():
                ascii_idx.append(i)
    if ascii_idx:
        encoded = [texts[i].encode("ascii") for i in ascii_idx]
        offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        packed = b"".join(encoded)
        # Capacity: every char can start at most 2 grams; + slack.
        cap = max(1024, 4 * len(packed) + 64 * len(encoded))
        while True:
            out_b = np.empty(cap, dtype=np.int64)
            out_c = np.empty(cap, dtype=np.int32)
            out_off = np.zeros(len(encoded) + 1, dtype=np.int64)
            n = lib.ircl_vectorize_ascii(
                packed,
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(encoded),
                hash_size,
                ngram,
                out_b.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                out_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                out_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                cap,
            )
            if n >= 0:
                break
            cap *= 2
        for j, i in enumerate(ascii_idx):
            lo, hi = out_off[j], out_off[j + 1]
            results[i] = (out_b[lo:hi].copy(), out_c[lo:hi].copy())

    for i, t in enumerate(texts):
        if results[i] is None:
            results[i] = _python_vectorize_one(t, hash_size, ngram)
    return results
