"""The 1M-document index of ``bench_scale.py``, made as raw postings.

A frozen copy of ``synth_index`` and ``synth_queries`` (``bench_scale.py``,
copied by the port as ``tools/scale_index.py``): per document, ``terms``
draws with Zipf weights 1/rank from a vocabulary of ``vocab`` distinct
bucket ids (drawn by rejection-inversion, ``zipf_ranks``, where the source
searches the CDF: the same law in half the time at 96M draws),
deduplicated within the document, each with a count of 1-3;
queries of ``terms`` buckets drawn uniformly from the occupied ones,
weighted log1p(1) * idf. The postings stay document-major
(``Postings``): the program assembles its own index from them, and the
reference scores from them directly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Postings:
    """Document-major postings: doc [nnz] (non-decreasing), bucket [nnz],
    count [nnz]; ``hash_size`` buckets, ``num_docs`` documents."""

    doc: np.ndarray
    bucket: np.ndarray
    count: np.ndarray
    hash_size: int
    num_docs: int

    def doc_freqs(self) -> np.ndarray:
        return np.bincount(self.bucket, minlength=self.hash_size)


def idf(doc_freqs: np.ndarray, num_docs: int) -> np.ndarray:
    """Clipped Robertson-Sparck-Jones idf, float64: max(0, log((N - df +
    0.5) / (df + 0.5)))."""
    df = doc_freqs.astype(np.float64)
    return np.maximum(np.log((num_docs - df + 0.5) / (df + 0.5)), 0.0)


def zipf_ranks(rng: np.random.Generator, n: int, size) -> np.ndarray:
    """Ranks 0..n-1 with P(rank r) proportional to 1/(r + 1), exactly, by
    Hoermann and Derflinger's rejection-inversion for exponent 1 (h(x) =
    1/x, H(x) = log x; under 4% of draws are drawn again)."""
    total = int(np.prod(size))
    out = np.empty(total, np.int64)
    h_x1, h_n = np.log(1.5) - 1.0, np.log(n + 0.5)
    squeeze = 2.0 - np.exp(np.log(2.5) - 0.5)
    todo = np.arange(total)
    while len(todo):
        u = h_n + rng.random(len(todo)) * (h_x1 - h_n)
        x = np.exp(u)
        k = np.clip(np.floor(x + 0.5), 1, n)
        ok = (k - x <= squeeze) | (u >= np.log(k + 0.5) - 1.0 / k)
        out[todo[ok]] = k[ok].astype(np.int64) - 1
        todo = todo[~ok]
    return out.reshape(size)


def synth_postings(num_docs: int, terms_per_doc: int, vocab: int, hash_size: int,
                   seed: int) -> Postings:
    rng = np.random.default_rng(seed)
    bucket_ids = rng.choice(hash_size, size=vocab, replace=False).astype(np.int64)
    draws = zipf_ranks(rng, vocab, (num_docs, terms_per_doc))
    srt = np.sort(draws, axis=1)
    keep = np.concatenate([np.ones((num_docs, 1), bool), srt[:, 1:] != srt[:, :-1]], axis=1)
    counts = rng.integers(1, 4, size=srt.shape)
    doc = np.broadcast_to(np.arange(num_docs)[:, None], srt.shape)[keep]
    return Postings(doc.astype(np.int64), bucket_ids[srt[keep]], counts[keep].astype(np.int64),
                    hash_size, num_docs)


def synth_queries(doc_freqs: np.ndarray, num_docs: int, batch: int, terms: int, seed: int):
    """(buckets [batch, terms] int32, weights [batch, terms] float32). A row
    that drew one bucket twice is drawn again: a query vector, as
    ``text2spvec`` makes it, holds each term once (the source keeps such
    rows, about one in 5,000 at 1M docs)."""
    rng = np.random.default_rng(seed)
    occupied = np.flatnonzero(doc_freqs)
    qb = occupied[rng.integers(0, len(occupied), size=(batch, terms))]
    while True:
        srt = np.sort(qb, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        if not dup.any():
            break
        qb[dup] = occupied[rng.integers(0, len(occupied), size=(int(dup.sum()), terms))]
    qb = qb.astype(np.int32)
    qw = (np.log1p(1.0) * idf(doc_freqs, num_docs)[qb]).astype(np.float32)
    return qb, qw
