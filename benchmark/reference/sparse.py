"""Plain TF-IDF scoring in float64 with SciPy, and its comparison.

Document weights are log1p(count) * idf(bucket), query weights the same of
the query's counts (or given), and a document's score the sum over the
terms it shares with the query (``tfidf_doc_ranker.py:92-126``). Only the
postings of the terms the queries use are read, so a few thousand queries
score against a million documents in seconds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from benchmark.reference.scale import idf


@dataclass
class TopK:
    scores: np.ndarray  # [q, k] descending, 0 where a query has fewer hits
    lookup: np.ndarray  # [q, m] the reference's score of each doc asked for


class SparseReference:
    """Document-major postings ``(doc, bucket, count)`` of ``num_docs``
    documents over ``hash_size`` buckets."""

    def __init__(self, doc, bucket, count, num_docs: int, hash_size: int):
        self.doc = np.asarray(doc, np.int64)
        self.bucket = np.asarray(bucket, np.int64)
        self.num_docs, self.hash_size = num_docs, hash_size
        self.doc_freqs = np.bincount(self.bucket, minlength=hash_size)
        self.idf = idf(self.doc_freqs, num_docs)
        self.weight = np.log1p(np.asarray(count, np.float64)) * self.idf[self.bucket]

    def query_weights(self, counts, buckets) -> np.ndarray:
        return np.log1p(np.asarray(counts, np.float64)) * self.idf[buckets]

    def topk(self, q_row, q_bucket, q_weight, num_queries: int, k: int, asked) -> TopK:
        """Top-``k`` scores of each query (rows ``q_row`` of the triples)
        and the scores of the docs ``asked`` [q, m] (-1 for none)."""
        union = np.unique(q_bucket)
        table = np.zeros(self.hash_size, bool)
        table[union] = True
        sel = table[self.bucket]
        terms = sp.csr_matrix(
            (self.weight[sel], (np.searchsorted(union, self.bucket[sel]), self.doc[sel])),
            shape=(len(union), self.num_docs))
        queries = sp.csr_matrix(
            (np.asarray(q_weight, np.float64), (q_row, np.searchsorted(union, q_bucket))),
            shape=(num_queries, len(union)))
        scores = (queries @ terms).tocsr()
        scores.sort_indices()
        asked = np.asarray(asked, np.int64)
        top = np.zeros((num_queries, k))
        lookup = np.zeros(asked.shape)
        for q in range(num_queries):
            a, b = scores.indptr[q], scores.indptr[q + 1]
            docs, vals = scores.indices[a:b], scores.data[a:b]
            kk = min(k, len(vals))
            if kk:
                best = -np.partition(-vals, kk - 1)[:kk]
                top[q, :kk] = -np.sort(-best)
            pos = np.searchsorted(docs, asked[q])
            hit = (asked[q] >= 0) & (pos < len(docs))
            hit[hit] &= docs[pos[hit]] == asked[q][hit]
            lookup[q, hit] = vals[pos[hit]]
        return TopK(np.maximum(top, 0.0), lookup)


def score_gap(got_docs: np.ndarray, got_scores: np.ndarray, ref: TopK) -> np.ndarray:
    """Per query: the largest gap, as a share of the query's best reference
    score, between (a) the i-th best returned score and the reference's
    i-th best, a missing result reading 0, and (b) a returned doc's score
    and the reference's score of that doc. ``got_docs`` [q, k] holds -1
    where nothing was returned and -2 for an id that no document has."""
    live = got_docs != -1  # -2: an id the corpus does not hold
    got = np.where(live, got_scores, 0.0).astype(np.float64)
    ranked = -np.sort(-got, axis=1)
    scale = np.where(ref.scores[:, 0] > 0, ref.scores[:, 0], 1.0)[:, None]
    by_rank = np.abs(ranked - ref.scores).max(axis=1)
    by_doc = np.where(live, np.abs(got - ref.lookup), 0.0).max(axis=1)
    return np.maximum(by_rank, by_doc) / scale[:, 0]
