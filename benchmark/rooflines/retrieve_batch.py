"""The work of one batch of sparse retrieval, and the least time it needs.

``batch_work`` counts, from the reference's document frequencies and the
batch's query vectors, what the exact sparse product needs and what the
hybrid engine's parts take as inputs: the union of the heavy terms (df over
the split's threshold) that the membership slabs and the scoring GEMM
cover, the light postings the host pools gather, and every posting of every
query term.
"""

from __future__ import annotations

import numpy as np

from benchmark.rooflines.peaks import least_seconds


def batch_work(row, bucket, weight, doc_freqs, df_threshold: int, batch: int,
               num_docs: int, k: int) -> dict:
    live = np.asarray(weight) != 0
    b = np.asarray(bucket)[live]
    df = doc_freqs[b].astype(np.int64)
    heavy = df > df_threshold
    union = np.unique(b)
    heavy_union = np.unique(b[heavy])
    all_heavy = doc_freqs > df_threshold
    return {
        "B": batch, "N": num_docs, "k": k,
        "entries": int(live.sum()),  # (query, term) pairs
        "U": len(heavy_union),  # heavy terms of the batch
        "pairs": int(df.sum()),  # (query, term, posting) triples
        "union_postings": int(doc_freqs[union].sum()),
        "light_postings": int(df[~heavy].sum()),
        "heavy_index_postings": int(doc_freqs[all_heavy].sum()),
    }


def least(w: dict) -> float:
    """The exact sparse work: each posting of the batch's terms read once
    (doc id and weight), 2 operations a (query, term, posting), the query
    vectors in and the top-k (score and id) out."""
    nbytes = 8 * w["union_postings"] + 8 * w["entries"] + 8 * w["B"] * w["k"]
    return least_seconds(2 * w["pairs"], nbytes)
