"""TF-IDF weighting of the count index.

Counterpart of ``ircl_tpu/index/tfidf.py``, carried over line for line
apart from imports: ``ircl_tpu.index`` loads JAX through its package
``__init__``, and this port runs where JAX is not installed.

Formula identical to the reference (``preprocessing/drqa/build_tfidf.py:
134-148`` and ``tfidf_doc_ranker.py:92-126``):

    tfidf = log1p(tf) * max(0, log((N - Nt + 0.5) / (Nt + 0.5)))

applied both to index values (document side) and query vectors.
"""

from __future__ import annotations

import numpy as np

from ircl_tpu_torch.index.build import CountIndex


def idf_vector(doc_freqs: np.ndarray, num_docs: int) -> np.ndarray:
    """Clipped Robertson-Sparck-Jones idf per hash bucket."""
    Ns = doc_freqs.astype(np.float64)
    idfs = np.log((num_docs - Ns + 0.5) / (Ns + 0.5))
    idfs[idfs < 0] = 0.0
    return idfs.astype(np.float32)


def doc_freqs_from_postings(index: CountIndex) -> np.ndarray:
    """Docs-per-term vector (reference ``get_doc_freqs``). Because postings
    hold one entry per (term, doc), this is the per-term posting count."""
    return np.diff(index.indptr).astype(np.int32)


def tfidf_transform(index: CountIndex) -> CountIndex:
    """Count postings -> tf-idf postings. Returns a new CountIndex whose
    post_vals are log1p(count) * idf(bucket)."""
    if index.weighted:
        raise ValueError("index is already tf-idf weighted")
    idfs = idf_vector(index.doc_freqs, index.num_docs)
    # Repeat the f32 idf values directly per posting run — identical to
    # materializing int64 term ids and gathering idfs[term], at half the
    # memory traffic and no 80M-element random gather (2.5x at 1M docs on
    # the 1-core host).
    vals = np.log1p(index.post_vals.astype(np.float32)) * np.repeat(
        idfs, np.diff(index.indptr)
    )
    return CountIndex(
        hash_size=index.hash_size,
        ngram=index.ngram,
        doc_ids=index.doc_ids,
        indptr=index.indptr,
        post_docs=index.post_docs,
        post_vals=vals.astype(np.float32),
        doc_freqs=index.doc_freqs,
        weighted=True,
    )
