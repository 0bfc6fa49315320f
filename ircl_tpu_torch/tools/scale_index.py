"""Synthetic index at corpus scale: a 1M-doc hashed-bigram index built
directly as postings (text generation at this scale is pointless for a
scoring run), with Zipf document frequencies.

The port's own copy of ``bench_scale.py::synth_index`` and of its query
sampler, so that a run on a CUDA machine needs no module that imports JAX.
The same seed gives the same arrays as the reference's
(``tests/test_torch_scale_index.py``).
"""

from __future__ import annotations

import numpy as np

from ircl_tpu_torch.index.build import assemble_csr
from ircl_tpu_torch.index.tfidf import idf_vector, tfidf_transform


def synth_index(num_docs: int, terms_per_doc: int, vocab: int, hash_size: int, seed=0):
    """Synthetic CountIndex: per doc, ``terms_per_doc`` distinct terms drawn
    Zipf-ish from a vocab of hashed bucket ids; counts 1-3."""
    rng = np.random.default_rng(seed)
    bucket_ids = rng.choice(hash_size, size=vocab, replace=False).astype(np.int64)
    ranks = np.arange(1, vocab + 1)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    # sample per-doc term sets (with replacement across docs)
    draws = rng.choice(vocab, size=(num_docs, terms_per_doc), p=probs)
    # dedup within doc via sort+unique trick per row: keep first occurrence
    srt = np.sort(draws, axis=1)
    keep = np.concatenate(
        [np.ones((num_docs, 1), bool), srt[:, 1:] != srt[:, :-1]], axis=1
    )
    counts = rng.integers(1, 4, size=srt.shape).astype(np.int32)
    doc_of = np.broadcast_to(np.arange(num_docs)[:, None], srt.shape)
    rows = bucket_ids[srt[keep]]
    cols = doc_of[keep].astype(np.int32)
    vals = counts[keep]
    index = assemble_csr(
        rows, cols, vals, hash_size, 2, [str(i) for i in range(num_docs)]
    )
    return tfidf_transform(index)


def synth_queries(index, batch: int, terms: int = 24, seed: int = 7):
    """``bench_scale.py``'s queries: ``terms`` buckets a query drawn
    uniformly from the occupied buckets (real terms across the df spectrum),
    weights by the reference query formula log1p(tf) * idf with tf = 1.
    Returns (buckets [B, terms] int32, weights [B, terms] f32)."""
    rng = np.random.default_rng(seed)
    occupied = np.flatnonzero(index.doc_freqs)
    qb = occupied[rng.integers(0, len(occupied), size=(batch, terms))].astype(np.int32)
    idfs = idf_vector(index.doc_freqs, index.num_docs)
    qw = (np.log1p(1.0) * idfs[qb]).astype(np.float32)
    return qb, qw
