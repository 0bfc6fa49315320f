"""The port's synthetic scale index against ``bench_scale.synth_index``
(importing ``bench_scale`` is safe: it imports JAX only inside functions).
Same seed, same arrays."""

import numpy as np
import pytest

import bench_scale
from ircl_tpu.index.tfidf import idf_vector
from ircl_tpu_torch.tools.scale_index import synth_index, synth_queries


@pytest.mark.parametrize("seed", [0, 5])
def test_synth_index_equals_bench_scale(seed):
    args = (2_000, 96, 50_000, 1 << 20)
    want = bench_scale.synth_index(*args, seed=seed)
    got = synth_index(*args, seed=seed)
    assert got.num_docs == 2_000 and got.weighted and got.doc_ids == want.doc_ids
    assert (got.hash_size, got.ngram) == (want.hash_size, want.ngram)
    for f in ("indptr", "post_docs", "post_vals", "doc_freqs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    # every doc holds at most 96 distinct terms, counts 1-3 before weighting
    per_doc = np.bincount(got.post_docs, minlength=2_000)
    assert per_doc.max() <= 96 and per_doc.min() >= 1


def test_synth_queries_equal_bench_scale():
    """``bench_scale.py:131-136``: 24 occupied buckets a query from
    ``default_rng(7)``, weights log1p(1) * idf."""
    index = synth_index(2_000, 96, 50_000, 1 << 20)
    qb, qw = synth_queries(index, 64)
    rng = np.random.default_rng(7)
    occupied = np.flatnonzero(index.doc_freqs)
    want_b = occupied[rng.integers(0, len(occupied), size=(64, 24))].astype(np.int32)
    want_w = (np.log1p(1.0) * idf_vector(index.doc_freqs, index.num_docs)[want_b]).astype(
        np.float32)
    np.testing.assert_array_equal(qb, want_b)
    np.testing.assert_array_equal(qw, want_w)
    assert qb.dtype == np.int32 and qw.dtype == np.float32
