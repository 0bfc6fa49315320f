"""Chunked hybrid ranker: ``ircl_tpu_torch.index.chunked`` against
``ircl_tpu.index.chunked`` and against the port's single rankers.

Mirrors ``tests/test_chunked.py``. Doc-range slices are integer selections
and copies: equal to the reference's arrays. Ranked scores within rtol 1e-5
(each chunk's GEMM sums in another order), ids equal above the k-th score.
"""

import os

import numpy as np
import pytest

from _torch_parity import assert_topk_match, one_torch_thread  # noqa: F401
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.index import chunked as j_ch
from ircl_tpu.index.split import load_split as j_load_split
from ircl_tpu_torch.index import chunked as t_ch
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.chunked import ChunkedHybridRanker, slice_doc_range
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform


def _corpus(n, claims, seed, hash_size=1 << 20):
    wiki = generate(num_docs=n, num_claims=claims, seed=seed)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=hash_size))
    return index, [c.claim for c in wiki.claims]


@pytest.fixture(scope="module")
def setup():
    return _corpus(300, 60, 5)


def _same_index(a, b):
    assert (a.hash_size, a.ngram, a.doc_ids, a.weighted) == (
        b.hash_size, b.ngram, b.doc_ids, b.weighted)
    for f in ("indptr", "post_docs", "post_vals", "doc_freqs"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f


def test_slice_doc_range_partitions(setup):
    index, _ = setup
    a = slice_doc_range(index, 0, 120)
    b = slice_doc_range(index, 120, 300)
    assert a.num_docs == 120 and b.num_docs == 180
    assert a.nnz + b.nnz == index.nnz
    np.testing.assert_array_equal(a.doc_freqs + b.doc_freqs, index.doc_freqs)
    # per-chunk postings renumbered into the local range
    assert a.post_docs.max(initial=0) < 120
    assert b.post_docs.max(initial=0) < 180


@pytest.mark.parametrize("lo,hi", [(0, 120), (120, 300), (299, 300), (0, 300)])
def test_slice_doc_range_equals_the_reference(setup, lo, hi):
    """The native and the numpy slice of the port, and the reference's."""
    index, _ = setup
    want = j_ch.slice_doc_range(index, lo, hi)
    _same_index(slice_doc_range(index, lo, hi), want)
    _same_index(t_ch._slice_doc_range_np(index, lo, hi),
                j_ch._slice_doc_range_np(index, lo, hi))
    got_np = t_ch._slice_doc_range_np(index, lo, hi)
    np.testing.assert_array_equal(got_np.post_docs, want.post_docs)
    np.testing.assert_array_equal(got_np.post_vals, want.post_vals)


def _assert_ranked_like(got, want):
    for (ids_r, sc_r), (ids_c, sc_c) in zip(want, got):
        assert len(sc_c) == len(sc_r)
        np.testing.assert_allclose(np.sort(sc_c), np.sort(sc_r), rtol=1e-5, atol=1e-6)
        # ids agree above the k-th score (cut ties are engine-dependent)
        cut = float(np.min(sc_r)) * (1 + 1e-4) + 1e-4 if len(sc_r) else 0.0
        assert {d for d, s in zip(ids_c, sc_c) if s > cut} == {
            d for d, s in zip(ids_r, sc_r) if s > cut}


@pytest.mark.parametrize("chunk_docs", [97, 150])
def test_chunked_matches_single_ranker(setup, chunk_docs):
    index, claims = setup
    ref = TfidfRanker(index, "cpu", mode="ragged")
    chunked = ChunkedHybridRanker(
        index, "cpu", chunk_docs=chunk_docs, df_threshold=8, width_buckets=2
    )
    assert len(chunked.chunks) == -(-300 // chunk_docs)
    assert all(c.device.type == "cpu" for c in chunked.chunks)
    _assert_ranked_like(chunked.closest_docs_batch(claims, k=5),
                        ref.closest_docs_batch(claims, k=5))


@pytest.mark.parametrize("kw", [
    dict(df_threshold=8),
    dict(df_threshold=8, width_buckets=2, select_rescore=64),
], ids=["wb1", "wb2_select64"])
def test_chunked_matches_jax_chunked(setup, kw, monkeypatch):
    """Both packages' chunked rankers, chunks served by the staged engine."""
    from ircl_tpu.index.ranker import TfidfRanker as JaxRanker

    monkeypatch.setattr(TfidfRanker, "FUSED_LIGHT_MAX_DOCS", 10)
    monkeypatch.setattr(JaxRanker, "FUSED_LIGHT_MAX_DOCS", 10)
    index, claims = setup
    claims = claims[:24]
    want = j_ch.ChunkedHybridRanker(index, chunk_docs=120, **kw)
    got = ChunkedHybridRanker(index, "cpu", chunk_docs=120, **kw)
    assert got.offsets == want.offsets == [0, 120, 240]
    b, w = got._vectorize(claims)
    jb, jw = want._vectorize(claims)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(w, jw)
    s, i = got.hybrid_from_vectors(b, w, 5)
    js, ji = want.hybrid_from_vectors(jb, jw, 5)
    assert_topk_match(s, i, js, ji)


@pytest.mark.parametrize("seed", [0, 1])
def test_chunked_fuzz_random_boundaries(seed):
    """Random corpus sizes x random chunk widths (including a last chunk of
    width 1 and chunk_docs > num_docs) stay parity-exact vs the single
    ragged ranker, with random df thresholds and k."""
    rng = np.random.default_rng(40 + seed)
    for _ in range(3):
        n = int(rng.integers(30, 260))
        index, claims = _corpus(n, 12, int(rng.integers(1e6)), 1 << 18)
        k = int(rng.integers(1, 7))
        # bias toward awkward boundaries: n-1 gives a width-1 last chunk,
        # n+5 a single chunk wider than the corpus
        chunk_docs = int(rng.choice([n - 1, n + 5, rng.integers(7, n + 1)]))
        df = int(rng.integers(2, 24))
        ref = TfidfRanker(index, "cpu", mode="ragged")
        chunked = ChunkedHybridRanker(index, "cpu", chunk_docs=chunk_docs, df_threshold=df)
        _assert_ranked_like(chunked.closest_docs_batch(claims, k=k),
                            ref.closest_docs_batch(claims, k=k))


def test_chunked_split_cache_roundtrip(setup, tmp_path):
    """split_cache_dir: first construction persists per-chunk artifacts,
    a second construction loads them (bit-identical results), a df
    mismatch is rejected."""
    index, claims = setup
    cache = str(tmp_path / "splits")
    a = ChunkedHybridRanker(index, "cpu", chunk_docs=120, df_threshold=8,
                            split_cache_dir=cache)
    assert sorted(os.listdir(cache)) == [
        "chunk_0_120.npz", "chunk_120_240.npz", "chunk_240_300.npz"]
    b = ChunkedHybridRanker(index, "cpu", chunk_docs=120, df_threshold=8,
                            split_cache_dir=cache)
    for (ia, sa), (ib, sb) in zip(a.closest_docs_batch(claims, k=5),
                                  b.closest_docs_batch(claims, k=5)):
        assert ia == ib
        np.testing.assert_array_equal(sa, sb)
    with pytest.raises(ValueError, match="df_threshold"):
        ChunkedHybridRanker(index, "cpu", chunk_docs=120, df_threshold=16,
                            split_cache_dir=cache)


def test_split_cache_is_shared_with_the_reference(setup, tmp_path):
    """A cache directory written by the reference's chunked ranker (its
    ``save_split``) loads into the port's, and the reverse: the artifacts
    are the same files."""
    index, claims = setup
    claims = claims[:16]
    by_ref, by_port = str(tmp_path / "by_ref"), str(tmp_path / "by_port")
    kw = dict(chunk_docs=150, df_threshold=8)
    j_ch.ChunkedHybridRanker(index, split_cache_dir=by_ref, **kw)
    built = ChunkedHybridRanker(index, "cpu", split_cache_dir=by_port, **kw)
    names = sorted(os.listdir(by_ref))
    assert names == sorted(os.listdir(by_port)) == ["chunk_0_150.npz", "chunk_150_300.npz"]
    for name in names:
        a = j_load_split(os.path.join(by_ref, name))
        b = j_load_split(os.path.join(by_port, name))  # the reference reads the port's
        assert (a.df_threshold, a.num_docs, a.hash_size) == (
            b.df_threshold, b.num_docs, b.hash_size)
        for f in ("light_indptr", "light_docs", "light_vals", "doc_freqs"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(a.heavy.terms, b.heavy.terms)
        np.testing.assert_array_equal(a.heavy.vals, b.heavy.vals)
    loaded = ChunkedHybridRanker(index, "cpu", split_cache_dir=by_ref, **kw)
    for (ia, sa), (ib, sb) in zip(built.closest_docs_batch(claims, k=5),
                                  loaded.closest_docs_batch(claims, k=5)):
        assert ia == ib
        np.testing.assert_array_equal(sa, sb)
