"""The port's host-side index modules against ``ircl_tpu``'s: exact equality.

``ircl_tpu_torch/index/{build,tfidf,ell,autotune,split}.py`` are numpy code
carried over from ``ircl_tpu/index/``; the same inputs must give the same
arrays, bit for bit, and the npz artifacts must load across packages.
"""

import numpy as np
import pytest

from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.index import autotune as j_autotune
from ircl_tpu.index import build as j_build
from ircl_tpu.index import ell as j_ell
from ircl_tpu.index import ranker as j_ranker
from ircl_tpu.index import split as j_split
from ircl_tpu.index import tfidf as j_tfidf
from ircl_tpu.ops import membership_pallas as j_mp
from ircl_tpu_torch.index import autotune as t_autotune
from ircl_tpu_torch.index import build as t_build
from ircl_tpu_torch.index import ell as t_ell
from ircl_tpu_torch.index import ranker as t_ranker
from ircl_tpu_torch.index import split as t_split
from ircl_tpu_torch.index import tfidf as t_tfidf
from ircl_tpu_torch.ops import membership_cuda as t_mc
from _torch_parity import one_torch_thread  # noqa: F401

HASH_SIZE = 2**20


@pytest.fixture(scope="module")
def corpus():
    wiki = generate(num_docs=150, num_claims=40, seed=13)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    return store, [c.claim for c in wiki.claims]


@pytest.fixture(scope="module")
def indexes(corpus):
    store, _ = corpus
    j = j_build.build_count_index(store, ngram=2, hash_size=HASH_SIZE)
    t = t_build.build_count_index(store, ngram=2, hash_size=HASH_SIZE)
    return j, t


@pytest.fixture(scope="module")
def weighted(indexes):
    j, t = indexes
    return j_tfidf.tfidf_transform(j), t_tfidf.tfidf_transform(t)


def _assert_index_equal(a, b):
    assert (a.hash_size, a.ngram, a.weighted) == (b.hash_size, b.ngram, b.weighted)
    assert a.doc_ids == b.doc_ids
    for name in ("indptr", "post_docs", "post_vals", "doc_freqs"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_count_index_arrays_equal(indexes):
    _assert_index_equal(*indexes)


def test_tfidf_transform_equal(indexes, weighted):
    j, t = indexes
    _assert_index_equal(*weighted)
    np.testing.assert_array_equal(
        j_tfidf.idf_vector(j.doc_freqs, j.num_docs),
        t_tfidf.idf_vector(t.doc_freqs, t.num_docs),
    )
    np.testing.assert_array_equal(
        j_tfidf.doc_freqs_from_postings(j), t_tfidf.doc_freqs_from_postings(t)
    )


def test_assemble_csr_numpy_path_equal():
    rng = np.random.default_rng(4)
    row = rng.integers(0, 4096, size=500)
    col = np.sort(rng.integers(0, 40, size=500)).astype(np.int32)
    val = rng.integers(1, 5, size=500).astype(np.float32)  # float: numpy path
    ids = [str(i) for i in range(40)]
    _assert_index_equal(
        j_build.assemble_csr(row, col, val, 4096, 2, ids),
        t_build.assemble_csr(row, col, val, 4096, 2, ids),
    )


@pytest.mark.parametrize("saver", ["jax_package", "port"])
def test_count_index_npz_loads_across_packages(weighted, tmp_path, saver):
    j, t = weighted
    path = str(tmp_path / "index.npz")
    if saver == "jax_package":
        j.save(path)
        _assert_index_equal(j, t_build.CountIndex.load(path))
    else:
        t.save(path)
        _assert_index_equal(t, j_build.CountIndex.load(path))


def test_to_scipy_equal(weighted):
    j, t = weighted
    a, b = j_build.to_scipy(j), t_build.to_scipy(t)
    assert a.shape == b.shape
    assert (a != b).nnz == 0


def test_to_ell_equal(weighted):
    j, t = weighted
    a, b = j_ell.to_ell(j), t_ell.to_ell(t)
    np.testing.assert_array_equal(a.terms, b.terms)
    np.testing.assert_array_equal(a.vals, b.vals)
    assert (a.num_docs, a.hash_size) == (b.num_docs, b.hash_size)


@pytest.mark.parametrize("threshold", [4, 16, 64])
def test_split_index_equal(weighted, threshold):
    j, t = weighted
    for a, b in (
        (j_split.split_index(j, threshold), t_split.split_index(t, threshold)),
        (
            j_split._split_index_np(j, threshold),
            t_split._split_index_np(t, threshold),
        ),
    ):
        np.testing.assert_array_equal(a.heavy.terms, b.heavy.terms)
        np.testing.assert_array_equal(a.heavy.vals, b.heavy.vals)
        np.testing.assert_array_equal(a.light_indptr, b.light_indptr)
        np.testing.assert_array_equal(a.light_docs, b.light_docs)
        np.testing.assert_array_equal(a.light_vals, b.light_vals)
        assert (a.df_threshold, a.num_docs, a.hash_size) == (
            b.df_threshold, b.num_docs, b.hash_size,
        )


@pytest.mark.parametrize("d_tile", [256, 1024])
def test_bucket_heavy_equal(weighted, d_tile):
    j, t = weighted
    a = j_split.bucket_heavy(j_split.split_index(j, 8).heavy, d_tile=d_tile)
    b = t_split.bucket_heavy(t_split.split_index(t, 8).heavy, d_tile=d_tile)
    np.testing.assert_array_equal(a.pos2old, b.pos2old)
    np.testing.assert_array_equal(a.old2pos, b.old2pos)
    for x, y in ((a.ell_a, b.ell_a), (a.ell_b, b.ell_b)):
        np.testing.assert_array_equal(x.terms, y.terms)
        np.testing.assert_array_equal(x.vals, y.vals)


def test_save_split_loads_across_packages(weighted, tmp_path):
    j, t = weighted
    path = str(tmp_path / "split.npz")
    j_split.save_split(j_split.split_index(j, 8), path)
    a, b = j_split.load_split(path), t_split.load_split(path)
    np.testing.assert_array_equal(a.heavy.terms, b.heavy.terms)
    np.testing.assert_array_equal(a.light_docs, b.light_docs)
    assert (a.df_threshold, a.num_docs) == (b.df_threshold, b.num_docs)


def _query_vectors(weighted, claims, max_terms=None):
    j, t = weighted
    return t_ranker.vectorize_queries(
        claims, t.hash_size, t.ngram, t.doc_freqs, t.num_docs,
        max_terms=max_terms,
    )


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"sort_pools": True},
        {"remap": True, "sort_pools": True},
    ],
    ids=["plain", "sorted", "remapped"],
)
@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_gather_light_pools_equal(weighted, corpus, kwargs, impl):
    j, t = weighted
    _, claims = corpus
    buckets, weights = _query_vectors(weighted, claims)
    sj, st = j_split.split_index(j, 8), t_split.split_index(t, 8)
    kw = dict(kwargs)
    if kw.pop("remap", False):
        bk = t_split.bucket_heavy(st.heavy)
        kw.update(old2pos=bk.old2pos, pad_doc=len(bk.pos2old))
    if impl == "native":
        if t_split._native_light_lib() is None:
            pytest.skip("native host library unavailable")
        a = j_split.gather_light_pools(sj, buckets, weights, **kw)
        b = t_split.gather_light_pools(st, buckets, weights, **kw)
    else:
        args = (
            buckets.astype(np.int32), weights.astype(np.float32), 128,
            kw.get("old2pos"), kw.get("sort_pools", False),
            kw.get("pad_doc", st.num_docs),
        )
        a = j_split._gather_light_pools_np(sj, *args)
        b = t_split._gather_light_pools_np(st, *args)
    assert a[2] == b[2]
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("max_terms", [None, 8, 24])
@pytest.mark.parametrize("binary_tf", [False, True])
def test_vectorize_queries_equal(weighted, corpus, max_terms, binary_tf):
    j, t = weighted
    _, claims = corpus
    queries = claims + ["", "zzz qqq"]
    a = j_ranker.vectorize_queries(
        queries, j.hash_size, j.ngram, j.doc_freqs, j.num_docs,
        max_terms=max_terms, binary_tf=binary_tf,
    )
    b = t_ranker.vectorize_queries(
        queries, t.hash_size, t.ngram, t.doc_freqs, t.num_docs,
        max_terms=max_terms, binary_tf=binary_tf,
    )
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("union_round", [None, 512])
@pytest.mark.parametrize("floor", [16, 64, 512, 4096])
def test_union_slots_equal(weighted, corpus, union_round, floor):
    j, t = weighted
    _, claims = corpus
    jr = j_ranker.TfidfRanker(j, mode="ell", union_round=union_round)
    tr = t_ranker.TfidfRanker(t, "cpu", mode="ell", union_round=union_round)
    buckets, weights = _query_vectors(weighted, claims)
    for b in (slice(0, 1), slice(0, 40)):
        np.testing.assert_array_equal(
            jr._union_slots(buckets[b], weights[b], floor=floor),
            tr._union_slots(buckets[b], weights[b], floor=floor),
        )


def test_auto_df_threshold_equal(weighted):
    j, t = weighted
    for kw in ({}, {"union_round": 512, "union_floor": 4096, "max_terms": 64}):
        a = j_autotune.auto_df_threshold(j, return_costs=True, **kw)
        b = t_autotune.auto_df_threshold(t, return_costs=True, **kw)
        assert a == b
    for n in (1, 15, 16, 17, 1000):
        assert j_autotune._pow2(n) == t_autotune._pow2(n)


@pytest.mark.parametrize("d_tile", [128, 256])
def test_pad_for_slab_equal(weighted, d_tile):
    _, t = weighted
    e = t_ell.to_ell(t)
    args = (np.ascontiguousarray(e.terms.T), np.ascontiguousarray(e.vals.T))
    for x, y in zip(
        j_mp.pad_for_slab(*args, d_tile=d_tile),
        t_mc.pad_for_slab(*args, d_tile=d_tile),
    ):
        np.testing.assert_array_equal(x, y)


def test_candidate_docs_equal(weighted, corpus):
    j, t = weighted
    _, claims = corpus
    for bigram_only in (False, True):
        assert j_ranker.candidate_docs(
            j, claims[:10], bigram_only
        ) == t_ranker.candidate_docs(t, claims[:10], bigram_only)
