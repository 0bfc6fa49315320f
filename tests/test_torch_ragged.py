"""The ragged engine: ``ircl_tpu_torch.ops.ragged`` against ``ircl_tpu.ops.ragged``,
``mode="ragged"`` and ``dense_scores_batch`` against the JAX ranker, scipy and
the port's other engines.

Same numpy inputs into both packages. Gathered pools are integer gathers and
one product a posting: equal. Run totals are fp64 prefix differences here and
a double-float scan there: rtol 1e-6. Top-k scores rtol 1e-5, ids equal
except across exact ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_parity import assert_topk_match, one_torch_thread  # noqa: F401
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.index.ranker import TfidfRanker as JaxRanker
from ircl_tpu.ops import ragged as j_rg
from ircl_tpu_torch.index.build import assemble_csr, build_count_index, to_scipy
from ircl_tpu_torch.index.ranker import TfidfRanker, vectorize_queries
from ircl_tpu_torch.index.split import gather_light_pools
from ircl_tpu_torch.index.tfidf import idf_vector, tfidf_transform
from ircl_tpu_torch.ops import hybrid as t_hy
from ircl_tpu_torch.ops import ragged as t_rg
from ircl_tpu_torch.ops.membership_cuda import membership_topk_fused, pad_for_slab

HASH_SIZE = 2**20
INT_MAX = np.iinfo(np.int32).max


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def setup():
    wiki = generate(num_docs=150, num_claims=50, seed=13)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=HASH_SIZE))
    return index, [c.claim for c in wiki.claims]


def _ids_and_scores(out, index, k):
    doc2idx = index.doc2idx
    ids = np.full((len(out), k), -1, np.int64)
    scores = np.zeros((len(out), k), np.float32)
    for b, (d, s) in enumerate(out):
        ids[b, : len(d)] = [doc2idx[x] for x in d]
        scores[b, : len(s)] = s
    return scores, ids


def test_segment_topk_unit():
    """Mirror of ``tests/test_index.py::test_segment_topk_unit``."""
    docs = _t(np.array([[3, 1, 3, 2, 1, INT_MAX, INT_MAX, INT_MAX]], np.int32))
    vals = _t(np.array([[1.0, 2.0, 4.0, 8.0, 16.0, 0.0, 0.0, 0.0]], np.float32))
    scores, ids = t_rg.segment_topk(docs, vals, k=3)
    # totals: doc1=18, doc2=8, doc3=5
    np.testing.assert_allclose(scores[0].numpy(), [18.0, 8.0, 5.0])
    np.testing.assert_array_equal(ids[0].numpy(), [1, 2, 3])
    assert ids.dtype == torch.int32
    # fewer docs than k: empty slots are (0, -1)
    scores, ids = t_rg.segment_topk(docs, vals, k=5)
    np.testing.assert_array_equal(ids[0].numpy(), [1, 2, 3, -1, -1])
    np.testing.assert_array_equal(scores[0].numpy()[3:], [0.0, 0.0])


def test_choose_nnz_cap():
    for n in (0, 1, 1023, 1024, 1025, 70_000):
        assert t_rg.choose_nnz_cap(n) == j_rg.choose_nnz_cap(n)
    assert t_rg.choose_nnz_cap(5, floor=4) == 8


def test_gather_postings_matches_jax(setup):
    index, claims = setup
    buckets, weights = vectorize_queries(
        claims, HASH_SIZE, 2, index.doc_freqs, index.num_docs
    )
    bound = int(np.where(weights != 0, index.doc_freqs[buckets], 0).sum(axis=1).max())
    cap = t_rg.choose_nnz_cap(bound)
    indptr = index.indptr.astype(np.int32)
    want = j_rg.gather_postings(
        jnp.asarray(indptr), jnp.asarray(index.post_docs), jnp.asarray(index.post_vals),
        jnp.asarray(buckets), jnp.asarray(weights), nnz_cap=cap,
    )
    got = t_rg.gather_postings(
        _t(indptr), _t(index.post_docs), _t(index.post_vals),
        _t(buckets.astype(np.int32)), _t(weights), nnz_cap=cap,
    )
    assert got[0].dtype == torch.int32 and got[0].shape == (len(claims), cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert (got[0].numpy()[np.arange(cap)[None, :] >= got[2].numpy()[:, None]]
            == INT_MAX).all()


def test_segment_topk_and_dense_scores_match_jax(setup):
    index, claims = setup
    ranker = TfidfRanker(index, "cpu", mode="ragged")
    docs, contribs, cap = ranker._gather_ragged(claims)
    s, i = t_rg.segment_topk(docs, contribs, k=7)
    js, ji = j_rg.segment_topk(
        jnp.asarray(docs.numpy()), jnp.asarray(contribs.numpy()), k=7
    )
    assert_topk_match(s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji))
    dense = t_rg.dense_scores(docs, contribs, num_docs=index.num_docs)
    j_dense = j_rg.dense_scores(
        jnp.asarray(docs.numpy()), jnp.asarray(contribs.numpy()),
        num_docs=index.num_docs,
    )
    assert dense.shape == (len(claims), index.num_docs)
    np.testing.assert_allclose(dense.numpy(), np.asarray(j_dense), rtol=1e-5, atol=1e-6)


QUERIES = [
    "solar farm proposal",
    "seabird nesting sites near the harbor",
    "electricity prices on the island",
    "committee debate",
    "zzz unseen tokens qqq",
]


@pytest.mark.parametrize("mode", ["ragged", "ell", "hybrid"])
def test_dense_scores_match_scipy(setup, mode):
    """Mirror of ``tests/test_index.py::test_dense_scores_match_scipy``:
    ``dense_scores_batch`` runs on the ragged engine whatever the mode."""
    index, claims = setup
    queries = QUERIES + claims[:5]
    kw = dict(df_threshold=8) if mode == "hybrid" else {}
    got = TfidfRanker(index, "cpu", mode=mode, **kw).dense_scores_batch(queries)
    mat = to_scipy(index)
    buckets, weights = vectorize_queries(
        queries, HASH_SIZE, 2, index.doc_freqs, index.num_docs
    )
    for b in range(len(queries)):
        nz = weights[b] != 0
        spvec = sp.csr_matrix(
            (weights[b][nz], buckets[b][nz], [0, int(nz.sum())]), shape=(1, HASH_SIZE)
        )
        ref = (spvec * mat).toarray().ravel()
        np.testing.assert_allclose(got[b], ref, rtol=1e-5, atol=1e-6)


def test_dense_scores_batch_matches_jax_ranker(setup):
    index, claims = setup
    want = JaxRanker(index, mode="ragged").dense_scores_batch(claims[:8])
    got = TfidfRanker(index, "cpu", mode="ragged").dense_scores_batch(claims[:8])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_topk_matches_dense_ranking(setup):
    """Mirror of ``tests/test_index.py::test_topk_matches_dense_ranking``."""
    index, claims = setup
    queries = QUERIES + claims[:5]
    ranker = TfidfRanker(index, "cpu", mode="ragged")
    dense = ranker.dense_scores_batch(queries)
    topk = ranker.closest_docs_batch(queries, k=3)
    doc2idx = index.doc2idx
    for b in range(len(queries)):
        ids, scores = topk[b]
        order = np.argsort(-dense[b])
        n_pos = int((dense[b] > 0).sum())
        assert len(ids) == min(3, n_pos)
        np.testing.assert_allclose(
            scores, np.sort(dense[b])[::-1][: len(scores)], rtol=1e-5
        )
        # each returned doc carries its own dense score
        np.testing.assert_allclose(
            scores, [dense[b][doc2idx[d]] for d in ids], rtol=1e-5
        )
        assert not len(ids) or dense[b][order[0]] == pytest.approx(scores[0], rel=1e-5)


def test_ragged_ranker_matches_jax_ranker(setup):
    index, claims = setup
    for k in (1, 5):
        want = JaxRanker(index, mode="ragged").closest_docs_batch(claims, k=k)
        got = TfidfRanker(index, "cpu", mode="ragged").closest_docs_batch(claims, k=k)
        assert_topk_match(
            *_ids_and_scores(got, index, k), *_ids_and_scores(want, index, k)
        )


@pytest.mark.parametrize(
    "kw",
    [
        dict(mode="ell"),
        dict(mode="hybrid", df_threshold=8),
        dict(mode="hybrid", df_threshold=8, width_buckets=2),
        dict(mode="hybrid", df_threshold=8, width_buckets=2, select_rescore=64),
    ],
    ids=["ell", "hybrid", "hybrid_wb2", "hybrid_wb2_select64"],
)
def test_engines_match_ragged_topk(setup, kw):
    """Mirror of ``tests/test_membership.py::test_ell_topk_matches_ragged_topk``
    for every engine of the port."""
    index, claims = setup
    out_r = TfidfRanker(index, "cpu", mode="ragged").closest_docs_batch(claims, k=5)
    out_e = TfidfRanker(index, "cpu", **kw).closest_docs_batch(claims, k=5)
    for (ids_e, s_e), (ids_r, s_r) in zip(out_e, out_r):
        assert len(ids_e) == len(ids_r)
        np.testing.assert_allclose(s_e, s_r, rtol=1e-4)
        # doc sets may differ only within tied scores
        assert set(ids_e) == set(ids_r) or np.allclose(
            sorted(s_e), sorted(s_r), rtol=1e-4
        )


def test_ragged_empty_batch_and_short_queries(setup):
    """An empty batch, and queries with few or no postings (k above the
    number of scored docs leaves -1 slots that are dropped)."""
    index, _ = setup
    ranker = TfidfRanker(index, "cpu", mode="ragged")
    assert ranker.closest_docs_batch([], k=5) == []
    queries = ["zzz unseen tokens qqq", "", "the"]
    want = JaxRanker(index, mode="ragged").closest_docs_batch(queries, k=5)
    got = ranker.closest_docs_batch(queries, k=5)
    for (ids_g, s_g), (ids_w, s_w) in zip(got, want):
        assert len(ids_g) == len(ids_w)
        np.testing.assert_allclose(s_g, s_w, rtol=1e-5)
    assert got[1][0] == [] and len(got[1][1]) == 0


# ---- the fuzz of tests/test_engine_fuzz.py over all ported engines ----------

FUZZ_HASH = 1 << 16


def _random_index(rng, num_docs, max_terms):
    rows, cols, vals = [], [], []
    vocab = rng.choice(FUZZ_HASH, size=max(24, num_docs), replace=False)
    p = 1.0 / np.arange(1, len(vocab) + 1)  # Zipf-ish term choice
    p /= p.sum()
    for d in range(num_docs):
        n = int(rng.integers(1, max_terms + 1))
        terms = np.unique(rng.choice(vocab, size=n, p=p))
        rows.extend(terms.tolist())
        cols.extend([d] * len(terms))
        vals.extend(rng.integers(1, 4, size=len(terms)).tolist())
    index = assemble_csr(
        np.asarray(rows, np.int64), np.asarray(cols, np.int32),
        np.asarray(vals, np.int32), FUZZ_HASH, 2, [f"d{i}" for i in range(num_docs)],
    )
    return tfidf_transform(index), vocab


def _random_query_vectors(rng, vocab, index, n_queries):
    idfs = idf_vector(index.doc_freqs, index.num_docs)
    T = int(rng.integers(1, 9))
    qb = vocab[rng.integers(0, len(vocab), size=(n_queries, T))].astype(np.int64)
    counts = rng.integers(1, 3, size=qb.shape)
    qw = (np.log1p(counts) * idfs[qb]).astype(np.float32)
    qw[rng.random(qb.shape) < 0.2] = 0.0  # random dead slots
    return qb.astype(np.int32), qw


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_engines_agree_on_random_corpora(seed):
    """Random postings with adversarial shapes (tiny corpora, single-term
    docs, duplicate-heavy queries) through the raw query vectors: ell,
    hybrid, staged bucketed, fused bucketed and ragged against scipy."""
    rng = np.random.default_rng(seed)
    num_docs = int(rng.integers(3, 120))
    index, vocab = _random_index(rng, num_docs, max_terms=12)
    qb, qw = _random_query_vectors(rng, vocab, index, n_queries=16)
    mat = to_scipy(index)
    dense_ref = np.zeros((len(qb), num_docs))
    for b in range(len(qb)):
        nz = qw[b] != 0
        if not nz.any():
            continue
        uniq, inv = np.unique(qb[b][nz], return_inverse=True)
        w = np.zeros(len(uniq), np.float64)
        np.add.at(w, inv, qw[b][nz])
        spvec = sp.csr_matrix((w, uniq, [0, len(uniq)]), shape=(1, FUZZ_HASH))
        dense_ref[b] = (spvec * mat).toarray().ravel()
    k = int(rng.integers(1, 7))
    thr = int(rng.integers(1, 8))

    results = {}
    ell = TfidfRanker(index, "cpu", mode="ell")
    u_pad = ell._union_slots(qb, qw, floor=512)
    qb_t, qw_t = pad_for_slab(
        np.ascontiguousarray(qb.T), np.ascontiguousarray(qw.T), 128
    )
    results["ell"] = membership_topk_fused(
        ell._ell_terms_t, ell._ell_vals_t, _t(u_pad), _t(qb_t), _t(qw_t),
        k=k, num_real_docs=num_docs,
    )
    hyb = TfidfRanker(index, "cpu", mode="hybrid", df_threshold=thr)
    hw = np.where(hyb._split.doc_freqs[qb] > thr, qw, 0.0).astype(np.float32)
    u_pad = hyb._union_slots(qb, hw, floor=512)
    hb_t, hw_t = pad_for_slab(
        np.ascontiguousarray(qb.T), np.ascontiguousarray(hw.T), 128
    )
    ld, lc, _ = gather_light_pools(hyb._split, qb, qw)
    results["hybrid"] = t_hy.hybrid_topk(
        hyb._heavy_terms_t, hyb._heavy_vals_t, _t(u_pad), _t(hb_t), _t(hw_t),
        _t(ld), _t(lc), k=k, num_real_docs=num_docs,
    )
    bk = TfidfRanker(index, "cpu", mode="hybrid", df_threshold=thr, width_buckets=2)
    host = [_t(x) for x in bk.hybrid_host_inputs(qb, qw)]
    pos2old = bk._bucketed.pos2old
    for name, fn in (("staged", t_hy.hybrid_topk_bucketed),
                     ("fused", t_hy.hybrid_topk_bucketed_fused)):
        s, i = fn(*bk._heavy_a, *bk._heavy_b, *host, k=k, queries_sorted=True,
                  pools_sorted=True, d_tile=256)
        i = i.numpy()
        results[name] = (s, np.where(i >= 0, pos2old[np.maximum(i, 0)], -1))
    docs, contribs, cap = bk._gather_ragged_vectors(qb, qw)
    results["ragged"] = t_rg.segment_topk(docs, contribs, k=min(k, cap))

    for name, (s, i) in results.items():
        s = np.asarray(s)[: len(qb)]
        i = np.asarray(i)[: len(qb)]
        for b in range(len(qb)):
            expect = np.sort(dense_ref[b][dense_ref[b] > 1e-9])[::-1][:k]
            got = s[b][i[b] >= 0]
            msg = f"{name} seed={seed} q={b} k={k} thr={thr}"
            assert len(got) == len(expect), msg
            np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5, err_msg=msg)
            np.testing.assert_allclose(
                got, dense_ref[b][i[b][i[b] >= 0]], rtol=1e-4, atol=1e-5, err_msg=msg
            )
