"""The staged bucketed engine: ``hybrid_topk_bucketed``, ``_select_rescore_topk``
and ``_light_total_at`` of ``ircl_tpu_torch.ops.hybrid`` against
``ircl_tpu.ops.hybrid``, and the ranker's route to them.

Same numpy inputs into both packages; the JAX functions run their Pallas
kernels in interpret mode, the port's wrappers their plain versions (CPU
tensors). Top-k scores within rtol 1e-5 (the GEMM and the run totals sum in
another order), ids equal except across exact ties. ``select_rescore``
selects candidates from bf16 scores, so its functions are compared on the
same selection scores, and its rankers at the reference test's own bound
(rtol 1e-4 against the exact engine).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_parity import assert_topk_match, one_torch_thread  # noqa: F401
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.index.ranker import TfidfRanker as JaxRanker
from ircl_tpu.ops import hybrid as j_hy
from ircl_tpu_torch.index.build import assemble_csr, build_count_index, to_scipy
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import idf_vector, tfidf_transform
from ircl_tpu_torch.ops import hybrid as t_hy

HASH_SIZE = 2**20


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def setup():
    wiki = generate(num_docs=150, num_claims=50, seed=13)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=HASH_SIZE))
    return index, [c.claim for c in wiki.claims]


@pytest.fixture()
def staged_route(monkeypatch):
    """Both packages' rankers past their fused gate at any corpus size."""
    monkeypatch.setattr(TfidfRanker, "FUSED_LIGHT_MAX_DOCS", 10)
    monkeypatch.setattr(JaxRanker, "FUSED_LIGHT_MAX_DOCS", 10)


def _bucketed_inputs(index, claims, threshold=8, **kw):
    ranker = TfidfRanker(
        index, "cpu", mode="hybrid", df_threshold=threshold, width_buckets=2, **kw
    )
    buckets, weights = ranker._vectorize(claims)
    heavy = [x.numpy() for x in (*ranker._heavy_a, *ranker._heavy_b)]
    return ranker, heavy, ranker.hybrid_host_inputs(buckets, weights)


def _ids_and_scores(out, index, k):
    doc2idx = index.doc2idx
    ids = np.full((len(out), k), -1, np.int64)
    scores = np.zeros((len(out), k), np.float32)
    for b, (d, s) in enumerate(out):
        ids[b, : len(d)] = [doc2idx[x] for x in d]
        scores[b, : len(s)] = s
    return scores, ids


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("threshold", [4, 16])
def test_hybrid_topk_bucketed_matches_jax(setup, threshold, precision):
    index, claims = setup
    _, heavy, host = _bucketed_inputs(index, claims, threshold)
    kw = dict(k=5, queries_sorted=True, pools_sorted=True, d_tile=512,
              precision=precision)
    js, ji = j_hy.hybrid_topk_bucketed(
        *(jnp.asarray(x) for x in heavy), *(jnp.asarray(x) for x in host),
        interpret=True, **kw,
    )
    s, i = t_hy.hybrid_topk_bucketed(
        *(_t(x) for x in heavy), *(_t(x) for x in host), **kw
    )
    assert s.shape == (len(claims), 5) and i.dtype == torch.int32
    assert_topk_match(s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji))
    assert (i.numpy()[:, 0] >= 0).all()


def test_staged_and_fused_engines_agree(setup):
    """The two bucketed engines of the port on the same inputs: scores rtol
    1e-5, ids up to exact ties."""
    index, claims = setup
    _, heavy, host = _bucketed_inputs(index, claims)
    kw = dict(k=5, queries_sorted=True, pools_sorted=True, d_tile=1024)
    args = (*(_t(x) for x in heavy), *(_t(x) for x in host))
    s1, i1 = t_hy.hybrid_topk_bucketed(*args, **kw)
    s2, i2 = t_hy.hybrid_topk_bucketed_fused(*args, **kw)
    assert_topk_match(s1.numpy(), i1.numpy(), s2.numpy(), i2.numpy())


def test_staged_unsorted_pools_and_ragged_batch(setup):
    """Pools sorted on the device, and a batch that is not a multiple of 128."""
    index, claims = setup
    _, heavy, host = _bucketed_inputs(index, claims[:37])
    u, qb, qw, ld, lc = host
    perm = np.random.default_rng(0).permutation(ld.shape[1])
    args = (*heavy, u, qb, qw, ld[:, perm], lc[:, perm])
    kw = dict(k=5, queries_sorted=True, pools_sorted=False, d_tile=256)
    js, ji = j_hy.hybrid_topk_bucketed(
        *(jnp.asarray(x) for x in args), interpret=True, **kw
    )
    s, i = t_hy.hybrid_topk_bucketed(*(_t(x) for x in args), **kw)
    assert s.shape == (37, 5)
    assert_topk_match(s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji))


def test_twophase_merge_path_matches_flat(setup, monkeypatch):
    """``_TWOPHASE_MIN`` forced low: the staged merge takes the two-phase
    heavy top-k (the 1M-doc serving combination) and returns the flat
    path's scores; ids up to exact ties."""
    index, claims = setup
    _, heavy, host = _bucketed_inputs(index, claims)
    kw = dict(k=5, queries_sorted=True, pools_sorted=True, d_tile=512)
    args = (*(_t(x) for x in heavy), *(_t(x) for x in host))
    flat = t_hy.hybrid_topk_bucketed(*args, **kw)
    flat_sel = t_hy.hybrid_topk_bucketed(*args, select_rescore=16, **kw)
    monkeypatch.setattr(t_hy, "_TWOPHASE_MIN", 1)
    calls = []
    real = t_hy._topk_twophase
    monkeypatch.setattr(
        t_hy, "_topk_twophase", lambda h, kk: calls.append(kk) or real(h, kk)
    )
    two = t_hy.hybrid_topk_bucketed(*args, **kw)
    two_sel = t_hy.hybrid_topk_bucketed(*args, select_rescore=16, **kw)
    assert calls == [5, 16]
    assert_topk_match(two[0].numpy(), two[1].numpy(), flat[0].numpy(), flat[1].numpy())
    assert_topk_match(two_sel[0].numpy(), two_sel[1].numpy(),
                      flat_sel[0].numpy(), flat_sel[1].numpy())


@pytest.mark.parametrize("n_cand", [5, 16])
def test_select_rescore_topk_matches_jax_on_the_same_selection(setup, n_cand):
    """``_select_rescore_topk`` against the reference on identical slabs and
    identical bf16 selection scores, so both pick the same candidates."""
    index, claims = setup
    _, heavy, host = _bucketed_inputs(index, claims)
    u, qb, qw, ld, lc = (_t(x) for x in host)
    m, u_tile = t_hy._bucketed_membership(u, *(_t(x) for x in heavy), 512)
    wt = t_hy._query_slab(u, qb, qw, u_tile, True)
    B = ld.shape[0]
    h_sel = (wt[:, :B].T @ m).to(torch.bfloat16)
    got = t_hy._select_rescore_topk(
        m, wt, h_sel, ld, lc, 5, n_cand, m.shape[1], True
    )
    j_fn = jax.jit(j_hy._select_rescore_topk, static_argnums=(5, 6, 7, 8))
    want = j_fn(
        jnp.asarray(m.numpy()), jnp.asarray(wt.numpy()),
        jnp.asarray(h_sel.to(torch.float32).numpy()).astype(jnp.bfloat16),
        jnp.asarray(ld.numpy()), jnp.asarray(lc.numpy()), 5, n_cand, m.shape[1], True,
    )
    assert got[1].dtype == torch.int32
    assert_topk_match(got[0].numpy(), got[1].numpy(),
                      np.asarray(want[0]), np.asarray(want[1]))


@pytest.mark.parametrize("n_cand", [5, 16, 64])
def test_select_rescore_matches_exact_engine(setup, n_cand):
    """Mirror of ``tests/test_hybrid.py::test_select_rescore_matches_exact_engine``
    on the port: bf16 candidate selection + exact fp32 rescore against the
    exact staged engine, at the reference test's bound. 64 holds every
    positive doc of this corpus; 16 is the probe-backed slack; 5 (= k) has
    no slack and passes on this corpus with this selection product."""
    index, claims = setup
    exact = TfidfRanker(index, "cpu", mode="hybrid", df_threshold=8, width_buckets=2)
    sel = TfidfRanker(index, "cpu", mode="hybrid", df_threshold=8, width_buckets=2,
                      select_rescore=n_cand)
    assert sel.select_rescore == n_cand and exact.select_rescore == 0
    out_e = exact.closest_docs_batch(claims, k=5)
    out_s = sel.closest_docs_batch(claims, k=5)
    for qi, ((ids_e, s_e), (ids_s, s_s)) in enumerate(zip(out_e, out_s)):
        assert len(ids_e) == len(ids_s), f"query {qi}"
        np.testing.assert_allclose(s_s, s_e, rtol=1e-4, atol=1e-6)
        assert set(ids_s) == set(ids_e) or np.allclose(
            sorted(s_s), sorted(s_e), rtol=1e-4
        ), f"query {qi}"


@pytest.mark.parametrize("n_cand", [16, 64])
def test_select_rescore_ranker_matches_jax_ranker(setup, n_cand):
    index, claims = setup
    kw = dict(mode="hybrid", df_threshold=8, width_buckets=2, select_rescore=n_cand)
    want = JaxRanker(index, **kw).closest_docs_batch(claims, k=5)
    got = TfidfRanker(index, "cpu", **kw).closest_docs_batch(claims, k=5)
    assert_topk_match(
        *_ids_and_scores(got, index, 5), *_ids_and_scores(want, index, 5)
    )


def test_select_rescore_requires_bucketed_engine(setup):
    index, _ = setup
    with pytest.raises(ValueError, match="width_buckets"):
        TfidfRanker(index, "cpu", mode="hybrid", select_rescore=16)


def test_select_rescore_forces_the_staged_route(setup, monkeypatch):
    """Below the fused gate a ranker with ``select_rescore`` still takes
    ``hybrid_topk_bucketed``; without it, the fused engine."""
    index, claims = setup
    seen = []
    real_staged, real_fused = t_hy.hybrid_topk_bucketed, t_hy.hybrid_topk_bucketed_fused
    monkeypatch.setattr(
        t_hy, "hybrid_topk_bucketed",
        lambda *a, **k: seen.append(("staged", k["select_rescore"])) or real_staged(*a, **k),
    )
    monkeypatch.setattr(
        t_hy, "hybrid_topk_bucketed_fused",
        lambda *a, **k: seen.append(("fused", 0)) or real_fused(*a, **k),
    )
    kw = dict(mode="hybrid", df_threshold=8, width_buckets=2)
    TfidfRanker(index, "cpu", **kw).closest_docs_batch(claims[:4], k=5)
    TfidfRanker(index, "cpu", select_rescore=16, **kw).closest_docs_batch(claims[:4], k=5)
    monkeypatch.setattr(TfidfRanker, "FUSED_LIGHT_MAX_DOCS", 10)
    TfidfRanker(index, "cpu", **kw).closest_docs_batch(claims[:4], k=5)
    assert seen == [("fused", 0), ("staged", 16), ("staged", 0)]


def test_light_total_at_exactness():
    """Mirror of ``tests/test_hybrid.py::test_light_total_at_exactness``, and
    equal to the reference's values: each candidate doc's full run total, 0
    for docs absent from the pool."""
    rng = np.random.default_rng(3)
    B, P = 4, 64
    sd = np.sort(rng.integers(0, 20, size=(B, P)).astype(np.int32), axis=1)
    sv = rng.random((B, P)).astype(np.float32)
    cand = np.stack([np.arange(24, dtype=np.int32)] * B)  # incl. absent ids
    _, l_tot = t_hy._run_totals(_t(sd), _t(sv))
    got = t_hy._light_total_at(_t(sd), l_tot, _t(cand)).numpy()
    _, j_tot = j_hy._run_totals(jnp.asarray(sd), jnp.asarray(sv))
    want = np.asarray(j_hy._light_total_at(jnp.asarray(sd), j_tot, jnp.asarray(cand)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    for b in range(B):
        for c in range(24):
            ref = sv[b][sd[b] == cand[b, c]].astype(np.float64).sum()
            np.testing.assert_allclose(got[b, c], ref, rtol=1e-5, atol=1e-7,
                                       err_msg=f"b={b} doc={cand[b, c]}")


@pytest.mark.parametrize(
    "name,kw",
    [
        ("staged", dict()),
        ("staged_high", dict(precision="high", fixed_max_terms=24, d_tile=512)),
        ("staged_union_round", dict(union_round=512, fixed_union_cap=512)),
    ],
)
def test_staged_ranker_matches_jax_ranker(setup, staged_route, name, kw):
    """Past the fused gate (monkeypatched low) ``width_buckets=2`` serves
    through the staged engine in both packages."""
    index, claims = setup
    kw = dict(mode="hybrid", df_threshold=8, width_buckets=2, **kw)
    want = JaxRanker(index, **kw).closest_docs_batch(claims, k=5)
    port = TfidfRanker(index, "cpu", **kw)
    assert port.d_tile == kw.get("d_tile", 512)  # the default past the gate
    got = port.closest_docs_batch(claims, k=5)
    assert_topk_match(
        *_ids_and_scores(got, index, 5), *_ids_and_scores(want, index, 5)
    )


def test_d_tile_512_matches_default(staged_route, monkeypatch):
    """Mirror of ``tests/test_hybrid.py::test_d_tile_512_matches_default``:
    the staged engine at d_tile 256 and 512 with a live width-bucket cut,
    against scipy (rtol 1e-4) and the JAX ranker (rtol 1e-5). Guards the
    bucket_b concat offset: the cut and the padding must use one tile."""
    monkeypatch.setattr(TfidfRanker, "ELL_MAX_DOCS", 1)
    monkeypatch.setattr(JaxRanker, "ELL_MAX_DOCS", 1)
    rng = np.random.default_rng(2)
    HASH = 1 << 16
    vocab = rng.choice(HASH, size=2000, replace=False).astype(np.int64)
    rows, cols, vals = [], [], []
    NUM = 4096
    for d in range(NUM):
        w = 40 if d % 8 == 0 else 6  # width-skewed: forces a real bucket cut
        terms = rng.choice(vocab, size=w, replace=False)
        rows.extend(terms.tolist())
        cols.extend([d] * w)
        vals.extend([1] * w)
    index = tfidf_transform(assemble_csr(
        np.asarray(rows), np.asarray(cols, np.int32), np.asarray(vals, np.int32),
        HASH, 2, [str(i) for i in range(NUM)],
    ))
    B = 16
    qb = vocab[rng.integers(0, len(vocab), size=(B, 12))].astype(np.int32)
    qw = (np.log1p(1.0) * idf_vector(index.doc_freqs, index.num_docs)[qb]).astype(
        np.float32
    )
    mat = to_scipy(index)
    outs = {}
    for dt in (256, 512):
        r = TfidfRanker(index, "cpu", df_threshold=4, width_buckets=2, d_tile=dt)
        assert r.mode == "hybrid" and r._bucketed.ell_b.terms.shape[0] > 0
        assert len(r._bucketed.pos2old) % dt == 0
        outs[dt] = r.hybrid_from_vectors(qb, qw, 5)
    js, ji = JaxRanker(
        index, df_threshold=4, width_buckets=2, d_tile=512
    ).hybrid_from_vectors(qb, qw, 5)
    assert_topk_match(*outs[512], js, ji)
    for b in range(B):
        nzq = qw[b] != 0
        spvec = sp.csr_matrix(
            (qw[b][nzq], qb[b][nzq], [0, int(nzq.sum())]), shape=(1, HASH)
        )
        ref = (spvec * mat).toarray().ravel()
        expect = np.sort(ref)[::-1][:5]
        for dt in (256, 512):
            s, i = outs[dt]
            n = int((i[b] >= 0).sum())
            np.testing.assert_allclose(
                np.sort(s[b][:n])[::-1], expect[:n], rtol=1e-4, atol=1e-6,
                err_msg=f"query {b} d_tile={dt}",
            )
            # every returned doc carries its own scipy score
            np.testing.assert_allclose(s[b][:n], ref[i[b][:n]], rtol=1e-4, atol=1e-6)


def test_d_tile_default_resolution(setup, monkeypatch):
    index, _ = setup
    monkeypatch.setattr(TfidfRanker, "ELL_MAX_DOCS", 1)
    monkeypatch.setattr(TfidfRanker, "FUSED_LIGHT_MAX_DOCS", 10_000)
    assert TfidfRanker(index, "cpu", df_threshold=8).d_tile == 1024
    monkeypatch.setattr(TfidfRanker, "FUSED_LIGHT_MAX_DOCS", 10)
    assert TfidfRanker(index, "cpu", df_threshold=8).d_tile == 512
    assert TfidfRanker(index, "cpu", df_threshold=8, d_tile=256).d_tile == 256
