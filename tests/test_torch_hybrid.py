"""Hybrid engines: ``ircl_tpu_torch.ops.hybrid`` against ``ircl_tpu.ops.hybrid``.

Same numpy inputs into both; the JAX functions run their Pallas kernels in
interpret mode, the port's wrappers their plain versions (CPU tensors).
Top-k scores within rtol 1e-5 (the GEMM and the run totals sum in another
order), ids equal except across exact ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_topk_match, one_torch_thread  # noqa: F401
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.ops import hybrid as j_hy
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.ops import hybrid as t_hy

HASH_SIZE = 2**20


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# jitted once per module: eager JAX runs these scans op by op
_j_run_totals = jax.jit(j_hy._run_totals)
_j_merge_light = jax.jit(
    j_hy._merge_light, static_argnums=(3, 4), static_argnames=("pools_sorted",)
)


@pytest.fixture(scope="module")
def corpus():
    wiki = generate(num_docs=150, num_claims=40, seed=13)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=HASH_SIZE))
    return index, [c.claim for c in wiki.claims]


def test_run_totals_match_f64_and_jax_fuzz():
    """fp64-cumsum run totals vs numpy f64 per-run sums and vs the JAX
    double-float scan, across hostile magnitude mixes."""
    rng = np.random.default_rng(7)
    B, P = 8, 1024
    for _ in range(3):
        docs = np.sort(rng.integers(0, 40, size=(B, P)), axis=1).astype(np.int32)
        mags = 10.0 ** rng.uniform(-4, 4, size=(B, P))
        vals = (mags * rng.uniform(0.5, 2.0, size=(B, P))).astype(np.float32)
        is_end, tot = t_hy._run_totals(_t(docs), _t(vals))
        j_end, j_tot = _j_run_totals(jnp.asarray(docs), jnp.asarray(vals))
        is_end, tot = is_end.numpy(), tot.numpy()
        np.testing.assert_array_equal(is_end, np.asarray(j_end))
        np.testing.assert_allclose(tot[is_end], np.asarray(j_tot)[is_end], rtol=1e-6)
        for b in range(B):
            ref = {}
            for d, v in zip(docs[b], vals[b].astype(np.float64)):
                ref[int(d)] = ref.get(int(d), 0.0) + v
            got = {int(docs[b][p]): float(tot[b][p]) for p in range(P) if is_end[b][p]}
            assert set(got) == set(ref)
            for d in ref:
                np.testing.assert_allclose(got[d], ref[d], rtol=1e-6)


def test_merge_light_tiny_run_survives_large_prefix():
    """A doc whose light total is below the f32 ulp of the pool prefix keeps
    its total (the case the reference's double-float scan exists for)."""
    P = 8192
    docs = np.concatenate([np.zeros(P - 2, np.int32), np.ones(2, np.int32)])[None]
    contribs = np.concatenate(
        [np.full(P - 2, 200.0, np.float32), np.full(2, 0.001, np.float32)]
    )[None]
    h = np.zeros((1, 64), np.float32)
    s, i = t_hy._merge_light(_t(h), _t(docs), _t(contribs), 5, 64, pools_sorted=True)
    js, ji = _j_merge_light(
        jnp.asarray(h), jnp.asarray(docs), jnp.asarray(contribs), 5, 64,
        pools_sorted=True,
    )
    got = {int(d): float(v) for d, v in zip(i[0], s[0]) if d >= 0}
    assert 1 in got, (s, i)
    np.testing.assert_allclose(got[1], 0.002, rtol=1e-4)
    np.testing.assert_allclose(got[0], 200.0 * (P - 2), rtol=1e-6)
    assert_topk_match(s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji))


@pytest.mark.parametrize("pools_sorted", [False, True])
def test_merge_light_matches_jax(pools_sorted):
    rng = np.random.default_rng(11)
    B, N, P, k = 6, 1024, 16, 5
    h = np.abs(rng.normal(size=(B, N))).astype(np.float32)
    docs = rng.integers(0, N + 8, size=(B, P)).astype(np.int32)  # some pads
    contribs = np.abs(rng.normal(size=(B, P))).astype(np.float32)
    if pools_sorted:
        docs = np.sort(docs, axis=1)
    s, i = t_hy._merge_light(_t(h), _t(docs), _t(contribs), k, N, pools_sorted)
    js, ji = _j_merge_light(
        jnp.asarray(h), jnp.asarray(docs), jnp.asarray(contribs), k, N,
        pools_sorted=pools_sorted,
    )
    assert i.dtype == torch.int32
    assert_topk_match(s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji))


def test_topk_twophase_matches_jax():
    rng = np.random.default_rng(7)
    h = rng.permutation(3200 * 7).reshape(7, 3200).astype(np.float32)
    s, i = t_hy._topk_twophase(_t(h), 5)
    js, ji = j_hy._topk_twophase(jnp.asarray(h), 5)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_u_tile_and_precision_table():
    for u in (16, 64, 512, 4096, 8192):
        for d_tile in (256, 1024):
            assert t_hy._u_tile(u, d_tile) == j_hy._u_tile(u, d_tile)
    assert set(t_hy._PREC) == set(j_hy._PREC)
    assert t_hy._PREC["highest"] is False and t_hy._PREC["high"] is False
    with pytest.raises(ValueError, match="unknown precision"):
        t_hy._PREC["bf16"]


def _host_inputs(index, claims, width_buckets, threshold):
    ranker = TfidfRanker(
        index, "cpu", mode="hybrid", df_threshold=threshold,
        width_buckets=width_buckets,
    )
    buckets, weights = ranker._vectorize(claims)
    return ranker, ranker.hybrid_host_inputs(buckets, weights)


@pytest.mark.parametrize("threshold", [4, 16])
def test_hybrid_topk_matches_jax(corpus, threshold):
    index, claims = corpus
    ranker, host = _host_inputs(index, claims, 1, threshold)
    kw = dict(k=7, num_real_docs=index.num_docs, queries_sorted=True)
    js, ji = j_hy.hybrid_topk(
        jnp.asarray(ranker._heavy_terms_t.numpy()),
        jnp.asarray(ranker._heavy_vals_t.numpy()),
        *(jnp.asarray(x) for x in host), interpret=True, d_tile=256, **kw,
    )
    s, i = t_hy.hybrid_topk(
        ranker._heavy_terms_t, ranker._heavy_vals_t,
        *(_t(x) for x in host), d_tile=256, **kw,
    )
    assert_topk_match(s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji))
    assert (i.numpy()[:, 0] >= 0).all()


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_hybrid_topk_bucketed_fused_matches_jax(corpus, precision):
    index, claims = corpus
    ranker, host = _host_inputs(index, claims, 2, 8)
    kw = dict(k=5, queries_sorted=True, pools_sorted=True, d_tile=1024,
              precision=precision)
    heavy = [
        x.numpy() for x in (*ranker._heavy_a, *ranker._heavy_b)
    ]
    js, ji = j_hy.hybrid_topk_bucketed_fused(
        *(jnp.asarray(x) for x in heavy), *(jnp.asarray(x) for x in host),
        interpret=True, **kw,
    )
    s, i = t_hy.hybrid_topk_bucketed_fused(
        *(_t(x) for x in heavy), *(_t(x) for x in host), **kw,
    )
    assert i.dtype == torch.int32
    assert_topk_match(s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji))
    assert (i.numpy()[:, 0] >= 0).all()


def test_fused_unsorted_pools_and_ragged_batch(corpus):
    """Pools sorted on the device, and a batch that is not a multiple of 128
    (the light pools pad to the query slab's width)."""
    index, claims = corpus
    ranker, host = _host_inputs(index, claims[:37], 2, 8)
    u, qb, qw, ld, lc = host
    rng = np.random.default_rng(0)
    perm = rng.permutation(ld.shape[1])
    ld, lc = ld[:, perm], lc[:, perm]
    heavy = [x.numpy() for x in (*ranker._heavy_a, *ranker._heavy_b)]
    args = (*heavy, u, qb, qw, ld, lc)
    kw = dict(k=5, queries_sorted=True, pools_sorted=False, d_tile=1024)
    js, ji = j_hy.hybrid_topk_bucketed_fused(
        *(jnp.asarray(x) for x in args), interpret=True, **kw
    )
    s, i = t_hy.hybrid_topk_bucketed_fused(*(_t(x) for x in args), **kw)
    assert s.shape == (37, 5)
    assert_topk_match(s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji))


def test_fused_rejects_unpadded_doc_count():
    z = torch.zeros((8, 100), dtype=torch.int32)
    v = torch.zeros((8, 100))
    u = torch.full((128,), HASH_SIZE, dtype=torch.int32)
    q = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 256"):
        t_hy.hybrid_topk_bucketed_fused(
            z, v, z, v, u, q, torch.zeros((8, 128)),
            torch.zeros((4, 128), dtype=torch.int32), torch.zeros((4, 128)), k=5,
        )
