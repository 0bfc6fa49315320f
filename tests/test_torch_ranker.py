"""TfidfRanker: the port against ``ircl_tpu``'s ranker on the same index.

Both rankers rank the same claims; the JAX one runs its Pallas kernels in
interpret mode, the port's its plain versions (``device="cpu"``). Ranker vs
ranker: scores within rtol 1e-5, ids equal except across exact ties. The
port is also held to ``bench.py``'s full-batch scipy gate (rtol 1e-4).
"""

import numpy as np
import pytest
import scipy.sparse as sp

from _torch_parity import assert_topk_match, one_torch_thread  # noqa: F401
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.index.ranker import TfidfRanker as JaxRanker
from ircl_tpu.index.split import save_split, split_index
from ircl_tpu_torch.index.build import build_count_index, to_scipy
from ircl_tpu_torch.index.ranker import TfidfRanker, vectorize_queries
from ircl_tpu_torch.index.split import load_split
from ircl_tpu_torch.index.tfidf import tfidf_transform

HASH_SIZE = 2**20


@pytest.fixture(scope="module")
def setup():
    wiki = generate(num_docs=150, num_claims=50, seed=13)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=HASH_SIZE))
    return index, [c.claim for c in wiki.claims]


def _ids_and_scores(out, index, k):
    """closest_docs_batch output -> [B, k] doc positions / scores, -1 pad."""
    doc2idx = index.doc2idx
    ids = np.full((len(out), k), -1, np.int64)
    scores = np.zeros((len(out), k), np.float32)
    for b, (d, s) in enumerate(out):
        ids[b, : len(d)] = [doc2idx[x] for x in d]
        scores[b, : len(s)] = s
    return scores, ids


CONFIGS = {
    "ell": dict(mode="ell"),
    "ell_union_round": dict(mode="ell", union_round=512),
    "ell_past_union_cap": dict(mode="ell", fixed_union_cap=512, fixed_max_terms=24),
    "hybrid_wb1": dict(mode="hybrid", df_threshold=8),
    "hybrid_wb1_union_round": dict(mode="hybrid", df_threshold=8, union_round=512),
    "hybrid_wb1_cap_below_128": dict(
        mode="hybrid", df_threshold=8, fixed_union_cap=64, fixed_max_terms=24
    ),
    "hybrid_wb2": dict(mode="hybrid", df_threshold=8, width_buckets=2),
    "hybrid_wb2_bench": dict(
        mode="hybrid", df_threshold=4, width_buckets=2, fixed_union_cap=512,
        fixed_max_terms=64, precision="high", union_round=512,
    ),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_closest_docs_batch_matches_jax_ranker(setup, name):
    index, claims = setup
    kw = CONFIGS[name]
    k = 5
    want = JaxRanker(index, **kw).closest_docs_batch(claims, k=k)
    port = TfidfRanker(index, "cpu", **kw)
    got = port.closest_docs_batch(claims, k=k)
    assert port.mode == kw["mode"]
    if name == "ell_past_union_cap":  # the batch union outgrows the cap
        b, w = port._vectorize(claims)
        assert len(port._union_slots(b, w, floor=512)) > 512
    assert_topk_match(
        *_ids_and_scores(got, index, k), *_ids_and_scores(want, index, k)
    )


def test_bench_gate_against_scipy(setup):
    """``bench.py:246-264``: sorted top-5 scores equal scipy's at rtol 1e-4
    on the full batch, with the bench's ranker settings."""
    index, claims = setup
    ranker = TfidfRanker(index, "cpu", **CONFIGS["hybrid_wb2_bench"])
    results = ranker.closest_docs_batch(claims, k=5)
    mat = to_scipy(index)
    buckets, weights = vectorize_queries(
        claims, HASH_SIZE, 2, index.doc_freqs, index.num_docs
    )
    doc2idx = index.doc2idx
    mismatches = 0
    for b in range(len(claims)):
        nz = weights[b] != 0
        spvec = sp.csr_matrix(
            (weights[b][nz], buckets[b][nz], [0, int(nz.sum())]),
            shape=(1, HASH_SIZE),
        )
        res = spvec * mat
        if len(res.data) <= 5:
            o = np.argsort(-res.data)
        else:
            o = np.argpartition(-res.data, 5)[:5]
            o = o[np.argsort(-res.data[o])]
        got_ids = np.array([doc2idx[d] for d in results[b][0]])
        n = min(len(o), len(got_ids))
        if not np.allclose(
            np.sort(res.data[o][:n]), np.sort(results[b][1][:n]), rtol=1e-4
        ):
            mismatches += 1
    assert mismatches == 0


def test_hybrid_from_vectors_matches_closest_docs(setup):
    index, claims = setup
    ranker = TfidfRanker(index, "cpu", **CONFIGS["hybrid_wb2"])
    buckets, weights = ranker._vectorize(claims)
    s, i = ranker.hybrid_from_vectors(buckets, weights, 5)
    pending = ranker._closest_hybrid_async(claims, 5)
    out = ranker.finalize_closest(pending, len(claims))
    for b, (ids, scores) in enumerate(out):
        assert ids == [index.doc_ids[x] for x in i[b] if x >= 0]
        np.testing.assert_array_equal(scores, s[b][i[b] >= 0])


def test_loaded_split_ranks_like_a_rebuilt_one(setup, tmp_path):
    """A split saved by the JAX package loads into the port's ranker and
    ranks as a split the port builds itself."""
    index, claims = setup
    path = str(tmp_path / "split.npz")
    save_split(split_index(index, df_threshold=8), path)
    built = TfidfRanker(index, "cpu", mode="hybrid", df_threshold=8)
    loaded = TfidfRanker(index, "cpu", mode="hybrid", split=load_split(path))
    assert loaded.df_threshold == 8
    for (ids_b, sc_b), (ids_l, sc_l) in zip(
        built.closest_docs_batch(claims, k=5), loaded.closest_docs_batch(claims, k=5)
    ):
        assert ids_b == ids_l
        np.testing.assert_array_equal(sc_b, sc_l)


def test_engine_gates_and_auto_mode(setup, monkeypatch):
    index, _ = setup
    assert TfidfRanker(index, "cpu").mode == "ell"
    monkeypatch.setattr(TfidfRanker, "ELL_MAX_DOCS", 10)
    assert TfidfRanker(index, "cpu", df_threshold=8).mode == "hybrid"
    assert TfidfRanker.FUSED_LIGHT_MAX_DOCS == 200_000
    assert TfidfRanker(index, "cpu", df_threshold=8).d_tile == 1024


@pytest.mark.parametrize(
    "kwargs,exc,match",
    [
        (dict(mode="ragged"), NotImplementedError, "item 6"),
        (dict(mode="hybrid", width_buckets=2, select_rescore=16),
         NotImplementedError, "item 5"),
        (dict(mode="sparse"), ValueError, "unknown mode"),
        (dict(precision="bf16"), ValueError, "unknown precision"),
        (dict(union_round=100), ValueError, "multiple of 512"),
    ],
)
def test_unported_and_invalid_options_raise(setup, kwargs, exc, match):
    index, _ = setup
    with pytest.raises(exc, match=match):
        TfidfRanker(index, "cpu", **kwargs)


def test_staged_engine_past_fused_gate_is_not_ported(setup, monkeypatch):
    index, claims = setup
    ranker = TfidfRanker(index, "cpu", mode="hybrid", df_threshold=8, width_buckets=2)
    monkeypatch.setattr(TfidfRanker, "FUSED_LIGHT_MAX_DOCS", 10)
    with pytest.raises(NotImplementedError, match="item 5"):
        TfidfRanker(index, "cpu", mode="hybrid", df_threshold=8, width_buckets=2)
    with pytest.raises(NotImplementedError, match="item 6"):
        ranker.dense_scores_batch(claims[:2])


def test_device_is_required(setup):
    index, _ = setup
    with pytest.raises(TypeError):
        TfidfRanker(index)  # no default device
