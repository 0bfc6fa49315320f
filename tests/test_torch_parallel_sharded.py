"""The port's corpus-sharded scorers and ``embed_corpus(mesh=)`` on an
8-rank gloo group against ``ircl_tpu.parallel`` on the 8-device virtual
mesh (``tests/conftest.py``).

Mirrors ``tests/test_sharded_index.py``, ``tests/test_sharded_hybrid.py``
(the reference with both of its slab implementations) and the sharded
cases of ``tests/test_dense.py``. One launch of 8 CPU ranks
(``parallel/launch.py``, targets in ``tests/_torch_ranks.py``) runs every
case on the same numpy inputs that the reference gets; each rank must
return rank 0's bits. Tolerances are the reference tests' own: sparse
scores rtol 1e-4 / atol 1e-6 against the single-device ranker and, sorted,
against the reference's sharded scorer, ids equal except across exact
ties; dense scores rtol 1e-5; the sharded embedding sweep against the
port's own single-device sweep at rtol 1e-6 / atol 1e-7 and against the
reference's (other summation order) at 1e-5 absolute, as
``tests/test_torch_encoder.py`` holds the encoder.
"""

import jax
import numpy as np
import pytest

import _torch_ranks
from _torch_parity import assert_topk_match, one_torch_thread  # noqa: F401
from ircl_tpu.contrastive.state import TrainConfig as JTrainConfig
from ircl_tpu.contrastive.state import init_train_state as j_init_train_state
from ircl_tpu.contrastive.train import make_embed_fn as j_make_embed_fn
from ircl_tpu.corpus.store import MemoryDocStore as JStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.dense.embed import embed_corpus as j_embed_corpus
from ircl_tpu.dense.scorer import sharded_cosine_topk as j_sharded_cosine_topk
from ircl_tpu.index.build import build_count_index as j_build
from ircl_tpu.index.ell import to_ell as j_to_ell
from ircl_tpu.index.ranker import TfidfRanker as JRanker
from ircl_tpu.index.split import gather_light_pools
from ircl_tpu.index.tfidf import tfidf_transform as j_tfidf
from ircl_tpu.models.encoder import EncoderConfig as JEncoderConfig
from ircl_tpu.models.featurizer import FeaturizerConfig as JFeatCfg
from ircl_tpu.models.featurizer import HashEmbedFeaturizer as JHashFeat
from ircl_tpu.ops.membership_pallas import pad_for_slab
from ircl_tpu.parallel.mesh import make_mesh as j_make_mesh
from ircl_tpu.parallel.sharded_hybrid import ShardedHybridIndex as JShardedHybrid
from ircl_tpu.parallel.sharded_index import ShardedEllIndex as JShardedEll
from ircl_tpu_torch.contrastive.state import TrainConfig
from ircl_tpu_torch.contrastive.train import make_embed_fn
from ircl_tpu_torch.corpus.store import MemoryDocStore
from ircl_tpu_torch.dense.embed import embed_corpus
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.ell import to_ell
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.models.encoder import EncoderConfig
from ircl_tpu_torch.models.featurizer import FeaturizerConfig, HashEmbedFeaturizer
from ircl_tpu_torch.parallel.launch import launch
from ircl_tpu_torch.utils import convert

RANKS = 8
ELL_CORPORA = {"90 docs": (90, 30, 9), "120 docs": (120, 32, 17)}  # docs, claims, seed


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _indexes(num_docs, num_claims, seed):
    wiki = generate(num_docs=num_docs, num_claims=num_claims, seed=seed)
    texts = {d: rec["text"] for d, rec in wiki.docs.items()}
    j_index = j_tfidf(j_build(JStore(texts), ngram=2, hash_size=1 << 20))
    t_index = tfidf_transform(build_count_index(MemoryDocStore(texts), ngram=2,
                                                hash_size=1 << 20))
    return j_index, t_index, [c.claim for c in wiki.claims]


def _query_slabs(ranker, buckets, weights):
    u_pad = ranker._union_slots(buckets, weights, floor=512)
    qb_t, qw_t = pad_for_slab(np.ascontiguousarray(buckets.T.astype(np.int32)),
                              np.ascontiguousarray(weights.T), d_tile=128)
    return u_pad, qb_t, qw_t


def _ell_case(num_docs, num_claims, seed):
    j_index, t_index, claims = _indexes(num_docs, num_claims, seed)
    single = JRanker(j_index, mode="ell")
    buckets, weights = single._vectorize(claims)
    u, qb_t, qw_t = _query_slabs(single, buckets, weights)
    want = JShardedEll(j_to_ell(j_index), j_make_mesh(("corpus",))).topk(
        u, qb_t, qw_t, k=5)
    case = dict(ell=to_ell(t_index), u=u, qb_t=qb_t, qw_t=qw_t, k=5)
    return case, dict(index=j_index, claims=claims,
                      single=single.closest_docs_batch(claims, k=5), sharded=want)


def _hybrid_case():
    j_index, t_index, claims = _indexes(120, 32, 17)
    single = JRanker(j_index, mode="hybrid", df_threshold=8)
    split = single._split
    t_split = TfidfRanker(t_index, "cpu", mode="hybrid", df_threshold=8)._split
    for f in ("light_indptr", "light_docs", "light_vals", "doc_freqs"):
        np.testing.assert_array_equal(getattr(t_split, f), getattr(split, f))
    buckets, weights = single._vectorize(claims)
    hw = np.where(split.doc_freqs[buckets] > split.df_threshold, weights,
                  0.0).astype(np.float32)
    u, qb_t, qw_t = _query_slabs(single, buckets, hw)
    light_docs, light_contribs, _ = gather_light_pools(split, buckets, weights)
    args = (u, qb_t, qw_t, light_docs, light_contribs)
    mesh = j_make_mesh(("corpus",))
    sharded = {impl: JShardedHybrid(split, mesh, slab_impl=impl) for impl in ("xla", "pallas")}
    want = {impl: idx.topk(*args, k=5) for impl, idx in sharded.items()}
    want["routed"] = sharded["xla"].route_light(light_docs, light_contribs)
    case = dict(split=t_split, u=u, qb_t=qb_t, qw_t=qw_t, light_docs=light_docs,
                light_contribs=light_contribs, k=5)
    return case, dict(index=j_index, claims=claims,
                      single=single.closest_docs_batch(claims, k=5), sharded=want)


DENSE = {  # tests/test_dense.py's sharded cases: (queries, corpus, k)
    "matches single device": lambda: (
        lambda rng: (_unit(rng.normal(size=(16, 32))), _unit(rng.normal(size=(200, 32)))))(
            np.random.default_rng(0)),
    "ragged corpus": lambda: (
        lambda rng: (_unit(rng.normal(size=(4, 16))), _unit(rng.normal(size=(13, 16)))))(
            np.random.default_rng(1)),
    "negative cosines with padding": lambda: (
        lambda rng, q: (q, _unit(-q[:1] + 0.01 * rng.normal(size=(13, 16)))))(
            np.random.default_rng(4), _unit(np.random.default_rng(4).normal(size=(6, 16)))),
}


def _embed_case():
    """tests/test_dense.py::test_embed_corpus_sharded_matches_single_device."""
    enc = dict(input_size=16, hidden_size=8, output_size=8, num_layers=1)
    tc = dict(queue_size=16, micro_batch=8, accum_steps=2)
    feat_kw = dict(dim=16, max_len=8, vocab_buckets=1 << 10)
    j_cfg = JTrainConfig(encoder=JEncoderConfig(**enc), **tc)
    j_feat = JHashFeat(JFeatCfg(**feat_kw))
    params = j_init_train_state(jax.random.PRNGKey(0), j_cfg).params_q
    texts = [f"doc {i} alpha beta tok{i}" for i in range(37)]  # ragged tail
    j_fn = j_make_embed_fn(j_cfg, j_feat)
    want = dict(
        single=j_embed_corpus(j_fn, params, j_feat, texts, batch_size=16),
        sharded=j_embed_corpus(j_fn, params, j_feat, texts, batch_size=16,
                               mesh=j_make_mesh(("data",))),
    )
    case = dict(cfg=TrainConfig(encoder=EncoderConfig(**enc), **tc),
                feat_cfg=FeaturizerConfig(**feat_kw),
                feat_params=jax.tree.map(np.asarray, j_feat.params),
                params_q=jax.tree.map(np.asarray, params), texts=texts, batch_size=16)
    return case, want


@pytest.fixture(scope="module")
def runs():
    """Every case's inputs and the reference's results, then one launch of
    the port's 8 ranks over all of them."""
    assert len(jax.devices()) == RANKS, "conftest must force 8 CPU devices"
    cases, refs = {"ell": {}}, {}
    for name, shape in ELL_CORPORA.items():
        cases["ell"][name], refs[name] = _ell_case(*shape)
    cases["hybrid"], refs["hybrid"] = _hybrid_case()
    cases["embed"], refs["embed"] = _embed_case()
    cases["dense"] = {name: (*make(), 5) for name, make in DENSE.items()}
    refs["dense"] = {name: (q, c, j_sharded_cosine_topk(q, c, k=5, mesh=j_make_mesh(
        ("corpus",)))) for name, (q, c, _) in cases["dense"].items()}
    return cases, refs, launch(_torch_ranks.sharded_scoring, RANKS, cases, device="cpu")


def _check_against_ranker(s, i, ref, index):
    """The reference tests' check against the single-device ranker."""
    for b, (ids_ref, scores_ref) in enumerate(ref):
        keep = i[b] >= 0
        got_ids = [index.doc_ids[j] for j in i[b][keep]]
        assert len(got_ids) == len(ids_ref), f"query {b}"
        np.testing.assert_allclose(np.sort(s[b][keep]), np.sort(scores_ref),
                                   rtol=1e-4, atol=1e-6)
        assert set(got_ids) == set(ids_ref) or np.allclose(
            sorted(s[b][keep]), sorted(scores_ref), rtol=1e-4)


def _check_against_sharded(s, i, want_s, want_i):
    np.testing.assert_allclose(np.sort(s, axis=1), np.sort(want_s, axis=1),
                               rtol=1e-4, atol=1e-6)
    assert_topk_match(s, i, want_s, want_i, rtol=1e-4)


@pytest.mark.parametrize("corpus", list(ELL_CORPORA))
def test_sharded_sparse_topk_matches_single_device(runs, corpus):
    """tests/test_sharded_index.py (its 90-doc corpus, and the hybrid
    test's 120 docs): 8 doc shards of the ELL index."""
    _, refs, got = runs
    ref = refs[corpus]
    s, i = got[corpus]
    n = len(ref["claims"])
    _check_against_ranker(s[:n], i[:n], ref["single"], ref["index"])
    _check_against_sharded(s, i, *ref["sharded"])


@pytest.mark.parametrize("slab_impl", ["xla", "pallas"])
def test_sharded_hybrid_matches_single_device(runs, slab_impl):
    """tests/test_sharded_hybrid.py: the port's sharded hybrid against the
    reference's with either slab, and against the single-device ranker."""
    _, refs, got = runs
    ref = refs["hybrid"]
    s, i = got["hybrid"]
    n = len(ref["claims"])
    assert s.shape == i.shape == (n, 5)
    _check_against_ranker(s, i, ref["single"], ref["index"])
    _check_against_sharded(s, i, *ref["sharded"][slab_impl])


def test_route_light_matches_reference(runs):
    """The host routing is a line-for-line copy: equal pools, shard by
    shard."""
    _, refs, got = runs
    for g, w in zip(got["hybrid_routed"], refs["hybrid"]["sharded"]["routed"]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", list(DENSE))
def test_sharded_dense_topk_matches_reference(runs, case):
    """tests/test_dense.py's sharded cases: against numpy, as the reference
    tests hold the reference, and against the reference's sharded scorer;
    no pad row is returned, and real negative-cosine docs beat the pads."""
    _, refs, got = runs
    q, c, (want_s, want_i) = refs["dense"][case]
    s, i = got[case]
    ref = q @ c.T
    assert s.shape == i.shape == (q.shape[0], 5)
    for b in range(q.shape[0]):
        order = np.argsort(-ref[b])[:5]
        assert (i[b] >= 0).all() and (i[b] < c.shape[0]).all(), i[b]
        np.testing.assert_allclose(s[b], ref[b][order], rtol=1e-5)
        np.testing.assert_allclose(ref[b][i[b]], s[b], rtol=1e-5)
    assert_topk_match(s, i, want_s, want_i, rtol=1e-5)


def test_embed_corpus_sharded_matches_single_device(runs):
    cases, refs, got = runs
    c = cases["embed"]
    feat = HashEmbedFeaturizer(c["feat_cfg"], device="cpu",
                               params=convert.hash_featurizer_params_from_numpy(
                                   c["feat_params"], device="cpu"))
    params = convert.encoder_params_from_numpy(c["params_q"], device="cpu")
    single = embed_corpus(make_embed_fn(c["cfg"], feat), params, feat, c["texts"],
                          batch_size=c["batch_size"])
    sharded = got["embed"]
    assert sharded.shape == single.shape == refs["embed"]["sharded"].shape == (37, 8)
    np.testing.assert_allclose(sharded, single, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sharded, refs["embed"]["sharded"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(single, refs["embed"]["single"], rtol=0, atol=1e-5)


def test_launch_fails_with_the_failed_ranks_traceback():
    """A rank that raises fails the launch, naming it, and the rank left
    waiting in a collective is stopped."""
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of 2 failed.*told to fail"):
        launch(_torch_ranks.raise_on_rank, 2, 1, device="cpu", timeout=120)


def test_make_mesh_needs_a_process_group(monkeypatch):
    from ircl_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(("corpus",), device="cpu")


def test_ranks_refuse_what_is_not_a_mesh():
    from ircl_tpu_torch.dense.scorer import make_sharded_topk, shard_corpus
    from ircl_tpu_torch.parallel.sharded_hybrid import ShardedHybridIndex
    from ircl_tpu_torch.parallel.sharded_index import ShardedEllIndex

    for fn in (lambda: ShardedEllIndex(None, object()),
               lambda: ShardedHybridIndex(None, object()),
               lambda: shard_corpus(np.zeros((4, 2), np.float32), object()),
               lambda: make_sharded_topk(object(), 5)):
        with pytest.raises(TypeError, match="DeviceMesh"):
            fn()
