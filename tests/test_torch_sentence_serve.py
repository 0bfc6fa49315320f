"""The port's two-stage sentence search against ``ircl_tpu``'s.

Both packages index the same seeded synthetic corpus and score stage 2 with
the same embed function: a crc32-seeded fake embedder (numpy, identical on
both sides), or the contrastive encoder over a hash featurizer with the JAX
package's weights carried across (``utils/convert.py``). Mirrors
``tests/test_pipeline.py:115-165``, ``tests/test_serve.py:708-748`` and
``tests/test_end_to_end.py``. Tolerances: (doc, sent) lists equal; scores
rtol 1e-6 from the shared numpy embedder, 1e-5 absolute through the encoder
(fp32, sums in another order); error replies equal word for word.
"""

import io
import json
import unicodedata
import zlib

import jax
import numpy as np
import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu import serve as j_serve
from ircl_tpu.contrastive.state import TrainConfig as JTrainConfig
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.index.build import build_count_index
from ircl_tpu.index.ranker import TfidfRanker as JRanker
from ircl_tpu.index.tfidf import tfidf_transform
from ircl_tpu.models import encoder as j_enc
from ircl_tpu.models import featurizer as j_feat
from ircl_tpu.pipeline import dense_scorer as j_ds
from ircl_tpu.pipeline import retrieve as j_rt
from ircl_tpu_torch import serve as t_serve
from ircl_tpu_torch.contrastive.state import TrainConfig
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.models import encoder as t_enc
from ircl_tpu_torch.models import featurizer as t_feat
from ircl_tpu_torch.pipeline import dense_scorer as t_ds
from ircl_tpu_torch.pipeline import retrieve as t_rt
from ircl_tpu_torch.utils import convert


def fake_embed(texts):
    """Deterministic device-free embedder: crc32-seeded unit vectors."""
    out = np.zeros((len(texts), 16), np.float32)
    for i, t in enumerate(texts):
        rng = np.random.default_rng(zlib.crc32(t.encode("utf-8")))
        v = rng.normal(size=16).astype(np.float32)
        out[i] = v / np.linalg.norm(v)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    wiki = generate(num_docs=120, num_claims=40, seed=7)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=2**20))
    path = str(tmp_path_factory.mktemp("index") / "index.npz")
    index.save(path)
    claims = [c.claim for c in wiki.claims]
    return wiki, index, path, claims


@pytest.fixture(scope="module")
def rankers(corpus):
    _, index, _, _ = corpus
    return JRanker(index), TfidfRanker(index, "cpu")


def _untied(ranker, claims, k):
    """The claims whose k-th doc scores strictly above the (k+1)-th: there
    both packages retrieve the same k docs (ties at the cut may go either
    way), so stage 2 sees the same candidates."""
    out = [c for c, (_, s) in zip(claims, ranker.closest_docs_batch(claims, k=k + 1))
           if len(s) <= k or s[k - 1] > s[k] * (1 + 1e-5)]
    assert len(out) >= len(claims) // 2
    return out


def test_gather_candidates_matches_jax():
    """Doc ids found as given, through NFKD, through NFD, or not at all."""
    nfc = unicodedata.normalize("NFC", "Café_Noir")
    doc_sentences = {
        "Plain": ["s0", "", "s2"],
        unicodedata.normalize("NFD", nfc): ["nfd s0"],
        "fi_ligature": ["nfkd s0", "nfkd s1"],
        "Empty": [],
    }
    ids = [["Plain", nfc], ["ﬁ_ligature", "Missing"], [], ["Empty", "Plain"]]
    want = j_rt.gather_candidates(ids, doc_sentences)
    got = t_rt.gather_candidates(ids, doc_sentences)
    assert got == want
    assert got[1][0] == [("Plain", 0), ("Plain", 2), (nfc, 0)]


def _scorers(wiki):
    """(JAX, port) pairs: on the fly, and the precomputed table."""
    on_the_fly = lambda mod: lambda cs, cands: mod._score_by_embed(fake_embed, cs, cands)  # noqa: E731
    return [
        (on_the_fly(j_ds), on_the_fly(t_ds)),
        (j_ds.PrecomputedSentenceScorer(fake_embed, wiki.sentences),
         t_ds.PrecomputedSentenceScorer(fake_embed, wiki.sentences)),
    ]


def _same_results(got, want, rtol=1e-6, atol=0.0):
    """Docs: the same set with the same scores (equal scores may come back
    in another order); sentences: the same ranked list."""
    for g_ids, w_ids, g_s, w_s in zip(got.doc_ids, want.doc_ids, got.doc_scores,
                                      want.doc_scores):
        assert set(g_ids) == set(w_ids)
        np.testing.assert_allclose(g_s, w_s, rtol=1e-5)
    assert got.sentences == want.sentences
    for a, b in zip(got.sentence_scores, want.sentence_scores):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("which", ["on_the_fly", "precomputed"])
def test_retrieve_matches_jax(corpus, rankers, which):
    wiki, _, _, claims = corpus
    j_scorer, t_scorer = _scorers(wiki)[which == "precomputed"]
    claims = _untied(rankers[0], claims, 3)
    kw = dict(k_docs=3, k_sents=4, batch_size=16)
    want = j_rt.retrieve(claims, rankers[0], wiki.sentences, j_scorer, **kw)
    got = t_rt.retrieve(claims, rankers[1], wiki.sentences, t_scorer, **kw)
    _same_results(got, want)
    assert sum(len(s) for s in got.sentences) > 100


def test_precomputed_scorer_edges_match_jax(corpus):
    wiki, _, _, _ = corpus
    pre = t_ds.PrecomputedSentenceScorer(fake_embed, wiki.sentences)
    j_pre = j_ds.PrecomputedSentenceScorer(fake_embed, wiki.sentences)
    np.testing.assert_array_equal(pre.table, j_pre.table)
    (empty,) = pre.score_keys(["a claim"], [[]])
    assert empty.shape == (0,)
    with pytest.raises(KeyError):
        pre.score_keys(["a claim"], [[("no_such_doc", 0)]])
    doc = next(iter(wiki.sentences))
    cands = [[wiki.sentences[doc][0], "novel text"]]
    np.testing.assert_array_equal(pre(["a claim"], cands)[0],
                                  j_pre(["a claim"], cands)[0])
    pre2 = t_ds.PrecomputedSentenceScorer(fake_embed, wiki.sentences, table=pre.table)
    np.testing.assert_array_equal(pre2.score_keys(["c"], [[(doc, 0)]])[0],
                                  pre.score_keys(["c"], [[(doc, 0)]])[0])
    with pytest.raises(ValueError, match="preloaded table"):
        t_ds.PrecomputedSentenceScorer(fake_embed, wiki.sentences, table=pre.table[:-1])
    assert t_ds.PrecomputedSentenceScorer(fake_embed, {}).table.shape == (0, 0)
    assert t_ds._score_by_embed(fake_embed, ["a", "b"], [[], []])[1].shape == (0,)


@pytest.fixture(scope="module")
def encoders():
    """The contrastive encoder over a hash featurizer, in both packages,
    with the JAX package's weights."""
    fcfg = dict(dim=16, max_len=16, vocab_buckets=1 << 12)
    enc = dict(input_size=16, hidden_size=8, output_size=8, num_layers=1)
    j_f = j_feat.HashEmbedFeaturizer(j_feat.FeaturizerConfig(**fcfg))
    t_f = t_feat.HashEmbedFeaturizer(
        t_feat.FeaturizerConfig(**fcfg),
        device="cpu",
        params=convert.hash_featurizer_params_from_numpy(
            jax.tree.map(np.asarray, j_f.params), device="cpu"
        ),
    )
    j_cfg = JTrainConfig(encoder=j_enc.EncoderConfig(**enc))
    t_cfg = TrainConfig(encoder=t_enc.EncoderConfig(**enc))
    j_params = j_enc.init_encoder_params(jax.random.PRNGKey(21), j_cfg.encoder)
    t_params = convert.encoder_params_from_numpy(
        jax.tree.map(np.asarray, j_params), device="cpu")

    class _State:  # what ContrastiveSentenceScorer reads of a TrainState
        params_q = j_params

    j_sc = j_ds.ContrastiveSentenceScorer(j_cfg, j_f, _State(), batch_size=32)
    t_sc = t_ds.ContrastiveSentenceScorer(t_cfg, t_f, t_params, batch_size=32)
    return j_sc, t_sc


def test_contrastive_scorer_matches_jax(corpus, rankers, encoders):
    """The end-to-end slice through the encoder (``test_end_to_end.py``):
    on the fly and from the precomputed table, in both packages."""
    wiki, _, _, claims = corpus
    j_sc, t_sc = encoders
    texts = claims[:5] + ["", "x"]
    np.testing.assert_allclose(t_sc.embed(texts), j_sc.embed(texts), rtol=0, atol=1e-5)
    claims = _untied(rankers[0], claims, 5)
    kw = dict(k_docs=5, k_sents=5, batch_size=16)
    want = j_rt.retrieve(claims, rankers[0], wiki.sentences, j_sc, **kw)
    got = t_rt.retrieve(claims, rankers[1], wiki.sentences, t_sc, **kw)
    _same_results(got, want, rtol=0, atol=1e-5)
    pre = t_ds.PrecomputedSentenceScorer.from_scorer(t_sc, wiki.sentences)
    np.testing.assert_allclose(
        pre.table, j_ds.PrecomputedSentenceScorer.from_scorer(j_sc, wiki.sentences).table,
        rtol=0, atol=1e-5,
    )
    got_pre = t_rt.retrieve(claims, rankers[1], wiki.sentences, pre, **kw)
    _same_results(got_pre, got, rtol=1e-5, atol=1e-6)


def test_sparse_scorers_come_along(corpus):
    wiki, _, _, claims = corpus
    doc = next(iter(wiki.sentences))
    cands = [wiki.sentences[doc], []]
    want = j_rt.host_sparse_scorer(hash_size=1 << 16)(claims[:2], cands)
    got = t_rt.host_sparse_scorer(hash_size=1 << 16)(claims[:2], cands)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    # the ranker-backed scorer runs on dense_scores_batch (the ragged engine)
    # and gives the JAX ranker's scores (rtol 1e-5: another summation order)
    sub_index = lambda sents: tfidf_transform(  # noqa: E731
        build_count_index(MemoryDocStore(list(sents)), ngram=2, hash_size=1 << 16))
    via_ranker = t_rt.sparse_sentence_scorer(
        lambda sents: TfidfRanker(sub_index(sents), "cpu"))(claims[:2], cands)
    j_via_ranker = j_rt.sparse_sentence_scorer(
        lambda sents: JRanker(sub_index(sents)))(claims[:2], cands)
    assert via_ranker[0].shape == (len(cands[0]),) and via_ranker[1].shape == (0,)
    for a, b in zip(via_ranker, j_via_ranker):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def _same_hits(got, want, rtol=1e-6):
    """Per query, the same hits in the same order, scores within rtol."""
    assert len(got) == len(want)
    for t_hits, j_hits in zip(got, want):
        strip = lambda hits: [{k: v for k, v in h.items() if k != "score"}  # noqa: E731
                              for h in hits]
        assert strip(t_hits) == strip(j_hits)
        np.testing.assert_allclose([h["score"] for h in t_hits],
                                   [h["score"] for h in j_hits], rtol=rtol)


def _services(rankers, scorers, **kw):
    kw = dict(batch_size=4, default_k=3, default_k_sents=2, **kw)
    return (j_serve.RetrievalService(rankers[0], sentence_scorer=scorers[0], **kw),
            t_serve.RetrievalService(rankers[1], sentence_scorer=scorers[1], **kw))


@pytest.mark.parametrize("which", ["on_the_fly", "precomputed"])
def test_search_sentences_matches_jax(corpus, rankers, which):
    wiki, _, _, claims = corpus
    js, ts = _services(rankers, _scorers(wiki)[which == "precomputed"],
                       doc_sentences=wiki.sentences)
    assert ts.has_sentence_stage and js.has_sentence_stage
    ts.warmup()
    js.warmup()
    queries = claims[:10]
    for args in [dict(), dict(k=2, k_sents=5), dict(k=50, k_sents=1)]:
        _same_hits(ts.search_sentences(queries, **args),
                   js.search_sentences(queries, **args))
    ks, k_sents = [1, 3, 2, 5], [4, 1, 2, 3]
    _same_hits(ts.search_sentences_multi(queries[:4], ks, k_sents),
               js.search_sentences_multi(queries[:4], ks, k_sents))
    assert ts.search_sentences([]) == js.search_sentences([]) == []


def test_precomputed_service_matches_on_the_fly(corpus, rankers):
    """``tests/test_serve.py:708-748`` on the port: the table service and the
    on-the-fly service give the same (doc_id, sent_id) lists."""
    wiki, _, _, claims = corpus
    kw = dict(batch_size=4, default_k=3, doc_sentences=wiki.sentences,
              default_k_sents=2)
    fly = t_serve.RetrievalService(
        rankers[1], sentence_scorer=lambda cs, c: t_ds._score_by_embed(fake_embed, cs, c),
        **kw)
    pre = t_serve.RetrievalService(
        rankers[1], sentence_scorer=t_ds.PrecomputedSentenceScorer(
            fake_embed, wiki.sentences), **kw)
    pre.warmup()
    got_fly = fly.search_sentences(claims[:8], k=3, k_sents=2)
    got_pre = pre.search_sentences(claims[:8], k=3, k_sents=2)
    keys = lambda res: [[(r["doc_id"], r["sent_id"]) for r in q] for q in res]  # noqa: E731
    assert keys(got_pre) == keys(got_fly)
    for a, b in zip(got_pre, got_fly):
        np.testing.assert_allclose([r["score"] for r in a], [r["score"] for r in b],
                                   rtol=1e-6)


def test_sentence_search_needs_the_stage(rankers):
    js = j_serve.RetrievalService(rankers[0], batch_size=4)
    ts = t_serve.RetrievalService(rankers[1], batch_size=4)
    assert not ts.has_sentence_stage
    for args in [dict(), dict(k=0)]:
        with pytest.raises(ValueError) as want:
            js.search_sentences(["a claim"], **args)
        with pytest.raises(ValueError) as got:
            ts.search_sentences(["a claim"], **args)
        assert str(got.value) == str(want.value)


def _lines(claims):
    return [
        json.dumps({"query": claims[0], "sentences": True}),
        json.dumps({"queries": claims[1:6], "k_sents": 3}),
        json.dumps({"queries": claims[6:9], "k": 2, "k_sents": 1}),
        json.dumps({"queries": claims[9:11]}),  # a plain doc search
        json.dumps({"queries": claims[11:13], "k_sents": 0}),
        json.dumps({"queries": claims[11:13], "k_sents": "2"}),
        json.dumps({"queries": "a bare string", "sentences": True}),
        json.dumps({"queries": [], "sentences": True}),
        json.dumps({"claim": claims[0]}),
        "not json",
    ]


def _serve(module, service, lines):
    out = io.StringIO()
    served = module.serve_stdin(service, io.StringIO("\n".join(lines) + "\n"), out)
    return served, [json.loads(x) for x in out.getvalue().splitlines()]


@pytest.mark.parametrize("with_stage", [True, False])
def test_serve_stdin_sentence_replies_match_jax(corpus, with_stage):
    wiki, _, path, claims = corpus
    pre = [j_ds.PrecomputedSentenceScorer(fake_embed, wiki.sentences),
           t_ds.PrecomputedSentenceScorer(fake_embed, wiki.sentences)]
    stage = lambda i: (  # noqa: E731
        dict(doc_sentences=wiki.sentences, sentence_scorer=pre[i]) if with_stage
        else {}
    )
    js = j_serve.make_service(path, batch_size=8, **stage(0))
    ts = t_serve.make_service(path, batch_size=8, device="cpu", **stage(1))
    assert ts.default_k_sents == js.default_k_sents == 5
    lines = _lines(claims)
    j_served, j_replies = _serve(j_serve, js, lines)
    t_served, t_replies = _serve(t_serve, ts, lines)
    assert t_served == j_served
    assert len(t_replies) == len(j_replies) == len(lines)
    n_sentence_results = 0
    for t_rep, j_rep in zip(t_replies, j_replies):
        assert set(t_rep) == set(j_rep)
        if "error" in j_rep:
            assert t_rep["error"] == j_rep["error"]
            continue
        _same_hits(t_rep["results"], j_rep["results"], rtol=1e-5)
        n_sentence_results += sum(
            "sent_id" in h for hits in t_rep["results"] for h in hits
        )
    assert (n_sentence_results > 20) == with_stage
    tm, jm = ts.metrics.snapshot(), js.metrics.snapshot()
    for key in ("requests", "queries", "device_batches", "errors"):
        assert tm[key] == jm[key], key
