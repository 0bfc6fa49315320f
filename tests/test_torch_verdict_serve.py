"""The port's served claim verification against ``ircl_tpu.serve``'s.

Both packages load the same saved index (written by the JAX package) and
the same verdict weights (the JAX package's, carried across with
``utils/convert.py``), with and without a sentence stage (the shared
crc32-seeded numpy embedder behind a precomputed table). The same JSONL
claim lines go through both ``serve_stdin`` loops; the JAX side's flash
attention runs in the TPU interpret mode. The verdict model is a small
flash-attention roberta shape (1 layer, hidden 32, one token type, L=128).
Claims are kept where the k-th doc scores strictly above the next, so both
packages retrieve the same evidence. Tolerances: evidence lists equal,
their scores rtol 1e-5 (the scoring GEMM sums in another order); labels
exactly, confidences 1e-5 absolute; error replies word for word.
"""

import io
import json
import zlib

import jax
import numpy as np
import pytest
from jax.experimental.pallas.tpu import force_tpu_interpret_mode

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu import serve as j_serve
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.index.build import build_count_index
from ircl_tpu.index.ranker import TfidfRanker as JRanker
from ircl_tpu.index.tfidf import tfidf_transform
from ircl_tpu.models.transformer import TransformerConfig as JTransformerConfig
from ircl_tpu.models.wordpiece import WordPieceTokenizer as JWordPiece
from ircl_tpu.pipeline import dense_scorer as j_ds
from ircl_tpu.verdict import infer as j_infer
from ircl_tpu.verdict import model as j_model
from ircl_tpu_torch import serve as t_serve
from ircl_tpu_torch.models.transformer import TransformerConfig
from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
from ircl_tpu_torch.pipeline import dense_scorer as t_ds
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.verdict import infer as t_infer
from ircl_tpu_torch.verdict import model as t_model

L = 128
TF_KW = dict(hidden=32, layers=1, heads=2, intermediate=64, max_positions=L,
             type_vocab=1, position_offset=2, layernorm_eps=1e-5, attention="flash")
SERVICE_KW = dict(batch_size=4, default_k=3, default_k_sents=2)


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
    wiki = generate(num_docs=120, num_claims=60, seed=7)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=2**20))
    path = str(tmp_path_factory.mktemp("index") / "index.npz")
    index.save(path)
    claims = [c.claim for c in wiki.claims]
    # claims whose top 2 and top 3 docs are strict: no tie at either cut
    ranked = JRanker(index).closest_docs_batch(claims, k=4)
    untied = [c for c, (_, s) in zip(claims, ranked)
              if all(len(s) <= k or s[k - 1] > s[k] * (1 + 1e-5) for k in (2, 3))]
    assert len(untied) >= 20
    return wiki, path, untied


@pytest.fixture(scope="module")
def classifiers(corpus, tmp_path_factory):
    """The JAX classifier and the port's, through the port's checkpoint."""
    wiki, _, _ = corpus
    tok = JWordPiece.train([rec["text"] for rec in wiki.docs.values()], vocab_size=256)
    j_cfg = j_model.VerdictConfig(
        encoder=JTransformerConfig(vocab_size=tok.vocab_size, **TF_KW), max_length=L)
    t_cfg = t_model.VerdictConfig(
        encoder=TransformerConfig(vocab_size=tok.vocab_size, **TF_KW), max_length=L)
    j_params = j_model.init_verdict_params(jax.random.PRNGKey(4), j_cfg)
    d = tmp_path_factory.mktemp("verdict")
    tok.save_vocab(str(d / "vocab.txt"))
    t_infer.save_verdict_checkpoint(
        str(d), t_cfg,
        convert.verdict_params_from_numpy(jax.tree.map(np.asarray, j_params), device="cpu"),
        WordPieceTokenizer.from_vocab_file(str(d / "vocab.txt")))
    return (j_infer.VerdictClassifier(j_cfg, j_params, tok, batch_size=4),
            t_infer.VerdictClassifier.from_checkpoint(str(d), batch_size=4, device="cpu"))


def _services(corpus, classifiers, with_stage):
    wiki, path, _ = corpus
    stage = lambda mod: (  # noqa: E731
        dict(doc_sentences=wiki.sentences,
             sentence_scorer=mod.PrecomputedSentenceScorer(fake_embed, wiki.sentences))
        if with_stage else {})
    js = j_serve.make_service(path, verdict_classifier=classifiers[0], **stage(j_ds),
                              **SERVICE_KW)
    ts = t_serve.make_service(path, verdict_classifier=classifiers[1], device="cpu",
                              **stage(t_ds), **SERVICE_KW)
    assert ts.has_verdict_stage and js.has_verdict_stage
    assert ts.has_sentence_stage == js.has_sentence_stage == with_stage
    return js, ts


def _same_verdicts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"label", "label_id", "confidence", "evidence"}
        assert (g["label"], g["label_id"]) == (w["label"], w["label_id"])
        assert abs(g["confidence"] - w["confidence"]) <= 1e-5
        strip = lambda hits: [{k: v for k, v in h.items() if k != "score"}  # noqa: E731
                              for h in hits]
        assert strip(g["evidence"]) == strip(w["evidence"])
        np.testing.assert_allclose([h["score"] for h in g["evidence"]],
                                   [h["score"] for h in w["evidence"]], rtol=1e-5)


@pytest.mark.parametrize("with_stage", [True, False])
def test_verify_claims_matches_jax(corpus, classifiers, with_stage):
    _, _, claims = corpus
    js, ts = _services(corpus, classifiers, with_stage)
    with force_tpu_interpret_mode():
        js.warmup()
        want = js.verify_claims(claims[:6], k=2, k_sents=3)
    ts.warmup()
    got = ts.verify_claims(claims[:6], k=2, k_sents=3)
    _same_verdicts(got, want)
    # the evidence is the retrieval result for the same request
    same = (ts.search_sentences(claims[:6], k=2, k_sents=3) if with_stage
            else ts.search(claims[:6], k=2))
    assert [r["evidence"] for r in got] == same
    # a claim alone classifies as it does inside its batch
    assert ts.verify_claims(claims[3:4], k=2, k_sents=3)[0] == got[3]


def _lines(claims):
    return [
        json.dumps({"claim": claims[0]}),
        json.dumps({"claims": claims[1:6], "k": 2, "k_sents": 3}),  # two batches
        json.dumps({"claims": claims[6:9], "k": 3}),
        json.dumps({"claims": []}),
        json.dumps({"claims": "a bare string"}),
        json.dumps({"claims": [claims[0]], "k": 0}),
        json.dumps({"claims": [1, 2]}),
        json.dumps({"claim": claims[0], "k_sents": "2"}),
        json.dumps({"claim": claims[0], "k": True}),
        json.dumps({"query": claims[9]}),  # a doc search beside the claims
        "not json",
    ]


def _serve(module, service, lines):
    out = io.StringIO()
    served = module.serve_stdin(service, io.StringIO("\n".join(lines) + "\n"), out)
    return served, [json.loads(x) for x in out.getvalue().splitlines()]


@pytest.mark.parametrize("with_stage", [True, False])
def test_serve_stdin_claim_lines_match_jax(corpus, classifiers, with_stage):
    _, _, claims = corpus
    js, ts = _services(corpus, classifiers, with_stage)
    lines = _lines(claims)
    with force_tpu_interpret_mode():
        j_served, j_replies = _serve(j_serve, js, lines)
    t_served, t_replies = _serve(t_serve, ts, lines)
    assert t_served == j_served == 5
    assert len(t_replies) == len(j_replies) == len(lines)
    n_verdicts = 0
    for line, t_rep, j_rep in zip(lines, t_replies, j_replies):
        assert set(t_rep) == set(j_rep)
        if "error" in j_rep:
            assert t_rep["error"] == j_rep["error"]
        elif "claim" in line:
            _same_verdicts(t_rep["results"], j_rep["results"])
            n_verdicts += len(t_rep["results"])
        else:
            assert [[h["doc_id"] for h in q] for q in t_rep["results"]] == [
                [h["doc_id"] for h in q] for q in j_rep["results"]]
    assert n_verdicts == 9
    tm, jm = ts.metrics.snapshot(), js.metrics.snapshot()
    for key in ("requests", "queries", "device_batches", "errors"):
        assert tm[key] == jm[key], key


def test_service_without_the_stage_refuses_claims(corpus):
    wiki, path, claims = corpus
    js = j_serve.make_service(path, **SERVICE_KW)
    ts = t_serve.make_service(path, device="cpu", **SERVICE_KW)
    assert not ts.has_verdict_stage
    with pytest.raises(ValueError) as want:
        js.verify_claims(claims[:1])
    with pytest.raises(ValueError) as got:
        ts.verify_claims(claims[:1])
    assert str(got.value) == str(want.value) == t_serve._NO_VERDICT
    lines = [json.dumps({"claim": claims[0]}), json.dumps({"claims": claims[:3]})]
    _, j_replies = _serve(j_serve, js, lines)
    _, t_replies = _serve(t_serve, ts, lines)
    assert t_replies == j_replies == [{"error": t_serve._NO_VERDICT}] * 2
