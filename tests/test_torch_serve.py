"""The port's stdin service against ``ircl_tpu.serve`` on the same lines.

An index built and saved by the JAX package (``CountIndex.save``) loads into
both packages' ``make_service``; the same JSONL lines go through both
``serve_stdin`` loops. Doc ids must agree except across exact ties, scores
within rtol 1e-5, and malformed lines must get the same error replies.
"""

import io
import json

import numpy as np
import pytest

from _torch_parity import assert_topk_match, one_torch_thread  # noqa: F401
from ircl_tpu import serve as j_serve
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.index.build import build_count_index
from ircl_tpu.index.tfidf import tfidf_transform
from ircl_tpu_torch import serve as t_serve
from ircl_tpu_torch.index.ranker import TfidfRanker


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    wiki = generate(num_docs=120, num_claims=30, seed=5)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=2**20))
    path = str(tmp_path_factory.mktemp("index") / "index.npz")
    index.save(path)  # the JAX package writes the artifact
    return path, index, [c.claim for c in wiki.claims]


def _lines(claims):
    return [
        json.dumps({"query": claims[0]}),
        json.dumps({"queries": claims[1:12]}),  # more than one batch
        json.dumps({"queries": claims[12:15], "k": 3}),
        json.dumps({"queries": claims[15:17], "k": 50}),  # clamps to k_max
        "",
        "not json",
        "[1, 2]",
        json.dumps({"queries": "a bare string"}),
        json.dumps({"queries": [claims[0]], "k": 0}),
        json.dumps({"queries": [claims[0]], "k": True}),
        json.dumps({"claims": [claims[0]]}),
        json.dumps({"query": claims[0], "sentences": True}),
        json.dumps({"nothing": 1}),
        json.dumps({"queries": []}),
    ]


def _serve(module, service, lines):
    out = io.StringIO()
    served = module.serve_stdin(service, io.StringIO("\n".join(lines) + "\n"), out)
    return served, [json.loads(x) for x in out.getvalue().splitlines()]


def _as_arrays(results, doc2idx, k):
    scores = np.zeros((len(results), k), np.float32)
    ids = np.full((len(results), k), -1, np.int64)
    for b, hits in enumerate(results):
        scores[b, : len(hits)] = [h["score"] for h in hits]
        ids[b, : len(hits)] = [doc2idx[h["doc_id"]] for h in hits]
    return scores, ids


@pytest.mark.parametrize("mode", ["auto", "hybrid"])
def test_serve_stdin_matches_jax_service(saved, mode):
    path, index, claims = saved
    js = j_serve.make_service(path, batch_size=8, mode=mode)
    ts = t_serve.make_service(path, batch_size=8, mode=mode, device="cpu")
    assert ts.ranker.mode == js.ranker.mode
    assert ts.k_max == js.k_max
    lines = _lines(claims)
    j_served, j_replies = _serve(j_serve, js, lines)
    t_served, t_replies = _serve(t_serve, ts, lines)
    assert t_served == j_served
    assert len(t_replies) == len(j_replies) == len(lines) - 1  # blank skipped
    n_results = 0
    for t_rep, j_rep in zip(t_replies, j_replies):
        assert set(t_rep) == set(j_rep)
        if "error" in j_rep:
            assert t_rep["error"] == j_rep["error"]
            continue
        k = max([len(h) for h in j_rep["results"]] + [1])
        assert [len(h) for h in t_rep["results"]] == [
            len(h) for h in j_rep["results"]
        ]
        assert_topk_match(
            *_as_arrays(t_rep["results"], index.doc2idx, k),
            *_as_arrays(j_rep["results"], index.doc2idx, k),
        )
        n_results += len(j_rep["results"])
    assert n_results == 17
    tm, jm = ts.metrics.snapshot(), js.metrics.snapshot()
    for key in ("requests", "queries", "device_batches", "errors"):
        assert tm[key] == jm[key], key


def test_padding_and_chunking_are_invisible(saved):
    path, index, claims = saved
    svc = t_serve.make_service(path, batch_size=4, device="cpu")
    svc.warmup()
    got = svc.search(claims[:10], k=3)
    direct = svc.ranker.closest_docs_batch(claims[:10], k=svc.k_max)
    for hits, (ids, scores) in zip(got, direct):
        assert [h["doc_id"] for h in hits] == ids[:3]
        np.testing.assert_allclose([h["score"] for h in hits], scores[:3])
    assert svc.metrics.snapshot()["device_batches"] == 1 + 3
    assert svc.num_docs == index.num_docs


@pytest.mark.parametrize(
    "req",
    [
        [1], "s", {"queries": [1]}, {"query": 3}, {"queries": ["a"], "k": -1},
        {"queries": ["a"], "k": 2.5}, {"claims": "x"}, {"k_sents": 0, "query": "a"},
    ],
)
def test_parse_request_rejects_like_the_reference(req):
    for key in ("queries", "claims"):
        with pytest.raises(ValueError) as want:
            j_serve.parse_request(req, key=key)
        with pytest.raises(ValueError) as got:
            t_serve.parse_request(req, key=key)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(chunk_docs=1000),
        # the sentence and verdict stages are ported; the chunked engine
        # still raises beside them
        dict(chunk_docs=1000, doc_sentences={"a": ["b"]}),
        dict(chunk_docs=1000, verdict_classifier=object(), sentence_scorer=object()),
        dict(chunk_docs=1000, verdict_classifier=object()),
    ],
)
def test_unported_stages_raise(saved, kwargs):
    path, _, _ = saved
    with pytest.raises(NotImplementedError, match="item 7"):
        t_serve.make_service(path, device="cpu", **kwargs)


def test_make_service_needs_a_device(saved):
    path, _, _ = saved
    with pytest.raises(TypeError):
        t_serve.make_service(path)


def test_service_validation(saved):
    path, index, claims = saved
    svc = t_serve.RetrievalService(TfidfRanker(index, "cpu"), batch_size=2)
    with pytest.raises(ValueError, match="sequence of strings"):
        svc.search("a bare string")
    with pytest.raises(ValueError, match="positive"):
        svc.search(claims[:1], k=0)
    with pytest.raises(ValueError, match="batch_size"):
        t_serve.RetrievalService(svc.ranker, batch_size=0)
    assert svc.search([]) == []
