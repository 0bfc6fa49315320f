"""The port's micro-batcher, HTTP front and chunked service against
``ircl_tpu.serve``'s.

Mirrors ``tests/test_serve.py``: the HTTP cases (:116-180), two-stage over
HTTP and stdin (:250-279), the batcher and the batched transport (:357-708),
claim verification over HTTP and stdin and the chunked service (:836-902).
Both packages index the same six docs (the index is written by the JAX
package and loaded by both); the same requests go through the JAX
package's service, batcher and front and through the port's. Tolerances:
doc ids equal except across exact ties and scores within rtol 1e-5
(``_torch_parity.assert_topk_match``); sentence lists equal, their scores
rtol 1e-6 (the same host scorer on both sides); HTTP status codes, bodies of
error replies and error strings equal byte for byte. Every join and HTTP
call has a timeout, so a hang fails one test.
"""

import http.client
import io
import json
import threading

import jax
import numpy as np
import pytest

from _torch_parity import assert_topk_match, one_torch_thread  # noqa: F401
from ircl_tpu import serve as j_serve
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.index.build import CountIndex as JCountIndex
from ircl_tpu.index.build import build_count_index
from ircl_tpu.index.ranker import TfidfRanker as JRanker
from ircl_tpu.index.tfidf import tfidf_transform
from ircl_tpu.models.transformer import TransformerConfig as JTransformerConfig
from ircl_tpu.models.wordpiece import WordPieceTokenizer as JWordPiece
from ircl_tpu.pipeline.retrieve import host_sparse_scorer as j_host_scorer
from ircl_tpu.verdict import infer as j_infer
from ircl_tpu.verdict import model as j_model
from ircl_tpu_torch import serve as t_serve
from ircl_tpu_torch.index.build import CountIndex
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.models.transformer import TransformerConfig
from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
from ircl_tpu_torch.pipeline.retrieve import host_sparse_scorer
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.verdict import infer as t_infer
from ircl_tpu_torch.verdict import model as t_model

TIMEOUT = 60

DOCS = {
    "Apollo_11": "apollo eleven landed on the moon in nineteen sixty nine",
    "Moon": "the moon is a natural satellite of the earth",
    "Mars": "mars is the fourth planet from the sun",
    "Saturn_V": "the saturn five rocket launched apollo missions to the moon",
    "Earth": "earth is the third planet orbiting the sun",
    "Venus": "venus is the second planet from the sun",
}

QUERIES = [
    "rocket that launched apollo to the moon",
    "planet fourth from the sun",
    "natural satellite of the earth",
]


def _sentences():
    return {d: [s.strip() for s in t.split(" in ")] for d, t in DOCS.items()}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    index = tfidf_transform(
        build_count_index(MemoryDocStore(DOCS), ngram=2, hash_size=1 << 18)
    )
    path = str(tmp_path_factory.mktemp("index") / "tfidf.npz")
    index.save(path)
    return path, index.doc2idx


@pytest.fixture(scope="module")
def rankers(saved):
    path, _ = saved
    return JRanker(JCountIndex.load(path)), TfidfRanker(CountIndex.load(path), "cpu")


def _services(rankers, **kw):
    """The same ``RetrievalService`` in both packages."""
    two_stage = kw.pop("two_stage", False)
    j_kw, t_kw = dict(kw), dict(kw)
    if two_stage:
        j_kw.update(doc_sentences=_sentences(), sentence_scorer=j_host_scorer())
        t_kw.update(doc_sentences=_sentences(), sentence_scorer=host_sparse_scorer())
    return (j_serve.RetrievalService(rankers[0], **j_kw),
            t_serve.RetrievalService(rankers[1], **t_kw))


def _arrays(results, doc2idx, k):
    scores = np.zeros((len(results), k), np.float32)
    ids = np.full((len(results), k), -1, np.int64)
    for b, hits in enumerate(results):
        scores[b, : len(hits)] = [h["score"] for h in hits]
        ids[b, : len(hits)] = [doc2idx[h["doc_id"]] for h in hits]
    return scores, ids


def same_docs(got, want, doc2idx):
    """Doc-search results: per query the same number of hits, ids equal
    except across exact ties, scores within rtol 1e-5."""
    assert [len(h) for h in got] == [len(h) for h in want]
    k = max([len(h) for h in want] + [1])
    assert_topk_match(*_arrays(got, doc2idx, k), *_arrays(want, doc2idx, k))


def same_sentences(got, want):
    strip = lambda per_q: [  # noqa: E731
        [{k: v for k, v in h.items() if k != "score"} for h in hits] for hits in per_q]
    assert strip(got) == strip(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in w],
                                   rtol=1e-6)


def _post(port, path, body: bytes, conn=None):
    """(status, raw body) of one POST."""
    c = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        c.request("POST", path, body=body, headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        if conn is None:
            c.close()


def _get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


class _Front:
    """``serve_http`` of one package on an ephemeral port, in a thread."""

    def __init__(self, module, service, **kw):
        self.server = module.serve_http(service, host="127.0.0.1", port=0, **kw)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        if self.server.batcher is not None:
            self.server.batcher.close()
        self.thread.join(timeout=TIMEOUT)
        assert not self.thread.is_alive()


@pytest.fixture()
def fronts(rankers):
    """Both packages' HTTP fronts over the same service configuration."""
    made = []

    def make(batch_wait_ms=None, **kw):
        js, ts = _services(rankers, **kw)
        pair = (_Front(j_serve, js, batch_wait_ms=batch_wait_ms),
                _Front(t_serve, ts, batch_wait_ms=batch_wait_ms))
        made.extend(pair)
        return pair

    yield make
    for f in made:
        f.close()


def test_http_search_and_health(fronts, saved):
    _, doc2idx = saved
    jf, tf = fronts(batch_size=4, default_k=3)
    assert _get(tf.port, "/healthz") == _get(jf.port, "/healthz")
    assert json.loads(_get(tf.port, "/healthz")[1]) == {"ok": True, "docs": len(DOCS)}
    for req in ({"queries": QUERIES, "k": 2}, {"query": QUERIES[0]}, {"queries": []}):
        body = json.dumps(req).encode()
        (js, jb), (ts, tb) = _post(jf.port, "/search", body), _post(tf.port, "/search", body)
        assert ts == js == 200
        same_docs(json.loads(tb)["results"], json.loads(jb)["results"], doc2idx)
    assert json.loads(_post(tf.port, "/search", json.dumps(
        {"query": QUERIES[0]}).encode())[1])["results"][0][0]["doc_id"] == "Saturn_V"


@pytest.mark.parametrize("payload", [
    b"not json", b"{}", b'{"queries": [1, 2]}', b'{"queries": ["x"], "k": 0}',
    # valid JSON of the wrong type: 400, never a dropped connection
    b"[1, 2]", b'"just a string"', b'{"queries": ["x"], "k": "three"}',
    b'{"queries": "moon"}', b'{"queries": ["x"], "k": true}',
    b'{"query": "x", "k_sents": "two"}',
])
def test_http_bad_requests_match(fronts, payload):
    jf, tf = fronts(batch_size=4, default_k=3)
    want, got = _post(jf.port, "/search", payload), _post(tf.port, "/search", payload)
    assert got == want and got[0] == 400


@pytest.mark.parametrize("method,path", [("GET", "/nope"), ("POST", "/nope"),
                                         ("GET", "/search")])
def test_http_unknown_paths_match(fronts, method, path):
    jf, tf = fronts(batch_size=4, default_k=3)
    call = (lambda p: _get(p, path)) if method == "GET" else (
        lambda p: _post(p, path, b"{}"))
    assert call(tf.port) == call(jf.port)
    assert call(tf.port)[0] == 404


def test_http_body_size_limit(fronts):
    jf, tf = fronts(batch_size=4, default_k=3)
    big = b"x" * (9 << 20)
    want, got = _post(jf.port, "/search", big), _post(tf.port, "/search", big)
    assert got == want and got[0] == 413
    assert t_serve.MAX_BODY_BYTES == j_serve.MAX_BODY_BYTES


def test_http_keep_alive_serves_a_session(fronts, saved):
    _, doc2idx = saved
    jf, tf = fronts(batch_size=4, default_k=3)
    for f in (jf, tf):
        conn = http.client.HTTPConnection("127.0.0.1", f.port, timeout=TIMEOUT)
        try:
            for i in range(5):
                status, body = _post(f.port, "/search", json.dumps(
                    {"query": QUERIES[i % 3]}).encode(), conn=conn)
                assert status == 200 and json.loads(body)["results"][0]
        finally:
            conn.close()
        assert json.loads(_get(f.port, "/metrics")[1])["requests"] == 5


def test_two_stage_over_http_and_stdin(fronts):
    jf, tf = fronts(batch_size=4, default_k=3, default_k_sents=2, two_stage=True)
    body = json.dumps({"queries": QUERIES[:1], "k_sents": 2}).encode()
    (js, jb), (ts, tb) = _post(jf.port, "/search", body), _post(tf.port, "/search", body)
    assert ts == js == 200
    got = json.loads(tb)["results"]
    same_sentences(got, json.loads(jb)["results"])
    assert got[0][0]["doc_id"] == "Saturn_V" and "sentence" in got[0][0]

    line = json.dumps({"query": QUERIES[0], "sentences": True}) + "\n"
    replies = []
    for module, svc in ((j_serve, jf.server.RequestHandlerClass.service),
                        (t_serve, tf.server.RequestHandlerClass.service)):
        out = io.StringIO()
        module.serve_stdin(svc, io.StringIO(line), out)
        replies.append(json.loads(out.getvalue())["results"])
    same_sentences(replies[1], replies[0])


def test_sentence_search_unconfigured_is_the_same_request_error(rankers):
    js, ts = _services(rankers, batch_size=2, default_k=2)
    line = json.dumps({"query": "x", "sentences": True}) + "\n"
    outs = []
    for module, svc in ((j_serve, js), (t_serve, ts)):
        out = io.StringIO()
        module.serve_stdin(svc, io.StringIO(line), out)
        outs.append(out.getvalue())
    assert outs[1] == outs[0] and "error" in json.loads(outs[1])


def _run_clients(target, args_list):
    threads = [threading.Thread(target=target, args=a) for a in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a client hung"


def test_batcher_coalesces_concurrent_requests(rankers, saved):
    """Eight concurrent one-query clients share device batches; each reply
    equals the reference service's direct answer."""
    _, doc2idx = saved
    js, ts = _services(rankers, batch_size=8, default_k=3)
    ts.search(["warmup"])
    base = ts.metrics.device_batches
    batcher = t_serve.BatchingService(ts, max_wait_ms=100.0)
    queries = [f"{q} variant {i}" for i, q in enumerate(QUERIES * 3)][:8]
    results = [None] * len(queries)
    start = threading.Barrier(len(queries), timeout=TIMEOUT)

    def client(i):
        start.wait()
        results[i] = batcher.search([queries[i]])

    try:
        _run_clients(client, [(i,) for i in range(len(queries))])
    finally:
        batcher.close()
    for i, q in enumerate(queries):
        assert results[i] is not None, f"client {i} never completed"
        same_docs(results[i], js.search([q]), doc2idx)
    used = ts.metrics.device_batches - base
    assert used < len(queries), f"no coalescing happened ({used} dispatches)"


def test_batcher_coalesces_under_sustained_load(rankers, saved):
    _, doc2idx = saved
    n_clients, reqs_each = 6, 10
    js, ts = _services(rankers, batch_size=8, default_k=3)
    ts.search(["warmup"])
    base = ts.metrics.device_batches
    batcher = t_serve.BatchingService(ts, max_wait_ms=50.0)
    results = [[None] * reqs_each for _ in range(n_clients)]
    errors = []
    start = threading.Barrier(n_clients, timeout=TIMEOUT)

    def client(i):
        try:
            start.wait()
            for r in range(reqs_each):
                q = QUERIES[(i + r) % len(QUERIES)] + f" v{i}"
                results[i][r] = (q, batcher.search([q]))
        except BaseException as e:  # noqa: BLE001 - failed below
            errors.append(e)

    try:
        _run_clients(client, [(i,) for i in range(n_clients)])
    finally:
        batcher.close()
    assert not errors, errors
    for per_client in results:
        for got in per_client:
            assert got is not None, "a request never completed"
            same_docs(got[1], js.search([got[0]]), doc2idx)
    used = ts.metrics.device_batches - base
    assert used <= n_clients * reqs_each // 2, f"{used} dispatches"


def test_batcher_submit_async(rankers, saved):
    """``submit`` delivers ``search``'s results through the callback, runs
    oversized requests inline and raises validation errors in the caller,
    with the reference's messages."""
    _, doc2idx = saved
    js, ts = _services(rankers, batch_size=4, default_k=3)
    batcher = t_serve.BatchingService(ts, max_wait_ms=2.0)
    j_batcher = j_serve.BatchingService(js, max_wait_ms=2.0)
    try:
        done, got = threading.Event(), {}

        def cb(result, error):
            got["r"], got["e"] = result, error
            done.set()

        batcher.submit(QUERIES, None, cb)
        assert done.wait(TIMEOUT), "callback never fired"
        assert got["e"] is None
        same_docs(got["r"], js.search(QUERIES), doc2idx)

        big = (QUERIES * 2)[:5]
        inline = {}
        batcher.submit(big, 2, lambda r, e: inline.update(r=r, e=e))
        assert inline["e"] is None  # fired before submit returned
        same_docs(inline["r"], js.search(big, k=2), doc2idx)

        for bad in ((QUERIES[:1], 0), ("moon", None), (QUERIES[:1], True)):
            with pytest.raises(ValueError) as want:
                j_batcher.submit(*bad, lambda r, e: None)
            with pytest.raises(ValueError) as have:
                batcher.submit(*bad, lambda r, e: None)
            assert str(have.value) == str(want.value)
    finally:
        batcher.close()
        j_batcher.close()


def test_batcher_submit_coalesces_without_blocking_callers(rankers, saved):
    _, doc2idx = saved
    js, ts = _services(rankers, batch_size=8, default_k=3)
    ts.search(["warmup"])
    base = ts.metrics.device_batches
    batcher = t_serve.BatchingService(ts, max_wait_ms=50.0)
    n = 12
    done = [threading.Event() for _ in range(n)]
    out = [None] * n
    try:
        for i in range(n):
            q = QUERIES[i % len(QUERIES)] + f" v{i}"

            def cb(result, error, i=i, q=q):
                out[i] = (q, result, error)
                done[i].set()

            batcher.submit([q], None, cb)
        for i in range(n):
            assert done[i].wait(TIMEOUT), f"submit {i} never completed"
            q, result, error = out[i]
            assert error is None
            same_docs(result, js.search([q]), doc2idx)
    finally:
        batcher.close()
    assert ts.metrics.device_batches - base <= n // 2


def test_batcher_sentence_requests_coalesce(rankers):
    """Concurrent two-stage requests with their own k and k_sents share one
    stage-1 batch and one stage-2 pass; each reply equals the reference
    service's direct answer for that request."""
    js, ts = _services(rankers, batch_size=8, default_k=3, default_k_sents=2,
                       two_stage=True)
    ts.warmup()
    base = ts.metrics.device_batches
    batcher = t_serve.BatchingService(ts, max_wait_ms=100.0)
    params = [(QUERIES[0], 3, 2), (QUERIES[1], 2, 1), (QUERIES[2], 1, 2),
              (QUERIES[0], 2, None)]
    results = [None] * len(params)
    start = threading.Barrier(len(params), timeout=TIMEOUT)

    def client(i):
        q, k, ks = params[i]
        start.wait()
        results[i] = batcher.search_sentences([q], k=k, k_sents=ks)

    try:
        _run_clients(client, [(i,) for i in range(len(params))])
    finally:
        batcher.close()
    used = ts.metrics.device_batches - base
    for i, (q, k, ks) in enumerate(params):
        assert results[i] is not None, f"client {i} never completed"
        same_sentences(results[i], js.search_sentences([q], k=k, k_sents=ks))
        assert results[i] == ts.search_sentences([q], k=k, k_sents=ks)
    assert used < len(params), f"no sentence coalescing ({used} dispatches)"


@pytest.mark.parametrize("case", ["no stage", "bad k"])
def test_batcher_sentence_errors_match(rankers, case):
    kw = dict(batch_size=4, default_k=3, two_stage=case == "bad k")
    batchers = [mod.BatchingService(svc, max_wait_ms=2.0)
                for mod, svc in zip((j_serve, t_serve), _services(rankers, **kw))]
    try:
        msgs = []
        for b in batchers:
            with pytest.raises(ValueError) as e:
                if case == "no stage":
                    b.search_sentences([QUERIES[0]])
                else:
                    b.submit_sentences([QUERIES[0]], 0, 2, lambda r, e: None)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]
    finally:
        for b in batchers:
            b.close()


def test_http_sentence_requests_ride_the_batcher(fronts):
    jf, tf = fronts(batch_wait_ms=2.0, batch_size=4, default_k=3, default_k_sents=2,
                    two_stage=True)
    body = json.dumps({"queries": QUERIES[:1], "k_sents": 2}).encode()
    (js, jb), (ts, tb) = _post(jf.port, "/search", body), _post(tf.port, "/search", body)
    assert ts == js == 200
    same_sentences(json.loads(tb)["results"], json.loads(jb)["results"])
    svc = tf.server.RequestHandlerClass.service
    assert json.loads(tb)["results"] == json.loads(json.dumps(
        svc.search_sentences(QUERIES[:1], k_sents=2)))


@pytest.mark.parametrize("k", [1, 2, 5])
def test_batcher_respects_per_request_k(rankers, saved, k):
    _, doc2idx = saved
    js, ts = _services(rankers, batch_size=4, default_k=3, k_max=5)
    batcher = t_serve.BatchingService(ts, max_wait_ms=20.0)
    try:
        same_docs(batcher.search(QUERIES[:1], k=k), js.search(QUERIES[:1], k=k), doc2idx)
    finally:
        batcher.close()


def test_batcher_large_request_passes_through(rankers, saved):
    _, doc2idx = saved
    js, ts = _services(rankers, batch_size=2, default_k=2)
    batcher = t_serve.BatchingService(ts, max_wait_ms=20.0)
    try:
        before = ts.metrics.device_batches
        queries = QUERIES * 2  # 6 queries > batch_size 2: three batches inline
        same_docs(batcher.search(queries), js.search(queries), doc2idx)
        assert ts.metrics.device_batches - before == 3
    finally:
        batcher.close()


def test_batcher_propagates_engine_errors(rankers):
    js, ts = _services(rankers, batch_size=4, default_k=3)

    def boom(queries, k):
        raise RuntimeError("engine fell over")

    ts._ranked = boom
    batcher = t_serve.BatchingService(ts, max_wait_ms=5.0)
    try:
        with pytest.raises(RuntimeError, match="engine fell over"):
            batcher.search(QUERIES[:1])
        seen = {}
        fired = threading.Event()
        batcher.submit(QUERIES[:1], None, lambda r, e: (seen.update(r=r, e=e),
                                                         fired.set()))
        assert fired.wait(TIMEOUT) and seen["r"] is None
        assert isinstance(seen["e"], RuntimeError)

        def bad_callback(result, error):
            raise KeyError("a callback that raises")

        batcher.submit(QUERIES[:1], None, bad_callback)
        with pytest.raises(RuntimeError, match="engine fell over"):
            batcher.search(QUERIES[:1])  # the dispatcher survived the callback
        with pytest.raises(ValueError):
            batcher.search("moon")
    finally:
        batcher.close()


def test_batcher_rejects_after_close_like_the_reference(rankers):
    js, ts = _services(rankers, batch_size=4, default_k=3)
    msgs = []
    for module, svc in ((j_serve, js), (t_serve, ts)):
        batcher = module.BatchingService(svc, max_wait_ms=5.0)
        batcher.close()
        with pytest.raises(RuntimeError) as e:
            batcher.search(QUERIES[:1])
        with pytest.raises(ValueError) as neg:
            module.BatchingService(svc, max_wait_ms=-1.0)
        msgs.append((str(e.value), str(neg.value)))
    assert msgs[1] == msgs[0]


def test_http_metrics_and_batched_transport(fronts, saved):
    _, doc2idx = saved
    jf, tf = fronts(batch_wait_ms=10.0, batch_size=4, default_k=3)
    snaps = []
    for f in (jf, tf):
        status, body = _post(f.port, "/search",
                             json.dumps({"queries": QUERIES, "k": 2}).encode())
        assert status == 200
        results = json.loads(body)["results"]
        assert _post(f.port, "/search", b'{"queries": 1}')[0] == 400
        snaps.append((results, json.loads(_get(f.port, "/metrics")[1])))
    same_docs(snaps[1][0], snaps[0][0], doc2idx)
    (_, jm), (_, tm) = snaps
    for key in ("requests", "queries", "errors", "device_batches"):
        assert tm[key] == jm[key], key
    assert (tm["requests"], tm["queries"], tm["errors"]) == (1, len(QUERIES), 1)
    assert tm["latency_p95_ms"] >= tm["latency_p50_ms"]


@pytest.fixture(scope="module")
def verdict_services(rankers, tmp_path_factory):
    """Retrieval + sentence + verdict services with the same classifier
    weights (the JAX package's, carried across; the port's loaded through
    its checkpoint)."""
    tok = JWordPiece.train(list(DOCS.values()), vocab_size=256)
    enc = dict(vocab_size=tok.vocab_size, hidden=16, layers=1, heads=2,
               intermediate=32, max_positions=48)
    j_cfg = j_model.VerdictConfig(encoder=JTransformerConfig(**enc), max_length=48)
    t_cfg = t_model.VerdictConfig(encoder=TransformerConfig(**enc), max_length=48)
    j_params = j_model.init_verdict_params(jax.random.PRNGKey(0), j_cfg)
    d = tmp_path_factory.mktemp("verdict_ckpt")
    tok.save_vocab(str(d / "vocab.txt"))
    t_infer.save_verdict_checkpoint(
        str(d), t_cfg,
        convert.verdict_params_from_numpy(jax.tree.map(np.asarray, j_params), device="cpu"),
        WordPieceTokenizer.from_vocab_file(str(d / "vocab.txt")))
    js, ts = _services(rankers, batch_size=4, default_k=3, default_k_sents=2,
                       two_stage=True)
    js.verdict_classifier = j_infer.VerdictClassifier(j_cfg, j_params, tok, batch_size=4)
    ts.verdict_classifier = t_infer.VerdictClassifier.from_checkpoint(
        str(d), batch_size=4, device="cpu")
    return js, ts


def same_verdicts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["label"], g["label_id"]) == (w["label"], w["label_id"])
        assert abs(g["confidence"] - w["confidence"]) <= 1e-5
        same_sentences([g["evidence"]], [w["evidence"]])


def test_verdict_over_http_and_stdin(verdict_services):
    js, ts = verdict_services
    jf, tf = _Front(j_serve, js), _Front(t_serve, ts)
    try:
        body = json.dumps({"claims": QUERIES[:2]}).encode()
        (jst, jb), (tst, tb) = _post(jf.port, "/verdict", body), _post(tf.port, "/verdict", body)
        assert tst == jst == 200
        got = json.loads(tb)["results"]
        same_verdicts(got, json.loads(jb)["results"])
        assert got[0]["label"] in ("SUPPORTS", "REFUTES") and got[0]["evidence"]
        # /verdict without claims is a 400, not a queries-shaped reply
        bad = json.dumps({"queries": ["x"]}).encode()
        assert _post(tf.port, "/verdict", bad) == _post(jf.port, "/verdict", bad)
        assert _post(tf.port, "/verdict", bad)[0] == 400
    finally:
        jf.close()
        tf.close()
    replies = []
    for module, svc in ((j_serve, js), (t_serve, ts)):
        out = io.StringIO()
        module.serve_stdin(svc, io.StringIO(json.dumps({"claim": QUERIES[0]}) + "\n"), out)
        replies.append(json.loads(out.getvalue())["results"])
    same_verdicts(replies[1], replies[0])


def test_verdict_requests_never_ride_the_batcher(verdict_services):
    _, ts = verdict_services
    batcher = t_serve.BatchingService(ts, max_wait_ms=5.0)
    queued = []
    batcher._enqueue = lambda queue, pend: queued.append(pend)
    try:
        got = t_serve._handle(ts, {"claims": QUERIES[:1]}, batcher=batcher)
        assert got["results"] == ts.verify_claims(QUERIES[:1])
        with pytest.raises(ValueError) as have:
            t_serve._handle(ts, {"queries": ["x"]}, batcher=batcher, expect="claims")
        with pytest.raises(ValueError) as want:
            j_serve._handle(verdict_services[0], {"queries": ["x"]}, expect="claims")
        assert str(have.value) == str(want.value)
        assert queued == []
    finally:
        batcher.close()


def test_service_over_chunked_ranker(saved, rankers, tmp_path):
    """``make_service(chunk_docs=...)`` serves the chunked engine: its
    replies equal the reference's chunked service and the unchunked ranker,
    and the per-chunk split artifacts persist for the next boot."""
    path, doc2idx = saved
    kw = dict(batch_size=4, default_k=3, chunk_docs=3)
    js = j_serve.make_service(path, split_path=str(tmp_path / "j_splits"), **kw)
    ts = t_serve.make_service(path, split_path=str(tmp_path / "splits"), device="cpu", **kw)
    assert ts.num_docs == js.num_docs == len(DOCS)
    assert len(ts.ranker.chunks) == 2
    ts.warmup()
    got = ts.search(QUERIES, k=3)
    same_docs(got, js.search(QUERIES, k=3), doc2idx)
    direct = rankers[1].closest_docs_batch(list(QUERIES), k=3)
    for g, (ids, scores) in zip(got, direct):
        assert [r["doc_id"] for r in g] == list(ids)
        np.testing.assert_allclose([r["score"] for r in g], scores, rtol=1e-5, atol=1e-6)
    assert sorted(p.name for p in (tmp_path / "splits").iterdir()) == sorted(
        p.name for p in (tmp_path / "j_splits").iterdir())
    again = t_serve.make_service(path, split_path=str(tmp_path / "splits"), device="cpu",
                                 **kw)  # the second boot loads the artifacts
    assert again.search(QUERIES, k=3) == got
