"""The port's native (epoll C++) HTTP front against ``ircl_tpu.serve_native``
and against the port's own ``serve_http``.

Mirrors ``tests/test_serve_native.py``: byte parity with the stdlib front,
the error paths, keep-alive, the C++ parser under adversarial bytes and
concurrent clients. Both packages' fronts load the one shared library
(``native/src/ircl_http.cpp``); the port builds it through its own
``utils/native_build.py``. Reply bodies must be equal byte for byte between
the port's two fronts and between the two packages' native fronts; doc
results hold to the unbatched service (ids equal, scores rtol 1e-6). The
413 reply is the C++ side's own (``{"error": "body too large"}``), whose
body differs from ``serve_http``'s in both packages: there the status codes
must agree. Every call and join has a timeout.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu import serve as j_serve
from ircl_tpu import serve_native as j_native
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.index.build import build_count_index
from ircl_tpu.index.ranker import TfidfRanker as JRanker
from ircl_tpu.index.tfidf import tfidf_transform
from ircl_tpu_torch import serve as t_serve
from ircl_tpu_torch import serve_native as t_native
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.utils import native_build

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


@pytest.fixture(scope="module")
def native():
    """The library, loaded by both packages. A loader that found a library
    half written by a concurrent build (the reference's in-place build,
    ROADMAP.md queue 3) remembers the failure: build once more, atomically,
    and load again."""
    for mod in (t_native, j_native):
        if not mod.native_available():
            assert native_build.build_native(force=True, lib="http")
            mod._LIB_TRIED = False
            assert mod.native_available()
    return t_native, j_native


@pytest.fixture(scope="module")
def rankers():
    index = tfidf_transform(
        build_count_index(MemoryDocStore(DOCS), ngram=2, hash_size=1 << 18)
    )
    return JRanker(index), TfidfRanker(index, "cpu")


def _post(port, path, body: bytes, conn=None):
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


def _direct(ranker, queries, k):
    return ranker.closest_docs_batch(list(queries), k=k)


@pytest.fixture()
def native_server(native, rankers):
    svc = t_serve.RetrievalService(rankers[1], batch_size=4, default_k=3)
    server = t_native.serve_native_http(svc, port=0)
    yield server, svc
    server.close()


def test_health_metrics_search(native_server, rankers):
    server, _ = native_server
    status, body = _get(server.port, "/healthz")
    assert status == 200 and json.loads(body) == {"ok": True, "docs": len(DOCS)}
    status, body = _post(server.port, "/search",
                         json.dumps({"queries": QUERIES, "k": 2}).encode())
    assert status == 200
    for got, (ids, scores) in zip(json.loads(body)["results"],
                                  _direct(rankers[1], QUERIES, 2)):
        assert [g["doc_id"] for g in got] == ids
        np.testing.assert_allclose([g["score"] for g in got], scores, rtol=1e-6)
    assert json.loads(_get(server.port, "/metrics")[1])["requests"] >= 1


_PARITY_REQUESTS = [
    ("POST", "/search", {"queries": QUERIES, "k": 2}),
    ("POST", "/search", {"query": QUERIES[0]}),
    ("POST", "/search", {"queries": []}),
    ("POST", "/search", {"k": 3}),  # no queries: 400 from the shared parser
    ("POST", "/search", b"{not json"),
    ("POST", "/search", [1, 2]),
    ("POST", "/search", {"queries": ["x"], "k": True}),
    ("POST", "/search", {"query": "x", "sentences": True}),  # no sentence stage
    ("POST", "/verdict", {"claims": ["x"]}),  # no verdict stage
    ("POST", "/nope", {}),
    ("GET", "/nope", None),
    ("GET", "/healthz", None),
]


@pytest.mark.parametrize("batch_wait_ms", [None, 2.0])
def test_byte_parity_with_stdlib_front_and_reference(native, rankers, batch_wait_ms):
    """The same request through the port's stdlib front, the port's native
    front and the reference's native front: equal status and body bytes."""
    fronts = []
    svcs = [t_serve.RetrievalService(rankers[1], batch_size=4, default_k=3)
            for _ in range(2)] + [j_serve.RetrievalService(rankers[0], batch_size=4,
                                                           default_k=3)]
    stdlib = t_serve.serve_http(svcs[0], port=0, batch_wait_ms=batch_wait_ms)
    th = threading.Thread(target=stdlib.serve_forever, daemon=True)
    th.start()
    try:
        fronts = [t_native.serve_native_http(svcs[1], port=0, batch_wait_ms=batch_wait_ms),
                  j_native.serve_native_http(svcs[2], port=0, batch_wait_ms=batch_wait_ms)]
        ports = [stdlib.server_address[1]] + [f.port for f in fronts]
        for method, path, req in _PARITY_REQUESTS:
            body = req if isinstance(req, bytes) else json.dumps(req).encode()
            got = [_get(p, path) if method == "GET" else _post(p, path, body)
                   for p in ports]
            assert got[0] == got[1] == got[2], (method, path, req, got)
        big = b"x" * (9 << 20)
        codes = []
        for p in ports:
            try:
                codes.append(_post(p, "/search", big)[0])
            except (ConnectionError, http.client.HTTPException, OSError):
                codes.append("closed")  # a native front may close mid-upload
        assert codes[0] == 413 and set(codes[1:]) <= {413, "closed"}, codes
    finally:
        for f in fronts:
            f.close()
        stdlib.shutdown()
        stdlib.server_close()
        if stdlib.batcher is not None:
            stdlib.batcher.close()
        th.join(timeout=TIMEOUT)


def test_error_paths(native_server):
    server, svc = native_server
    status, body = _post(server.port, "/search", b"{not json")
    assert status == 400 and "error" in json.loads(body)
    try:
        status, body = _post(server.port, "/search", b"x" * (9 << 20))
        assert status == 413 and json.loads(body) == {"error": "body too large"}
    except (ConnectionError, http.client.HTTPException, OSError):
        pass  # the server may close mid-upload after replying
    # undecodable JSON is answered before ``_handle``, as in the reference,
    # and the 413 never reaches Python: neither counts as a served request
    assert svc.metrics.snapshot()["errors"] == svc.metrics.snapshot()["requests"] == 0


def test_keep_alive_reuses_connection(native_server):
    server, svc = native_server
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT)
    try:
        for i in range(5):
            status, body = _post(server.port, "/search", json.dumps(
                {"query": QUERIES[i % len(QUERIES)]}).encode(), conn=conn)
            assert status == 200 and json.loads(body)["results"]
    finally:
        conn.close()
    assert svc.metrics.snapshot()["requests"] == 5


def _raw(port, data: bytes, chunks=1, expect_n=1):
    """Send ``data`` in ``chunks`` pieces; read until ``expect_n`` complete
    Content-Length framed responses (or the peer closes)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    try:
        step = max(1, len(data) // chunks)
        for lo in range(0, len(data), step):
            s.sendall(data[lo : lo + step])
            time.sleep(0.002)
        buf = b""
        while not _complete(buf, expect_n):
            got = s.recv(65536)
            if not got:
                break
            buf += got
        return buf
    finally:
        s.close()


def _complete(buf: bytes, n: int) -> bool:
    seen = 0
    while b"\r\n\r\n" in buf:
        head, _, rest = buf.partition(b"\r\n\r\n")
        cl = 0
        for ln in head.split(b"\r\n"):
            if ln.lower().startswith(b"content-length:"):
                cl = int(ln.split(b":")[1])
        if len(rest) < cl:
            return False
        seen += 1
        buf = rest[cl:]
    return seen >= n


def test_protocol_robustness_raw_socket(native_server):
    """A request dribbled in pieces parses as one; two pipelined requests
    both answer in order; header names are case-insensitive;
    ``Connection: close`` is echoed; a garbage request line gets 400, and
    the server survives all of it."""
    server, _ = native_server
    body = json.dumps({"query": "rocket launched apollo to the moon"}).encode()
    req = (b"POST /search HTTP/1.1\r\nHost: x\r\ncOnTeNt-LeNgTh: "
           + str(len(body)).encode() + b"\r\n\r\n" + body)
    resp = _raw(server.port, req, chunks=len(req) // 3)
    assert b"HTTP/1.1 200" in resp and b"Saturn_V" in resp
    resp = _raw(server.port, req + req, chunks=1, expect_n=2)
    assert resp.count(b"HTTP/1.1 200") == 2
    req_close = (b"POST /search HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                 b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
    assert b"Connection: close" in _raw(server.port, req_close)
    assert b"HTTP/1.1 400" in _raw(server.port, b"NONSENSE\r\n\r\n")
    assert b"HTTP/1.1 200" in _raw(server.port, req)


@pytest.mark.parametrize("sentences", [False, True])
def test_concurrent_clients(native, rankers, sentences):
    """Eight keep-alive clients through two workers and the batcher: every
    reply equals the unbatched service's, and the metrics count them all."""
    from ircl_tpu_torch.pipeline.retrieve import host_sparse_scorer

    stage = dict(doc_sentences={d: t.split(" in ") for d, t in DOCS.items()},
                 sentence_scorer=host_sparse_scorer()) if sentences else {}
    svc = t_serve.RetrievalService(rankers[1], batch_size=4, default_k=3, **stage)
    server = t_native.serve_native_http(svc, port=0, batch_wait_ms=2.0, workers=2)
    errors, replies = [], []
    n, per = 8, 6

    def client(ci):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT)
            for i in range(per):
                q = QUERIES[(ci + i) % len(QUERIES)]
                status, body = _post(server.port, "/search", json.dumps(
                    {"query": q, "sentences": sentences}).encode(), conn=conn)
                assert status == 200, (status, body)
                replies.append((q, json.loads(body)["results"]))
            conn.close()
        except Exception as e:  # noqa: BLE001 - collected for the main thread
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert svc.metrics.snapshot()["requests"] == n * per
        direct = svc.search_sentences if sentences else svc.search
        for q, got in replies:
            assert got == json.loads(json.dumps(direct([q])))
    finally:
        server.close()


def test_unbuilt_library_raises_like_the_reference(rankers, monkeypatch):
    msgs = []
    for mod, ranker in ((j_native, rankers[0]), (t_native, rankers[1])):
        monkeypatch.setattr(mod, "_load", lambda: None)
        assert not mod.native_available()
        svc = (j_serve if mod is j_native else t_serve).RetrievalService(ranker)
        with pytest.raises(RuntimeError) as e:
            mod.serve_native_http(svc, port=0)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_close_drains_the_batcher_before_stopping(native, rankers):
    """Requests queued in the batcher when ``close`` runs are answered
    before the C++ server stops."""
    svc = t_serve.RetrievalService(rankers[1], batch_size=64, default_k=3)
    server = t_native.serve_native_http(svc, port=0, batch_wait_ms=300.0, workers=2)
    results = []

    def client():
        try:
            results.append(_post(server.port, "/search",
                                 json.dumps({"query": QUERIES[0]}).encode())[0])
        except (ConnectionError, http.client.HTTPException, OSError) as e:
            results.append(e)

    t = threading.Thread(target=client)
    t.start()
    deadline = time.monotonic() + TIMEOUT
    while not server.batcher._queue and time.monotonic() < deadline:
        time.sleep(0.005)
    assert server.batcher._queue, "the request never reached the batcher"
    server.close()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive() and results == [200]
