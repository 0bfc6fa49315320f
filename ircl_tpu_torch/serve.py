"""Serving endpoint for the ported retrieval engines.

Counterpart of ``ircl_tpu/serve.py``:

- **Pinned batch shapes.** ``RetrievalService`` pads every request up to
  ``batch_size`` with empty queries (zero terms, zero scores), splits larger
  requests into ``batch_size`` chunks and always computes at a fixed
  ``k_max``, slicing the requested ``k`` on the host, so every device batch
  has the same shapes.
- **Cross-request micro-batching.** ``BatchingService`` coalesces concurrent
  doc-search and two-stage sentence requests into shared device batches
  (each waits at most ``max_wait_ms`` for co-riders). Its dispatcher
  threads, not the callers, launch the kernels; ``ServiceMetrics``
  (``GET /metrics``) reports request, query and device-dispatch counts and
  p50/p95 request latency.
- **Transports.** ``serve_http`` is a ``ThreadingHTTPServer`` speaking
  HTTP/1.1 with keep-alive (``POST /search``, ``POST /verdict``,
  ``GET /healthz``, ``GET /metrics``); ``serve_native.py`` puts the C++ epoll
  front over the same routing; ``serve_stdin`` is a JSONL loop that drains
  the lines already buffered and scores the plain doc searches among them
  together. All of them parse requests through one validator
  (``parse_request``), so a malformed request (wrong JSON type, bare string
  queries, non-int k) gets an error reply instead of killing a connection
  or the loop.
- **Two-stage sentence search.** With ``doc_sentences`` and a
  ``sentence_scorer`` (``pipeline/dense_scorer.py``), ``search_sentences``
  re-ranks every sentence of the top docs; a scorer with ``score_keys``
  (the precomputed table) is scored by key, without re-embedding.
- **Claim verification.** With a ``verdict_classifier``
  (``verdict/infer.py``), ``verify_claims`` retrieves each claim's evidence
  (sentences when stage 2 is set, else doc ids) and classifies the claim
  against it; a service without the stage answers claim requests with an
  error.
- **Chunked engine.** ``make_service(chunk_docs=...)`` serves through
  ``index/chunked.py::ChunkedHybridRanker`` for corpora past one staged pass.

Stage 1 runs under the service lock, so the doc and sentence dispatchers
and the HTTP handler threads never run two ranker batches at once.
"""

from __future__ import annotations

import json
import select
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ircl_tpu_torch.index.build import CountIndex
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.pipeline.retrieve import gather_candidates

# Requests above this are rejected with 413, so that no client can make the
# host buffer an arbitrarily large body.
MAX_BODY_BYTES = 8 << 20

_NO_SENTENCES = (
    "sentence search unavailable: service was built without a "
    "sentence_scorer/doc_sentences stage"
)
_NO_VERDICT = (
    "claim verification unavailable: service was built without "
    "a verdict_classifier (cli serve --verdict-ckpt)"
)


def parse_request(
    req, key: str = "queries"
) -> Tuple[List[str], Optional[int], Optional[int]]:
    """Validate a decoded request object into (texts, k, k_sents).

    ``key="queries"`` parses search requests; ``key="claims"`` the verdict
    shape (same contracts). Raises ValueError (never TypeError) on any
    malformed shape, so the error paths stay uniform.
    """
    singular = {"queries": "query", "claims": "claim"}[key]
    if not isinstance(req, dict):
        raise ValueError(f"request must be a JSON object, got {type(req).__name__}")
    if key in req:
        queries = req[key]
    elif singular in req:
        queries = [req[singular]]
    else:
        raise ValueError(
            f"request needs '{key}' (list of str) or '{singular}' (str)"
        )
    if not isinstance(queries, list) or not all(
        isinstance(q, str) for q in queries
    ):
        raise ValueError(f"{key} must be a list of strings")

    def _int_field(name):
        v = req.get(name)
        if v is None:
            return None
        # bool is an int subclass; reject it explicitly
        if isinstance(v, bool) or not isinstance(v, int):
            raise ValueError(f"{name} must be an integer, got {v!r}")
        if v <= 0:
            raise ValueError(f"{name} must be positive, got {v}")
        return v

    return queries, _int_field("k"), _int_field("k_sents")


class ServiceMetrics:
    """Thread-safe serving counters + a bounded request-latency window:
    request/query counts, device-dispatch count and p50/p95 request latency
    over the last ``window`` requests."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=window)
        self.requests = 0
        self.queries = 0
        self.device_batches = 0
        self.errors = 0

    def record_request(self, n_queries: int, latency_s: float) -> None:
        with self._lock:
            self.requests += 1
            self.queries += n_queries
            self._lat.append(latency_s)

    def record_dispatch(self) -> None:
        with self._lock:
            self.device_batches += 1

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            out = {
                "requests": self.requests,
                "queries": self.queries,
                "device_batches": self.device_batches,
                "errors": self.errors,
            }
        if lat:
            out["latency_p50_ms"] = round(1e3 * lat[len(lat) // 2], 3)
            out["latency_p95_ms"] = round(
                1e3 * lat[min(len(lat) - 1, int(0.95 * len(lat)))], 3
            )
        return out


def _ranker_num_docs(ranker) -> int:
    """Corpus size across ranker flavors: a ranker may expose ``num_docs``
    directly; ``TfidfRanker`` keeps it on its device index."""
    if hasattr(ranker, "num_docs"):
        return int(ranker.num_docs)
    return len(ranker.dev.doc_ids)


class RetrievalService:
    """Pinned-shape search facade over a ``TfidfRanker`` (or any ranker with
    the same ``closest_docs_batch`` contract).

    ``search`` accepts any number of queries and always dispatches device
    batches of exactly ``batch_size`` (padding the tail with empty queries,
    dropped from the output) at a fixed ``k_max`` (requested k sliced on
    the host).
    """

    def __init__(
        self,
        ranker: TfidfRanker,
        batch_size: int = 256,
        default_k: int = 5,
        k_max: Optional[int] = None,
        doc_sentences: Optional[Dict[str, List[str]]] = None,
        sentence_scorer=None,
        default_k_sents: int = 5,
        verdict_classifier=None,  # verdict.infer.VerdictClassifier
    ):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if default_k <= 0:
            raise ValueError(f"default_k must be positive, got {default_k}")
        self.ranker = ranker
        self.batch_size = batch_size
        self.default_k = default_k
        # Every device call computes top-k_max; the requested k is a host
        # slice, and k > k_max is clamped. Exact engine: the top-k prefix of
        # a top-k_max result is the top-k result.
        self.k_max = min(
            max(default_k, k_max if k_max is not None else 2 * default_k),
            max(1, _ranker_num_docs(ranker)),
        )
        self.doc_sentences = doc_sentences
        self.sentence_scorer = sentence_scorer
        self.default_k_sents = default_k_sents
        self.verdict_classifier = verdict_classifier
        self.metrics = ServiceMetrics()
        self._lock = threading.Lock()

    @property
    def num_docs(self) -> int:
        return _ranker_num_docs(self.ranker)

    @property
    def has_sentence_stage(self) -> bool:
        return self.sentence_scorer is not None and self.doc_sentences is not None

    @property
    def has_verdict_stage(self) -> bool:
        return self.verdict_classifier is not None

    def warmup(self) -> None:
        """Run one batch before traffic (kernel build, first allocations),
        and one call of each later stage that is set."""
        self.search(["warmup"])
        if self.has_sentence_stage:
            self.sentence_scorer(["warmup"], [["warmup sentence"]])
        if self.has_verdict_stage:
            self.verdict_classifier.warmup()

    def _validate(self, queries, k: Optional[int]) -> int:
        if isinstance(queries, str) or not all(
            isinstance(q, str) for q in queries
        ):
            # a bare string would iterate per character
            raise ValueError("queries must be a sequence of strings")
        k = self.default_k if k is None else k
        if isinstance(k, bool) or not isinstance(k, int):
            raise ValueError(f"k must be an integer, got {k!r}")
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        return min(k, self.k_max)

    def _ranked(self, queries: Sequence[str], k: int):
        """Pinned-shape stage 1: (doc_ids, scores) per query, top-k."""
        out = []
        with self._lock:
            for lo in range(0, len(queries), self.batch_size):
                chunk = list(queries[lo : lo + self.batch_size])
                n_real = len(chunk)
                chunk += [""] * (self.batch_size - n_real)
                self.metrics.record_dispatch()
                ranked = self.ranker.closest_docs_batch(chunk, k=self.k_max)
                out.extend(
                    (ids[:k], scores[:k]) for ids, scores in ranked[:n_real]
                )
        return out

    def search(
        self, queries: Sequence[str], k: Optional[int] = None
    ) -> List[List[dict]]:
        """Top-k ``{"doc_id", "score"}`` lists, one per query, score-desc."""
        k = self._validate(queries, k)
        return [
            [{"doc_id": d, "score": float(s)} for d, s in zip(ids, scores)]
            for ids, scores in self._ranked(queries, k)
        ]

    def search_sentences(
        self,
        queries: Sequence[str],
        k: Optional[int] = None,
        k_sents: Optional[int] = None,
    ) -> List[List[dict]]:
        """Two-stage search: sparse top-k docs, then the sentence scorer
        re-ranks every sentence of those docs. Per query, a score-desc list
        of ``{"doc_id", "sent_id", "sentence", "score"}``."""
        k = self._validate(queries, k)
        k_sents = self.default_k_sents if k_sents is None else k_sents
        n = len(queries)
        return self.search_sentences_multi(queries, [k] * n, [k_sents] * n)

    def search_sentences_multi(
        self,
        queries: Sequence[str],
        ks: Sequence[int],
        k_sents: Sequence[int],
    ) -> List[List[dict]]:
        """Per-query (k, k_sents) variant of ``search_sentences``: one shared
        stage-1 batch and one stage-2 scoring pass. Exact: the top-``ki``
        docs of a top-``max(ks)`` ranking are that query's own top-``ki``,
        and stage-2 scores are per query."""
        if not self.has_sentence_stage:
            raise ValueError(_NO_SENTENCES)
        if not queries:
            return []
        doc_ids = [
            ids[:ki]
            for (ids, _), ki in zip(self._ranked(queries, max(ks)), ks)
        ]
        cand_sents, cand_keys = gather_candidates(doc_ids, self.doc_sentences)
        if hasattr(self.sentence_scorer, "score_keys"):
            # precomputed-table scorer: candidates come from the same
            # doc_sentences its table indexes, so stage 2 is a row gather
            # and a dot, with no sentence re-embedded
            scores = self.sentence_scorer.score_keys(list(queries), cand_keys)
        else:
            scores = self.sentence_scorer(list(queries), cand_sents)
        out: List[List[dict]] = []
        for sents, keys, sc, ksent in zip(cand_sents, cand_keys, scores, k_sents):
            sc = np.asarray(sc)
            order = np.argsort(-sc)[:ksent]
            out.append(
                [
                    {
                        "doc_id": keys[j][0],
                        "sent_id": keys[j][1],
                        "sentence": sents[j],
                        "score": float(sc[j]),
                    }
                    for j in order
                ]
            )
        return out

    def verify_claims(
        self,
        claims: Sequence[str],
        k: Optional[int] = None,
        k_sents: Optional[int] = None,
    ) -> List[dict]:
        """End-to-end claim verification: retrieve evidence, classify.

        Evidence per claim is the two-stage sentence results when stage 2
        is configured (grouped by doc in score order: doc-id words + its
        selected sentences, as ``verdict/data.py::build_examples``
        assembles it), else the top-k doc-id words. Returns one
        ``{"label", "label_id", "confidence", "evidence"}`` per claim."""
        if not self.has_verdict_stage:
            raise ValueError(_NO_VERDICT)
        # _validate also covers the claims list (same str-sequence contract)
        self._validate(claims, k)
        if self.has_sentence_stage:
            per_claim = self.search_sentences(claims, k=k, k_sents=k_sents)
        else:
            per_claim = self.search(claims, k=k)
        evidence_texts = []
        for results in per_claim:
            by_doc: Dict[str, List[str]] = {}
            for r in results:  # score-desc; dict keeps first-seen doc order
                by_doc.setdefault(r["doc_id"], []).append(r.get("sentence", ""))
            parts: List[str] = []
            for doc_id, sents in by_doc.items():
                parts.extend(doc_id.split("_"))
                parts.extend(s for s in sents if s)
            evidence_texts.append(" ".join(parts))
        verdicts = self.verdict_classifier.classify(list(claims), evidence_texts)
        return [dict(v, evidence=results) for v, results in zip(verdicts, per_claim)]


class _Pending:
    """One in-flight request inside the micro-batcher. ``k_sents`` is None
    for doc-search requests and set for two-stage sentence requests."""

    __slots__ = (
        "queries", "k", "k_sents", "event", "result", "error", "callback"
    )

    def __init__(
        self, queries: List[str], k: int, k_sents: Optional[int] = None,
        callback=None,
    ):
        self.queries = queries
        self.k = k
        self.k_sents = k_sents
        self.event = threading.Event()
        self.result: Optional[List[List[dict]]] = None
        self.error: Optional[BaseException] = None
        # asynchronous completion (``submit``): called as
        # callback(result, error) on the dispatcher thread after the event
        self.callback = callback

    def finish(self, result, error) -> None:
        self.result, self.error = result, error
        self.event.set()
        if self.callback is not None:
            try:
                self.callback(result, error)
            except Exception:  # noqa: BLE001
                pass  # a callback must never kill the dispatcher


class BatchingService:
    """Cross-request micro-batcher over a ``RetrievalService``.

    The pinned-shape engine runs ``batch_size`` query slots a device batch
    however few are real (``RetrievalService._ranked`` pads), so N concurrent
    one-query clients would each pay a mostly empty batch. Here requests
    enqueue, and a dispatcher thread drains the queue into one device batch,
    at once when ``batch_size`` queries wait and else after at most
    ``max_wait_ms``, computes at the service's ``k_max`` and hands each
    request its slice. Two-stage sentence requests coalesce on a queue and
    dispatcher thread of their own (``search_sentences_multi``). The
    engines are exact, so a top-k slice of a shared top-``k_max`` batch is
    each request's own answer. The dispatcher threads launch the kernels,
    each on the service's device.
    """

    def __init__(self, service: RetrievalService, max_wait_ms: float = 5.0):
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self.service = service
        self.max_wait_s = max_wait_ms / 1e3
        self._cv = threading.Condition()
        self._queue: deque[_Pending] = deque()
        self._sent_queue: deque[_Pending] = deque()
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="ircl-batcher", daemon=True
        )
        self._thread.start()
        self._sent_thread: Optional[threading.Thread] = None
        if service.has_sentence_stage:
            self._sent_thread = threading.Thread(
                target=self._sent_loop, name="ircl-batcher-sent", daemon=True
            )
            self._sent_thread.start()

    # -- client side ------------------------------------------------------
    def search(
        self, queries: Sequence[str], k: Optional[int] = None
    ) -> List[List[dict]]:
        """``RetrievalService.search``'s contract; the device batch may be
        shared with concurrent callers."""
        k = self.service._validate(queries, k)
        if len(queries) >= self.service.batch_size:
            # fills device batches on its own: no point queueing
            return self.service.search(queries, k=k)
        pend = _Pending(list(queries), k)
        self._enqueue(self._queue, pend)
        pend.event.wait()
        if pend.error is not None:
            raise pend.error
        return pend.result

    def submit(
        self, queries: Sequence[str], k: Optional[int], callback
    ) -> None:
        """Asynchronous ``search``: enqueue and return at once;
        ``callback(result, error)`` fires on the dispatcher thread when the
        shared batch completes (exactly one of the two is not None). A
        fixed worker pool (the native front) drives the batcher this way at
        full coalescing, since a worker pays only the enqueue. Validation
        errors raise in the caller, as in ``search``."""
        k = self.service._validate(queries, k)
        if len(queries) >= self.service.batch_size:
            # fills device batches on its own: run inline, as ``search`` does
            try:
                result = self.service.search(queries, k=k)
            except BaseException as e:  # noqa: BLE001 - handed to callback
                callback(None, e)
                return
            callback(result, None)
            return
        self._enqueue(self._queue, _Pending(list(queries), k, callback=callback))

    def search_sentences(
        self,
        queries: Sequence[str],
        k: Optional[int] = None,
        k_sents: Optional[int] = None,
    ) -> List[List[dict]]:
        """``RetrievalService.search_sentences``' contract; the stage-1
        batch and the stage-2 pass may be shared with concurrent callers,
        each request keeping its own ``k`` and ``k_sents``."""
        pend = self._make_sent_pending(queries, k, k_sents)
        if pend.result is not None:
            return pend.result  # oversized: ran inline
        pend.event.wait()
        if pend.error is not None:
            raise pend.error
        return pend.result

    def submit_sentences(
        self,
        queries: Sequence[str],
        k: Optional[int],
        k_sents: Optional[int],
        callback,
    ) -> None:
        """Asynchronous ``search_sentences`` (see ``submit``); the callback
        fires on the sentence dispatcher thread."""
        self._make_sent_pending(queries, k, k_sents, callback=callback)

    def _make_sent_pending(
        self, queries, k, k_sents, callback=None
    ) -> _Pending:
        if not self.service.has_sentence_stage:
            raise ValueError(_NO_SENTENCES)
        k = self.service._validate(queries, k)
        if k_sents is None:
            k_sents = self.service.default_k_sents
        pend = _Pending(list(queries), k, k_sents=k_sents, callback=callback)
        if len(queries) >= self.service.batch_size:
            # fills device batches on its own: run inline
            try:
                pend.finish(
                    self.service.search_sentences(queries, k=k, k_sents=k_sents),
                    None,
                )
            except BaseException as e:  # noqa: BLE001 - handed to the waiter
                pend.finish(None, e)
            return pend
        self._enqueue(self._sent_queue, pend)
        return pend

    def _enqueue(self, queue: deque, pend: _Pending) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("BatchingService is closed")
            queue.append(pend)
            self._cv.notify_all()

    def close(self) -> None:
        """Stop the dispatchers after draining the queued requests."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=10)
        if self._sent_thread is not None:
            self._sent_thread.join(timeout=10)

    # -- dispatcher side ---------------------------------------------------
    def _take_batch(self, queue: deque) -> List[_Pending]:
        """Block until ``queue`` holds work, linger up to ``max_wait_s`` for
        co-riders, then pop whole requests up to ``batch_size`` slots."""
        cap = self.service.batch_size
        with self._cv:
            while not queue:
                if self._closed:
                    return []
                self._cv.wait()
            deadline = time.monotonic() + self.max_wait_s
            while sum(len(p.queries) for p in queue) < cap and not self._closed:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            batch: List[_Pending] = []
            slots = 0
            while queue:
                nxt = len(queue[0].queries)
                if batch and slots + nxt > cap:
                    break
                p = queue.popleft()
                batch.append(p)
                slots += nxt
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch(self._queue)
            if not batch:
                return  # closed and drained
            allq = [q for p in batch for q in p.queries]
            try:
                ranked = self.service._ranked(allq, self.service.k_max)
            except BaseException as e:  # noqa: BLE001 - to every waiter
                for p in batch:
                    p.finish(None, e)
                continue
            lo = 0
            for p in batch:
                rows = ranked[lo : lo + len(p.queries)]
                lo += len(p.queries)
                p.finish(
                    [
                        [
                            {"doc_id": d, "score": float(s)}
                            for d, s in zip(ids[: p.k], scores[: p.k])
                        ]
                        for ids, scores in rows
                    ],
                    None,
                )

    def _sent_loop(self) -> None:
        while True:
            batch = self._take_batch(self._sent_queue)
            if not batch:
                return  # closed and drained
            allq, ks, ksents = [], [], []
            for p in batch:
                allq.extend(p.queries)
                ks.extend([p.k] * len(p.queries))
                ksents.extend([p.k_sents] * len(p.queries))
            try:
                rows = self.service.search_sentences_multi(allq, ks, ksents)
            except BaseException as e:  # noqa: BLE001 - to every waiter
                for p in batch:
                    p.finish(None, e)
                continue
            lo = 0
            for p in batch:
                p.finish(rows[lo : lo + len(p.queries)], None)
                lo += len(p.queries)


def make_service(
    index_path: str,
    batch_size: int = 256,
    default_k: int = 5,
    max_terms: int = 24,
    union_cap: int = 4096,
    union_round: Optional[int] = 512,
    split_path: Optional[str] = None,
    mode: str = "auto",
    k_max: Optional[int] = None,
    doc_sentences: Optional[Dict[str, List[str]]] = None,
    sentence_scorer=None,
    default_k_sents: int = 5,
    verdict_classifier=None,
    chunk_docs: Optional[int] = None,
    *,
    device,
) -> RetrievalService:
    """Load a saved index (the tf-idf npz that ``CountIndex.save`` or
    ``cli build-index`` writes) into a serving-configured ranker on
    ``device``: shapes pinned (``fixed_max_terms``, ``fixed_union_cap``,
    ``union_round``, service-level ``k_max``), df-split optionally preloaded
    (``index/split.py::save_split``) to skip the cold-start rebuild. Pass
    ``doc_sentences`` + ``sentence_scorer`` to enable ``search_sentences``,
    and a ``verdict_classifier`` (``verdict/infer.py::VerdictClassifier``)
    to enable ``verify_claims``. ``chunk_docs`` switches to the chunked
    engine for corpora past one staged pass (``cli serve --chunk-docs``);
    ``split_path`` is then the directory of per-chunk split artifacts, built
    and saved on the first boot."""
    index = CountIndex.load(index_path)
    if chunk_docs:
        from ircl_tpu_torch.index.chunked import ChunkedHybridRanker

        ranker = ChunkedHybridRanker(
            index,
            device,
            chunk_docs=chunk_docs,
            split_cache_dir=split_path or None,
            fixed_max_terms=max_terms,
            fixed_union_cap=union_cap,
            union_round=union_round,
        )
    else:
        split = None
        if split_path:
            from ircl_tpu_torch.index.split import load_split

            split = load_split(split_path)
        ranker = TfidfRanker(
            index,
            device,
            mode=mode,
            fixed_max_terms=max_terms,
            fixed_union_cap=union_cap,
            union_round=union_round,
            split=split,
        )
    return RetrievalService(
        ranker,
        batch_size=batch_size,
        default_k=default_k,
        k_max=k_max,
        doc_sentences=doc_sentences,
        sentence_scorer=sentence_scorer,
        default_k_sents=default_k_sents,
        verdict_classifier=verdict_classifier,
    )


def _handle(service: RetrievalService, req, batcher=None, expect=None) -> dict:
    """Execute one decoded request for every transport: a reply payload, or
    ValueError on a malformed request. Doc-search and two-stage sentence
    requests ride the micro-batcher when one is set; claim requests never
    do (the classifier runs pinned batches of its own). ``expect="claims"``
    (the HTTP ``/verdict`` path) forces the claim shape; otherwise a
    "claims"/"claim" key selects it (the stdin transport)."""
    t0 = time.monotonic()
    try:
        if expect == "claims" or (
            expect is None
            and isinstance(req, dict)
            and ("claims" in req or "claim" in req)
        ):
            queries, k, k_sents = parse_request(req, key="claims")
            payload = {
                "results": service.verify_claims(queries, k=k, k_sents=k_sents)
            }
        else:
            queries, k, k_sents = parse_request(req)
            if req.get("sentences") or k_sents is not None:
                two_stage = (
                    batcher.search_sentences
                    if batcher is not None and service.has_sentence_stage
                    else service.search_sentences
                )
                payload = {"results": two_stage(queries, k=k, k_sents=k_sents)}
            elif batcher is not None:
                payload = {"results": batcher.search(queries, k=k)}
            else:
                payload = {"results": service.search(queries, k=k)}
    except BaseException:
        service.metrics.record_error()
        raise
    service.metrics.record_request(len(queries), time.monotonic() - t0)
    return payload


class _Handler(BaseHTTPRequestHandler):
    service: RetrievalService = None  # set by serve_http
    batcher: Optional[BatchingService] = None  # set by serve_http
    # HTTP/1.1: keep-alive a connection (every reply carries Content-Length,
    # which 1.1 requires), so one handler thread serves a whole session
    protocol_version = "HTTP/1.1"

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path == "/healthz":
            self._reply(200, {"ok": True, "docs": self.service.num_docs})
        elif self.path == "/metrics":
            self._reply(200, self.service.metrics.snapshot())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        if self.path not in ("/search", "/verdict"):
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._reply(400, {"error": "bad Content-Length"})
            return
        if n > MAX_BODY_BYTES:
            # drain (bounded) so the client can finish writing and read the
            # 413 instead of dying on a broken pipe mid-upload
            left = min(n, 4 * MAX_BODY_BYTES)
            while left > 0:
                got = self.rfile.read(min(left, 1 << 20))
                if not got:
                    break
                left -= len(got)
            self.close_connection = True
            self._reply(413, {"error": f"body too large ({n} > {MAX_BODY_BYTES})"})
            return
        try:
            req = json.loads(self.rfile.read(n) or b"{}")
            payload = _handle(
                self.service, req, batcher=self.batcher,
                expect="claims" if self.path == "/verdict" else None,
            )
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        self._reply(200, payload)

    def log_message(self, fmt, *args):  # quiet: metrics go to the caller
        pass


def serve_http(
    service: RetrievalService,
    host: str = "127.0.0.1",
    port: int = 8080,
    batch_wait_ms: Optional[float] = None,
) -> ThreadingHTTPServer:
    """Start the HTTP endpoint and return the bound server: call
    ``.serve_forever()`` (blocking) or drive it from a thread. With
    ``batch_wait_ms`` (not None), concurrent doc and sentence requests
    coalesce into shared device batches, each waiting at most that long for
    co-riders; the batcher is ``server.batcher`` (close it after
    ``shutdown``)."""
    batcher = (
        BatchingService(service, max_wait_ms=batch_wait_ms)
        if batch_wait_ms is not None
        else None
    )
    handler = type("Handler", (_Handler,), {"service": service, "batcher": batcher})
    server = ThreadingHTTPServer((host, port), handler)
    server.batcher = batcher
    return server


def _drain_lines(infile, cap: int) -> List[str]:
    """Block for one line, then greedily take lines that are ALREADY
    available, up to ``cap``. Real files/pipes consult ``select`` with a
    zero timeout so an interactive client still gets a reply per line;
    file-likes without a usable descriptor (StringIO, tests) drain
    freely — they never block."""
    first = infile.readline()
    if not first:
        return []
    lines = [first]
    try:
        infile.fileno()
        has_fd = True
    except (AttributeError, OSError, ValueError):
        has_fd = False
    while len(lines) < cap:
        if has_fd:
            try:
                ready, _, _ = select.select([infile], [], [], 0)
            except (OSError, ValueError):
                break
            if not ready:
                break
        line = infile.readline()
        if not line:
            break
        lines.append(line)
    return lines


_SKIP = object()  # blank input line: emit nothing


def serve_stdin(service: RetrievalService, infile, outfile) -> int:
    """JSONL loop: one request object per line (``{"queries": [...], "k": n}``
    or ``{"query": "..."}``; add ``"sentences": true`` / ``"k_sents": n`` for
    the two-stage reply; ``{"claims": [...]}`` / ``{"claim": "..."}`` for
    claim verification), one ``{"results": ...}`` reply line each;
    blank lines skipped, malformed lines get an ``{"error": ...}`` line and
    the loop continues. Returns the number of requests served.

    Plain doc-search lines that are already buffered are drained together
    and share device batches — grouped by requested ``k``, scored in one
    ``service.search`` call per group, replies in input order. The engines
    are exact, so each result is independent of its batch-mates. Sentence
    and claim lines and malformed lines keep their per-line handling inside
    the same drain."""
    served = 0
    cap = max(1, service.batch_size)
    while True:
        lines = _drain_lines(infile, cap)
        if not lines:
            return served
        replies: List[object] = [None] * len(lines)
        # (slot, queries) for combinable plain doc-searches, keyed by k
        groups: Dict[Optional[int], List[Tuple[int, List[str]]]] = {}
        for i, raw in enumerate(lines):
            line = raw.strip()
            if not line:
                replies[i] = _SKIP
                continue
            try:
                req = json.loads(line)
                combinable = (
                    isinstance(req, dict)
                    and "claims" not in req
                    and "claim" not in req
                    and not req.get("sentences")
                    and req.get("k_sents") is None
                )
                if combinable:
                    queries, k, _ = parse_request(req)
                    groups.setdefault(k, []).append((i, queries))
                else:
                    replies[i] = _handle(service, req)
                    served += 1
            except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
                replies[i] = {"error": str(e)}
        for k, members in groups.items():
            t0 = time.monotonic()
            try:
                flat = [q for _, qs in members for q in qs]
                ranked = service.search(flat, k=k)
            except (KeyError, ValueError, TypeError) as e:
                service.metrics.record_error()
                for i, _ in members:
                    replies[i] = {"error": str(e)}
                continue
            dt = time.monotonic() - t0
            lo = 0
            for i, qs in members:
                replies[i] = {"results": ranked[lo : lo + len(qs)]}
                lo += len(qs)
                service.metrics.record_request(len(qs), dt)
                served += 1
        for payload in replies:
            if payload is _SKIP:
                continue
            outfile.write(json.dumps(payload) + "\n")
        outfile.flush()
