"""Serving endpoint for the ported retrieval engines.

Counterpart of ``ircl_tpu/serve.py``, ported as far as the three stages
over the stdin transport:

- **Pinned batch shapes.** ``RetrievalService`` pads every request up to
  ``batch_size`` with empty queries (zero terms, zero scores), splits larger
  requests into ``batch_size`` chunks and always computes at a fixed
  ``k_max``, slicing the requested ``k`` on the host, so every device batch
  has the same shapes.
- **One request parser.** ``parse_request`` validates every request, so a
  malformed line (wrong JSON type, bare string queries, non-int k) gets an
  error reply instead of killing the loop.
- **Bulk stdin.** ``serve_stdin`` drains the lines already buffered and
  scores the plain doc searches among them together.
- **Two-stage sentence search.** With ``doc_sentences`` and a
  ``sentence_scorer`` (``pipeline/dense_scorer.py``), ``search_sentences``
  re-ranks every sentence of the top docs; a scorer with ``score_keys``
  (the precomputed table) is scored by key, without re-embedding.
- **Claim verification.** With a ``verdict_classifier``
  (``verdict/infer.py``), ``verify_claims`` retrieves each claim's evidence
  (sentences when stage 2 is set, else doc ids) and classifies the claim
  against it; a service without the stage answers claim requests with an
  error.

Not ported yet (ROADMAP.md queue 1 item 7): serving through the chunked
engine (``chunk_docs``; ``index/chunked.py`` has the ranker), ``BatchingService`` and both HTTP fronts; ``chunk_docs``
raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import select
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ircl_tpu_torch.index.build import CountIndex
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.pipeline.retrieve import gather_candidates

_NO_SENTENCES = (
    "sentence search unavailable: service was built without a "
    "sentence_scorer/doc_sentences stage"
)
_NO_VERDICT = (
    "claim verification unavailable: service was built without "
    "a verdict_classifier (cli serve --verdict-ckpt)"
)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1 item 7)"
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
    """Load a saved index (the tf-idf npz that ``CountIndex.save`` or the
    reference's ``cli build-index`` writes) into a serving-configured ranker
    on ``device``: shapes pinned (``fixed_max_terms``, ``fixed_union_cap``,
    ``union_round``, service-level ``k_max``), df-split optionally preloaded
    (``index/split.py::save_split``) to skip the cold-start rebuild. Pass
    ``doc_sentences`` + ``sentence_scorer`` to enable ``search_sentences``,
    and a ``verdict_classifier`` (``verdict/infer.py::VerdictClassifier``)
    to enable ``verify_claims``."""
    if chunk_docs:
        raise _not_ported("the chunked engine (chunk_docs)")
    index = CountIndex.load(index_path)
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


def _handle(service: RetrievalService, req) -> dict:
    """Execute one decoded request: a reply payload, or ValueError on a
    malformed request. A "claims"/"claim" key selects claim verification."""
    t0 = time.monotonic()
    try:
        if isinstance(req, dict) and ("claims" in req or "claim" in req):
            queries, k, k_sents = parse_request(req, key="claims")
            payload = {
                "results": service.verify_claims(queries, k=k, k_sents=k_sents)
            }
        else:
            queries, k, k_sents = parse_request(req)
            if req.get("sentences") or k_sents is not None:
                payload = {
                    "results": service.search_sentences(queries, k=k, k_sents=k_sents)
                }
            else:
                payload = {"results": service.search(queries, k=k)}
    except BaseException:
        service.metrics.record_error()
        raise
    service.metrics.record_request(len(queries), time.monotonic() - t0)
    return payload


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
