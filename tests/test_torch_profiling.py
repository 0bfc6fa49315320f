"""The port's ``utils/profiling.py``: ``trace`` writes a ``torch.profiler``
Chrome trace of the enclosed block; ``span`` and the collector's callback
mark the program's host work as ``ircl.*`` annotations in it, and cost one
check with no profiler recording. The ranker's host half and read-back and
``VerdictClassifier.classify`` emit their spans once a batch, and answer the
same under the profiler as without it."""

import collections
import gc
import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu_torch.corpus.store import MemoryDocStore
from ircl_tpu_torch.corpus.synthetic import generate
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.models.transformer import TransformerConfig
from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
from ircl_tpu_torch.utils import profiling as t_prof
from ircl_tpu_torch.verdict import infer, model

RANKER_SPANS = ("ranker.vectorize", "ranker.query_slab", "ranker.light_pools",
                "ranker.upload", "ranker.launch", "ranker.readback", "ranker.id_map")
VERDICT_SPANS = ("verdict.tokenize", "verdict.upload", "verdict.forward",
                 "verdict.readback")


def _traced(tmp_path, fn, collector=False):
    """``fn()``'s result and the ``ircl.*`` annotations of its trace (with
    the prefix taken off), in the order they started; the collector's passes
    only if ``collector`` (one may start at any allocation)."""
    logdir = tmp_path / "trace"
    with t_prof.trace(str(logdir)):
        out = fn()
    (name,) = os.listdir(logdir)
    with open(logdir / name) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("ircl.")
                    and (collector or not e["name"].startswith("ircl.python.gc"))),
                   key=lambda e: e["ts"])
    for e in spans:
        e["name"] = e["name"][len("ircl."):]
    return out, spans


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with t_prof.trace(str(logdir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(logdir)
    with open(logdir / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)


def test_trace_stops_when_the_block_raises(tmp_path):
    with pytest.raises(KeyError):
        with t_prof.trace(str(tmp_path)):
            raise KeyError("inside")
    assert len(os.listdir(tmp_path)) == 1
    with t_prof.trace(str(tmp_path)):  # a second trace can start
        torch.zeros(4).sum()
    assert len(os.listdir(tmp_path)) == 2


def test_spans_cost_nothing_without_a_profiler(monkeypatch):
    made = []
    monkeypatch.setattr(t_prof, "record_function", lambda name: made.append(name))
    hook = t_prof._CollectorSpans()
    monkeypatch.setattr(t_prof, "collector_spans", hook)
    a, b = t_prof.span("outer"), t_prof.span("inner")
    assert a is b is t_prof._OFF
    with a:
        gc.collect()
    hook("start", {"generation": 2})
    hook("stop", {"generation": 2})
    assert hook not in gc.callbacks  # a process that never profiles has none
    assert made == [] and hook.open is None


def test_the_collector_hook_is_installed_once_a_session_records(tmp_path, monkeypatch):
    hook = t_prof._CollectorSpans()
    monkeypatch.setattr(t_prof, "collector_spans", hook)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with t_prof.span("outer"):  # a caller's own session
                pass
        assert gc.callbacks.count(hook) == 1
        with t_prof.trace(str(tmp_path)):
            with t_prof.span("outer"):
                gc.collect()
        assert gc.callbacks.count(hook) == 1 and hook.open is None
    finally:
        while hook in gc.callbacks:
            gc.callbacks.remove(hook)


def test_nested_spans_land_in_the_trace(tmp_path):
    def work():
        with t_prof.span("outer"):
            torch.ones(8).sum()
            with t_prof.span("inner"):
                torch.ones(8).sum()

    _, spans = _traced(tmp_path, work)
    assert [s["name"] for s in spans] == ["outer", "inner"]
    assert _inside(spans[1], spans[0]) and spans[1]["dur"] < spans[0]["dur"]


def test_a_collection_inside_a_span_is_a_nested_span(tmp_path):
    def work():
        gc.disable()  # no pass but the one asked for
        try:
            with t_prof.span("outer"):
                gc.collect()
        finally:
            gc.enable()

    _, spans = _traced(tmp_path, work, collector=True)
    outer = [s for s in spans if s["name"] == "outer"]
    passes = [s for s in spans if s["name"] == "python.gc2"]
    assert len(outer) == 1 and len(passes) == 1
    assert _inside(passes[0], outer[0])
    assert t_prof.collector_spans.open is None


@pytest.fixture(scope="module")
def corpus():
    wiki = generate(num_docs=150, num_claims=40, seed=13)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=2**20))
    return index, [c.claim for c in wiki.claims]


@pytest.mark.parametrize("width_buckets", [1, 2])
def test_hybrid_ranker_spans_once_a_batch(tmp_path, corpus, width_buckets):
    index, claims = corpus
    ranker = TfidfRanker(index, "cpu", mode="hybrid", df_threshold=8,
                         width_buckets=width_buckets)
    batches = [claims[:24], claims[24:]]
    plain = [ranker.closest_docs_batch(b, k=5) for b in batches]
    traced, spans = _traced(tmp_path, lambda: [ranker.closest_docs_batch(b, k=5)
                                               for b in batches])
    assert collections.Counter(s["name"] for s in spans) == {
        n: len(batches) for n in RANKER_SPANS}
    # one batch after the other, each span in its place
    assert [s["name"] for s in spans] == list(RANKER_SPANS) * len(batches)
    for got, want in zip(traced, plain):
        assert [ids for ids, _ in got] == [ids for ids, _ in want]
        for (_, gs), (_, ws) in zip(got, want):
            np.testing.assert_array_equal(gs, ws)


def test_ell_read_back_and_hybrid_from_vectors_spans(tmp_path, corpus):
    index, claims = corpus
    ell = TfidfRanker(index, "cpu", mode="ell")
    hybrid = TfidfRanker(index, "cpu", mode="hybrid", df_threshold=8, width_buckets=2)
    qb, qw = hybrid._vectorize(claims)
    want = hybrid.hybrid_from_vectors(qb, qw, 5)

    def work():
        return ell.closest_docs_batch(claims, k=5), hybrid.hybrid_from_vectors(qb, qw, 5)

    (rows, got), spans = _traced(tmp_path, work)
    assert [s["name"] for s in spans] == [
        "ranker.vectorize", "ranker.readback", "ranker.id_map",  # ell
        "ranker.query_slab", "ranker.light_pools", "ranker.upload", "ranker.launch",
        "ranker.readback", "ranker.id_map"]
    assert len(rows) == len(claims)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_verdict_spans_once_a_device_batch(tmp_path, corpus):
    index, claims = corpus
    texts = [" ".join(index.doc_ids[:5])] + claims
    tok = WordPieceTokenizer.train(texts, vocab_size=200)
    cfg = model.VerdictConfig(
        encoder=TransformerConfig(vocab_size=tok.vocab_size, hidden=32, layers=1,
                                  heads=2, intermediate=64, max_positions=64),
        max_length=64)
    params = model.init_verdict_params(torch.Generator().manual_seed(3), cfg, "cpu")
    clf = infer.VerdictClassifier(cfg, params, tok, batch_size=4)
    pairs = claims[:10], claims[10:20]  # three device batches, the last of 2
    want = clf.classify(*pairs)
    got, spans = _traced(tmp_path, lambda: clf.classify(*pairs))
    assert [s["name"] for s in spans] == list(VERDICT_SPANS) * 3
    assert got == want
