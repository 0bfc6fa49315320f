"""Window driver of batched stage-1 retrieval: a closed loop, one batch ahead.

The offline evidence job: a pool of ``pool_batches`` x ``batch`` queries,
drawn from the seed, sent batch after batch in pool order (the pool over
again once it is spent) through the public halves of
``TfidfRanker.closest_docs_batch``: the ranker's query vectorizer
(``vectorize_queries`` with its own arguments; text queries only), then
``hybrid_host_inputs`` and ``hybrid_from_host_async`` (together
``hybrid_from_vectors_async``), then ``finalize_closest``, which reads the
top-k back and maps it to doc ids. While the card scores batch n the host
prepares batch n + 1.

Queries are ``claims`` over a generated text corpus (the program builds its
index from the text) or ``synthetic`` term vectors over generated postings
(the program assembles its index from them). The reference rebuilds the
index from the same text or postings and scores a sample of the window's
answers, drawn from the seed, in float64.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import Check, Request, log
from benchmark.reference import corpus as gen
from benchmark.reference import scale, sparse, text
from benchmark.rooflines import retrieve_batch


def _rng(run, stream: int) -> np.random.Generator:
    return np.random.default_rng([run.seed, stream])


class RetrieveCell:
    def __init__(self, run):
        import torch

        from ircl_tpu_torch.index.build import assemble_csr, build_count_index
        from ircl_tpu_torch.index.ranker import TfidfRanker
        from ircl_tpu_torch.index.tfidf import tfidf_transform

        cfg, mix = run.config, run.mix
        cc, rk = cfg["corpus"], cfg["ranker"]
        self.k, self.batch, self.pool = rk["k"], mix["batch"], mix["pool_batches"]
        self.hash_size = cc["hash_size"]
        n_queries = self.batch * self.pool
        t = time.perf_counter()
        if mix["queries"] == "claims":
            self.corpus = gen.generate(cc["num_docs"], seed=[run.seed, 1])
            self.queries = gen.draw_claims(self.corpus, n_queries, seed=[run.seed, 2]).texts
            self.doc_index = {d: i for i, d in enumerate(self.corpus.titles)}
            log(f"corpus of {cc['num_docs']} docs and {n_queries} claims in "
                f"{time.perf_counter() - t:.2f}s")
            t = time.perf_counter()
            from ircl_tpu_torch.corpus.store import MemoryDocStore

            store = MemoryDocStore(dict(zip(self.corpus.titles, self.corpus.texts)))
            index = tfidf_transform(build_count_index(store, ngram=cc["ngram"],
                                                      hash_size=self.hash_size))
        else:
            self.postings = scale.synth_postings(cc["num_docs"], cc["terms_per_doc"],
                                                 cc["vocab"], self.hash_size, seed=[run.seed, 1])
            df = self.postings.doc_freqs()
            self.qb, self.qw = scale.synth_queries(df, cc["num_docs"], n_queries,
                                                   mix["terms"], seed=[run.seed, 2])
            log(f"{len(self.postings.doc)} postings over {cc['num_docs']} docs and "
                f"{n_queries} queries in {time.perf_counter() - t:.2f}s")
            t = time.perf_counter()
            p = self.postings
            index = tfidf_transform(assemble_csr(
                p.bucket, p.doc.astype(np.int32), p.count.astype(np.int32), self.hash_size,
                cc["ngram"], [str(i) for i in range(cc["num_docs"])]))
        log(f"program index: {index.nnz} postings in {time.perf_counter() - t:.2f}s")
        # the df spectrum, beside the source's (5,463,756 postings at 50K docs)
        df = np.diff(index.indptr)
        log("df spectrum: " + df_spectrum(df[df > 0]))
        t = time.perf_counter()
        before = torch.cuda.memory_allocated() if run.device.type == "cuda" else 0
        self.ranker = TfidfRanker(
            index, run.device, mode=rk["mode"], df_threshold=rk["df_threshold"],
            width_buckets=rk["width_buckets"], fixed_union_cap=rk.get("fixed_union_cap"),
            fixed_max_terms=rk.get("fixed_max_terms"), union_round=rk.get("union_round"),
            d_tile=rk.get("d_tile"),
            # the control: the ranker's own TF32 scoring GEMM
            precision="default" if run.control else rk["precision"])
        resident = (torch.cuda.memory_allocated() if run.device.type == "cuda" else 0) - before
        log(f"ranker built in {time.perf_counter() - t:.2f}s")
        del index
        self.config_max_terms = rk.get("fixed_max_terms")
        self.results = {}
        # the window's answers the check reads: ordinals drawn from the seed
        # among those the warm-up rate says the window will reach
        t = time.perf_counter()
        for j in range(self.pool):
            self._finish(self._dispatch(run, j), run, record=False)
        per_batch = (time.perf_counter() - t) / self.pool
        log("index_bytes " + index_bytes(self.ranker, resident, self._host_inputs(0)))
        reach = max(2, int(0.7 * run.seconds / per_batch))
        self.keep = set(_rng(run, 3).choice(reach, size=min(reach, mix["sample_batches"]),
                                            replace=False).tolist())
        run.spans.clear()
        run.device_ms.clear()
        log(f"warm-up: {self.pool} batches, {per_batch * 1e3:.1f} ms a batch")

    def _slice(self, j: int):
        lo = (j % self.pool) * self.batch
        return lo, lo + self.batch

    def _vectors(self, j: int):
        lo, hi = self._slice(j)
        if hasattr(self, "queries"):
            return self.ranker._vectorize(self.queries[lo:hi])
        return self.qb[lo:hi], self.qw[lo:hi]

    def _host_inputs(self, j: int):
        return self.ranker.hybrid_host_inputs(*self._vectors(j))

    def _prepare(self, run, j: int):
        """The host half of batch ``j``: query vectors and the engine's
        host inputs (light pools, union, query slab rows)."""
        start = time.perf_counter()
        with run.span("vectorize"):
            buckets, weights = self._vectors(j)
        with run.span("host_inputs"):
            host = self.ranker.hybrid_host_inputs(buckets, weights)
        return j, start, host

    def _launch(self, run, item):
        """The device half of a prepared batch: uploads and kernels,
        bracketed by CUDA events; returns without waiting for the card."""
        import torch

        j, start, host = item
        events = None
        if run.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        with run.span("upload_launch"):
            pending = self.ranker.hybrid_from_host_async(host, self.k)
        if events:
            events[1].record()
        return j, start, events, pending

    def _dispatch(self, run, j: int):
        return self._launch(run, self._prepare(run, j))

    def _finish(self, item, run, record=True):
        j, start, events, pending = item
        with run.span("finalize"):
            out = self.ranker.finalize_closest(pending, self.batch)
        end = time.perf_counter()
        if not record:
            return
        run.requests.append(Request(start, end, self.batch))
        if events:
            run.device_ms["device_half"].append(events[0].elapsed_time(events[1]))
        if j in self.keep:
            self.results[j] = out
        self.last = (j, out)

    def window(self, run) -> None:
        """Batch n + 1's host half runs while the card scores batch n; then
        batch n is read back and batch n + 1 launched. (Launching n + 1
        before reading n back would queue the read-back behind n + 1's
        kernels on the one stream.)"""
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        pending, j = None, 0
        while True:
            if run.probe.due(j):
                if pending:
                    self._finish(pending, run)
                    pending = None
                run.probe.toggle(j)
            if time.perf_counter() >= deadline:
                break
            item = self._prepare(run, j)
            run.attempted += 1
            if pending:
                self._finish(pending, run)
            pending, j = self._launch(run, item), j + 1
        if pending:
            self._finish(pending, run)
        run.window_s = time.perf_counter() - t0
        run.probe.stop(j)
        run.failed = run.attempted - len(run.requests)
        run.info["ordinals"] = j

    def release(self) -> None:
        del self.ranker

    def _reference(self, run):
        if not hasattr(self, "ref"):
            t = time.perf_counter()
            if hasattr(self, "queries"):
                d, b, c = text.hashed_counts(self.corpus.texts, self.hash_size)
                self.ref = sparse.SparseReference(d, b, c, self.corpus.num_docs, self.hash_size)
            else:
                p = self.postings
                self.ref = sparse.SparseReference(p.doc, p.bucket, p.count, p.num_docs,
                                                  self.hash_size)
            log(f"reference index in {time.perf_counter() - t:.2f}s")
        return self.ref

    def _query_terms(self, positions):
        """(row, bucket, weight) of the pool's queries at ``positions``."""
        ref = self.ref
        if hasattr(self, "queries"):
            mt = self.config_max_terms
            row, b, c = text.hashed_counts([self.queries[p] for p in positions], self.hash_size,
                                           max_terms=mt)
            return row, b, ref.query_weights(c, b)
        qb, qw = self.qb[positions], self.qw[positions]
        row = np.repeat(np.arange(len(positions)), qb.shape[1])
        return row, qb.reshape(-1).astype(np.int64), qw.reshape(-1).astype(np.float64)

    def check(self, run):
        ref = self._reference(run)
        kept = dict(self.results)
        kept[self.last[0]] = self.last[1]
        rng = _rng(run, 4)
        positions, docs, scores = [], [], []
        for j in sorted(kept):
            out = kept[j]
            lo, _ = self._slice(j)
            take = np.sort(rng.choice(self.batch, size=min(self.batch, run.mix["sample_queries"]),
                                      replace=False))
            for t in take.tolist():
                ids, sc = out[t]
                row_d = np.full(self.k, -1, np.int64)
                row_s = np.zeros(self.k)
                got = [self._doc(d) for d in ids][: self.k]
                row_d[: len(got)] = got
                row_s[: len(got)] = np.asarray(sc, np.float64)[: len(got)]
                positions.append(lo + t)
                docs.append(row_d)
                scores.append(row_s)
        t = time.perf_counter()
        row, bucket, weight = self._query_terms(np.asarray(positions))
        top = ref.topk(row, bucket, weight, len(positions), self.k, np.stack(docs))
        gap = sparse.score_gap(np.stack(docs), np.stack(scores), top)
        log(f"compared {len(positions)} answers of {len(kept)} batches with the reference in "
            f"{time.perf_counter() - t:.2f}s; worst query {int(np.argmax(gap))}")
        return [Check("score_gap", float(gap.max()), float(run.mix["limits"]["score_gap"]))]

    def _doc(self, doc_id) -> int:
        if hasattr(self, "doc_index"):
            return self.doc_index.get(doc_id, -2)
        return int(doc_id)

    def work(self, run) -> None:
        """Each window batch's work, for the roofline and mfu readers."""
        ref = self._reference(run)
        thr = run.config["ranker"]["df_threshold"]
        per_pool = []
        for p in range(self.pool):
            lo = p * self.batch
            row, bucket, weight = self._query_terms(np.arange(lo, lo + self.batch))
            per_pool.append(retrieve_batch.batch_work(
                row, bucket, weight, ref.doc_freqs, thr, self.batch, ref.num_docs, self.k))
        for j in range(run.info["ordinals"]):
            run.work[j] = per_pool[j % self.pool]


def df_spectrum(df: np.ndarray) -> str:
    """Postings and the df spectrum: terms by df decade."""
    edges = [1, 2, 10, 100, 1000, 10000, 100000, 10 ** 9]
    hist = np.histogram(df, bins=edges)[0]
    parts = [f"df[{a},{b}):{int(h)}" for a, b, h in zip(edges[:-1], edges[1:], hist)]
    return f"postings {int(df.sum())}, terms {len(df)}, " + " ".join(parts)


def index_bytes(ranker, resident: int, host) -> str:
    """What the index holds on the card (postings, the heavy ELL rows the
    slabs are built from, and all the ranker allocated) and on the host
    (light postings), and a batch's slabs and light pools (batch 0). It
    reads the ranker's own arrays: a line of the log, not a metric."""
    import json

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    dev = ranker.dev
    heavy = [t for name in ("_heavy_a", "_heavy_b") for t in getattr(ranker, name, ())]
    split = ranker._split
    u_pad, qb_t, _, ld, lc = host
    n_pad = sum(t.shape[1] for t in heavy[::2])
    return json.dumps({
        "postings": nbytes((dev.indptr, dev.post_docs, dev.post_vals)),
        "heavy_ell": nbytes(heavy),
        "ranker_resident": resident,
        "light_postings_host": int(split.light_indptr.nbytes + split.light_docs.nbytes
                                   + split.light_vals.nbytes),
        "batch_slabs": 4 * len(u_pad) * (n_pad + qb_t.shape[1]),
        "batch_light_pools": int(ld.nbytes + lc.nbytes)})


def build(run) -> RetrieveCell:
    return RetrieveCell(run)
