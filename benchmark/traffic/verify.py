"""Window driver of claim verification: requests of (claim, evidence) pairs
through ``VerdictClassifier.classify``, a closed loop of one client.

Stage 3 as ``RetrievalService.verify_claims`` feeds it: each request is
``batch`` pairs of the pool, in pool order (the pool over again once it is
spent); ``classify`` tokenizes them on the host (the WordPiece vocabulary
the program trained at set-up), runs the pinned [batch, max_length]
forward and returns each pair's label and confidence. The reference
rebuilds the vocabulary and the ids with its frozen WordPiece and runs the
plain float32 model on a sample of the window's requests, drawn from the
seed, on the weights made anew from the seed. The control is that reference, in TF32, in the
classifier's place.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import Check, Request, log
from benchmark.reference import roberta
from benchmark.reference import wordpiece as ref_wp
from benchmark.traffic import _verdict


class ReferenceClassifier:
    """The control: the plain model in TF32, behind ``classify``."""

    def __init__(self, run, params, texts):
        cfg = run.config
        self.c, self.params, self.cfg = cfg["roberta"], params, cfg
        self.vocab = ref_wp.train(texts, cfg["wordpiece"]["vocab_size"], cfg["wordpiece"]["min_count"])
        self.device = run.device

    def classify(self, claims, evidence):
        import torch

        enc = ref_wp.encode_pairs(list(zip(claims, evidence)), self.vocab,
                                  self.cfg["verdict"]["max_length"])
        p = roberta.probabilities(self.c, self.params,
                                  *(torch.as_tensor(x, device=self.device) for x in enc),
                                  self.cfg["verdict"]["position_offset"], tf32=True).cpu().numpy()
        return [{"label_id": int(i), "confidence": float(p[r, i])}
                for r, i in enumerate(p.argmax(-1))]


class VerifyCell:
    def __init__(self, run):
        from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
        from ircl_tpu_torch.verdict.infer import VerdictClassifier

        cfg, mix = run.config, run.mix
        self.batch, self.pool = mix["batch"], mix["pool_requests"]
        self.pairs = _verdict.Pairs(run, self.batch * self.pool)
        t = time.perf_counter()
        params = _verdict.weights(run)
        wp = cfg["wordpiece"]
        if run.control:
            self.classifier = ReferenceClassifier(run, params, self.pairs.vocab_texts)
        else:
            tok = WordPieceTokenizer.train(self.pairs.vocab_texts, vocab_size=wp["vocab_size"],
                                           min_count=wp["min_count"])
            self.classifier = VerdictClassifier(_verdict.program_config(cfg), params, tok,
                                                batch_size=self.batch)
        del params
        log(f"weights and vocabulary in {time.perf_counter() - t:.2f}s")
        t = time.perf_counter()
        for j in range(mix["warmup_requests"]):
            self.classifier.classify(*self._slice(j))
        per = (time.perf_counter() - t) / mix["warmup_requests"]
        log(f"warm-up: {mix['warmup_requests']} requests, {per * 1e3:.1f} ms a request")
        reach = max(2, int(0.7 * run.seconds / per))
        self.keep = set(np.random.default_rng([run.seed, 4]).choice(
            reach, size=min(reach, mix["sample_requests"]), replace=False).tolist())
        self.results = {}
        run.spans.clear()

    def _slice(self, j: int):
        lo = (j % self.pool) * self.batch
        return self.pairs.slice(lo, lo + self.batch)

    def window(self, run) -> None:
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        j = 0
        while time.perf_counter() < deadline:
            if run.probe.due(j):  # classify returns with its results on the host
                run.probe.toggle(j)
            start = time.perf_counter()
            run.attempted += 1
            with run.span("classify"):
                out = self.classifier.classify(*self._slice(j))
            run.requests.append(Request(start, time.perf_counter(), len(out)))
            if j in self.keep:
                self.results[j] = out
            self.last = (j, out)
            j += 1
        run.window_s = time.perf_counter() - t0
        run.probe.stop(j)
        run.failed = run.attempted - len(run.requests)
        run.info["ordinals"] = j

    def release(self) -> None:
        del self.classifier

    def check(self, run):
        import torch

        cfg = run.config
        t = time.perf_counter()
        vocab = ref_wp.train(self.pairs.vocab_texts, cfg["wordpiece"]["vocab_size"],
                             cfg["wordpiece"]["min_count"])
        ids, mask, types = ref_wp.encode_pairs(list(zip(self.pairs.claims, self.pairs.evidence)),
                                               vocab, cfg["verdict"]["max_length"])
        self.lengths = mask.sum(1).astype(np.int64)
        log(f"real lengths of the {len(ids)} pairs: "
            + _verdict.lengths_histogram(self.lengths, cfg["verdict"]["max_length"]))
        kept = dict(self.results)
        kept[self.last[0]] = self.last[1]
        rows = np.concatenate([(j % self.pool) * self.batch + np.arange(self.batch) for j in sorted(kept)])
        got = [r for j in sorted(kept) for r in kept[j]]
        # the weights made anew from the seed: the program may have changed its own
        probs = roberta.probabilities(
            cfg["roberta"], _verdict.weights(run),
            *(torch.as_tensor(x[rows], device=run.device) for x in (ids, mask, types)),
            cfg["verdict"]["position_offset"]).double().cpu().numpy()
        if len(got) != len(rows):
            return [Check("prob_gap", float("inf"), float(run.mix["limits"]["prob_gap"]))]
        label = np.array([g["label_id"] for g in got])
        conf = np.array([g["confidence"] for g in got])
        gap = np.abs(conf - probs[np.arange(len(rows)), label])
        log(f"compared {len(rows)} pairs of {len(kept)} requests with the reference in "
            f"{time.perf_counter() - t:.2f}s; worst pair {int(np.argmax(gap))}")
        return [Check("prob_gap", float(gap.max()), float(run.mix["limits"]["prob_gap"]))]

    def work(self, run) -> None:
        for j in range(run.info["ordinals"]):
            lo = (j % self.pool) * self.batch
            run.work[j] = _verdict.request_work(run, self.lengths[lo:lo + self.batch])


def build(run) -> VerifyCell:
    return VerifyCell(run)
