"""Window driver of claim verification by the Moonlight-16B-A3B verifier:
requests of (claim, evidence) pairs through ``VerdictClassifier.classify``
with the MLA + MoE decoder body, a closed loop of one client.

The traffic is ``verify.py``'s (``_verdict.Pairs``: the same pool, the
pinned [batch, max_length] forward, the program's WordPiece trained at
set-up); the body is the configuration's published ``deepseek_v3`` widths in
bf16 (``ircl_tpu_torch/models/mla_moe.py``), its weights drawn on the card
from the seed. The reference rebuilds the vocabulary and the ids with its
frozen WordPiece and runs the plain model (``reference/moonlight.py``, f32
with the configuration's bf16 roundings) on a sample of the window's
requests and the last one, each pair at its real length, on weights drawn
anew from the seed after the program is released. The control is that
reference with the expert products' operands in fp8 e4m3, in the
classifier's place.

``prob_gap_pNN`` is the NN-th percentile, over the compared pairs, of the
gap between a returned confidence and the reference's probability of the
returned label; the mix's ``limits`` name the percentiles held, each with
its own limit (the mean and the worst pair go to stderr). Not the worst pair
alone: at 27 layers a correct bf16 forward and the reference differ by a
rounding here and there in every layer, a token whose 6th and 7th experts
nearly tie then takes the other one, and the rounding differences grow from
layer to layer, so some pairs' probabilities move by a few tenths, as they
do between the reference and itself summed in f64
(``moonlight_faults.py --witness``). The low percentiles tell the program
from the fp8 control and from a fault in every pair; the high ones from a
fault confined to some of the pairs (PERF.md, section 2, has the readings
behind each limit).

After the window ``run.info`` holds the program's routing counters
(``expert_counters``: batches, routed rows, the busiest expert's rows over
the mean) and the grouped kernel's launches.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from benchmark.harness import Check, Request, log
from benchmark.reference import moonlight
from benchmark.reference import wordpiece as ref_wp
from benchmark.rooflines import moonlight_model
from benchmark.traffic import _verdict


def _real_rows(ids: np.ndarray, mask: np.ndarray):
    return [row[: int(m.sum())] for row, m in zip(ids, mask)]


class ReferenceClassifier:
    """The control: the plain model with fp8 expert products, behind
    ``classify``."""

    def __init__(self, run, texts):
        cfg = run.config
        self.cfg, self.seed, self.device = cfg, run.seed, run.device
        self.vocab = ref_wp.train(texts, cfg["wordpiece"]["vocab_size"], cfg["wordpiece"]["min_count"])

    def classify(self, claims, evidence):
        ids, mask, _ = ref_wp.encode_pairs(list(zip(claims, evidence)), self.vocab,
                                           self.cfg["verdict"]["max_length"])
        p = moonlight.probabilities(self.cfg, self.seed, _real_rows(ids, mask), self.device,
                                    experts_fp8=True)
        return [{"label_id": int(i), "confidence": float(p[r, i])}
                for r, i in enumerate(p.argmax(-1))]


class VerifyMoECell:
    def __init__(self, run):
        # the program's body first: a checkout without it stops here, at once
        from ircl_tpu_torch.models.mla_moe import ExpertCounters, MLAMoEConfig, init_mla_moe_params
        from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
        from ircl_tpu_torch.ops.moe_grouped_gemm_cuda import grouped_gemm
        from ircl_tpu_torch.verdict.infer import VerdictClassifier
        from ircl_tpu_torch.verdict.model import VerdictConfig

        cfg, mix = run.config, run.mix
        self.batch, self.pool = mix["batch"], mix["pool_requests"]
        self.pairs = _verdict.Pairs(run, self.batch * self.pool)
        self.kernel = grouped_gemm
        t = time.perf_counter()
        wp, v = cfg["wordpiece"], cfg["verdict"]
        if run.control:
            self.classifier = ReferenceClassifier(run, self.pairs.vocab_texts)
        else:
            body = MLAMoEConfig.from_hf(cfg, num_labels=v["num_labels"], **cfg["assumed_init"])
            params = init_mla_moe_params(body, run.seed, run.device)
            tok = WordPieceTokenizer.train(self.pairs.vocab_texts, vocab_size=wp["vocab_size"],
                                           min_count=wp["min_count"])
            self.classifier = VerdictClassifier(
                VerdictConfig(encoder=body, num_labels=v["num_labels"],
                              max_length=v["max_length"]),
                params, tok, batch_size=self.batch)
            del params
        log(f"weights and vocabulary in {time.perf_counter() - t:.2f}s")
        t = time.perf_counter()
        for j in range(mix["warmup_requests"]):
            self.classifier.classify(*self._slice(j))
        per = (time.perf_counter() - t) / mix["warmup_requests"]
        log(f"warm-up: {mix['warmup_requests']} requests, {per * 1e3:.1f} ms a request")
        if not run.control:
            self.classifier.expert_counters = ExpertCounters()
        self.launches0 = self.kernel.launches
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
        counters = getattr(self.classifier, "expert_counters", None)
        if counters is not None:
            run.info["expert_counters"] = dataclasses.asdict(counters)
            run.info["grouped_launches"] = self.kernel.launches - self.launches0
            log(f"routed rows a request {counters.routed_rows / max(counters.batches, 1):.0f}, "
                f"busiest expert over the mean "
                f"{counters.load_max_over_mean / max(counters.batches, 1):.3f}, grouped kernel "
                f"launches a request {run.info['grouped_launches'] / max(j, 1):.1f}")

    def release(self) -> None:
        del self.classifier

    def check(self, run):
        cfg = run.config
        t = time.perf_counter()
        vocab = ref_wp.train(self.pairs.vocab_texts, cfg["wordpiece"]["vocab_size"],
                             cfg["wordpiece"]["min_count"])
        ids, mask, _ = ref_wp.encode_pairs(list(zip(self.pairs.claims, self.pairs.evidence)),
                                           vocab, cfg["verdict"]["max_length"])
        self.lengths = mask.sum(1).astype(np.int64)
        log(f"real lengths of the {len(ids)} pairs: "
            + _verdict.lengths_histogram(self.lengths, cfg["verdict"]["max_length"]))
        kept = dict(self.results)
        kept[self.last[0]] = self.last[1]
        rows = np.concatenate([(j % self.pool) * self.batch + np.arange(self.batch)
                               for j in sorted(kept)])
        got = [r for j in sorted(kept) for r in kept[j]]
        limits = run.mix["limits"]
        if len(got) != len(rows):
            return [Check(name, float("inf"), float(v)) for name, v in limits.items()]
        # the weights drawn anew from the seed: the program may have changed its own
        probs = moonlight.probabilities(cfg, run.seed, _real_rows(ids[rows], mask[rows]),
                                        run.device)
        label = np.array([g["label_id"] for g in got])
        conf = np.array([g["confidence"] for g in got])
        gap = np.abs(conf - probs[np.arange(len(rows)), label])
        self.compared, self.gaps = rows, gap
        checks = [Check(name, float(np.quantile(gap, int(name.rsplit("_p", 1)[1]) / 100)),
                        float(v)) for name, v in limits.items()]
        log(f"compared {len(rows)} pairs of {len(kept)} requests with the reference in "
            f"{time.perf_counter() - t:.2f}s; gap "
            + ", ".join(f"{c.name[9:]} {c.value:.4g}" for c in checks)
            + f", mean {gap.mean():.4g}, worst {gap.max():.4g} (pair {int(np.argmax(gap))})")
        return checks

    def work(self, run) -> None:
        for j in range(run.info["ordinals"]):
            lo = (j % self.pool) * self.batch
            run.work[j] = moonlight_model.work(run.config, self.lengths[lo:lo + self.batch])


def build(run) -> VerifyMoECell:
    return VerifyMoECell(run)
