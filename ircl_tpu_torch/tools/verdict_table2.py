"""Verdict F1 against evidence source on the port: the report's Table 2
analogue.

    python3 -m ircl_tpu_torch.tools.verdict_table2 [--docs 600
        --train-claims 20000 --dev-claims 1000 --epochs 20 --restarts 3
        --out RESULTS_TORCH.md --device cpu]

The port of ``scripts/verdict_table2.py``, with its arguments, defaults,
seeds and order of work. The reference's extrinsic evaluation (report.pdf
Table 2, §4.3) compares the FEVER verdict classifier under different
evidence inputs: ground truth (ceiling), TF-IDF retrieval, claim-only and
random evidence. This reproduces it on the synthetic 2-class corpus
(``generate(refute_fraction=...)``): the verdict transformer (2 layers, 128
wide, 4 heads, L=128, the "xla" attention) is trained on gold evidence by
the script's three-phase curriculum, restarted with several seeds, then
evaluated with each evidence source swapped in through
``build_examples(evidence_override=...)``.

Runs on the card unless ``--device`` names another device. Writes the
section between the ``<!-- table2:begin/end -->`` markers of ``--out`` and
prints one JSON line; progress goes to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import sys
import time

import numpy as np

from ircl_tpu_torch.corpus.store import MemoryDocStore
from ircl_tpu_torch.corpus.synthetic import generate
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.models.transformer import TransformerConfig
from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
from ircl_tpu_torch.pipeline.retrieve import host_sparse_scorer, retrieve
from ircl_tpu_torch.tools.results import write_section
from ircl_tpu_torch.utils.device import resolve_device
from ircl_tpu_torch.verdict.data import build_examples, encode_examples
from ircl_tpu_torch.verdict.evaluate import classification_report
from ircl_tpu_torch.verdict.model import VerdictConfig
from ircl_tpu_torch.verdict.train import predict_in_batches, train_verdict

MARK_BEGIN = "<!-- table2:begin -->"
MARK_END = "<!-- table2:end -->"

_VAL_RE = re.compile(r"\bval(\d+)\b")


def parse_args(argv=None):
    """The script's arguments; its comments give each default's measured
    reason (``scripts/verdict_table2.py:32-107``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=600)
    ap.add_argument("--train-claims", type=int, default=20000)
    ap.add_argument("--dev-claims", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--max-length", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=50)
    # gold evidence among up to N sampled distractor sentences at train time
    ap.add_argument("--train-distractors", type=int, default=4)
    # fact-slot cardinality
    ap.add_argument("--val-range", type=int, default=500)
    # REFUTES val-trap rate injected into a sampled phase C (0 disables)
    ap.add_argument("--phase-c-trap", type=float, default=0.0)
    # curriculum restarts, the best final-phase val F1 kept
    ap.add_argument("--restarts", type=int, default=3)
    # probability that a sampled phase C puts the gold sentence first
    ap.add_argument("--phase-c-gold-first", type=float, default=0.0)
    # phase C = replay of the tf-idf pipeline's top-k sentences, k in {1, 3, 5}
    ap.add_argument(
        "--phase-c-retrieved",
        action=argparse.BooleanOptionalAction,
        default=True,
    )
    ap.add_argument("--out", default="RESULTS_TORCH.md")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def build_corpus(args):
    """The 2-class corpus of seed 23: every sentence carries one valNN fact
    slot, and a REFUTES claim differs from its gold evidence only there.
    Returns ``(wiki, train_claims, dev_claims)``."""
    wiki = generate(
        num_docs=args.docs,
        num_claims=args.train_claims + args.dev_claims,
        claim_keep_prob=0.7,
        refute_fraction=0.4,
        refute_marker=False,
        refute_corrupt=0.0,
        value_tokens=True,
        val_range=args.val_range,
        seed=23,
    )
    return wiki, wiki.claims[: args.train_claims], wiki.claims[args.train_claims :]


def make_build_aug(train_claims, doc_sents, train_distractors: int):
    """``build_aug(same_doc_frac, seed, ...)``: the train claims' examples
    with gold evidence among sampled distractor sentences (the script's
    ``build_aug``, ``scripts/verdict_table2.py:201-274``)."""
    # val token -> sentences holding it (the "val trap" pool)
    val_inv = {}
    for d, sents in doc_sents.items():
        for si, sent in enumerate(sents):
            for v in set(_VAL_RE.findall(sent)):
                val_inv.setdefault(v, []).append((d, si))

    def build_aug(same_doc_frac: float, seed: int, fixed_n: bool = False,
                  refute_val_trap: float = 0.0, gold_frac: float = 0.0,
                  mid_frac: float = 0.0, gold_first: float = 0.0):
        rng_t = np.random.default_rng(seed)
        all_ids = list(doc_sents.keys())
        override = []
        for c in train_claims:
            gold = [(d, s) for d, ss in c.evidences.items() for s in ss]
            gold_doc = gold[0][0]
            if gold_frac > 0.0 and rng_t.random() < gold_frac:
                n_d = 0
            elif mid_frac > 0.0 and rng_t.random() < mid_frac:
                n_d = max(train_distractors // 2, 1)
            elif fixed_n:
                n_d = train_distractors
            else:
                n_d = int(rng_t.integers(0, train_distractors + 1))
            picks = []
            if (
                refute_val_trap > 0.0
                and c.label == "REFUTES"
                and n_d > 0
                and rng_t.random() < refute_val_trap
            ):
                cv = _VAL_RE.findall(c.claim)
                pool = [k for k in val_inv.get(cv[0] if cv else "", ()) if k not in gold]
                if pool:
                    picks.append(pool[int(rng_t.integers(len(pool)))])
            while len(picks) < n_d:
                if rng_t.random() < same_doc_frac and len(doc_sents[gold_doc]) > 1:
                    d = gold_doc
                else:
                    d = all_ids[int(rng_t.integers(len(all_ids)))]
                picks.append((d, int(rng_t.integers(len(doc_sents[d])))))
            rng_t.shuffle(picks)
            if gold_first > 0.0 and rng_t.random() < gold_first:
                pos = 0  # serving-order alignment: gold leads (rank 0)
            else:
                pos = int(rng_t.integers(0, n_d + 1))
            override.append(picks[:pos] + gold + picks[pos:])
        return build_examples(train_claims, doc_sents, evidence_override=override)

    return build_aug


class SentenceRetriever:
    """The serving pipeline's two stages over claims: the tf-idf ranker
    (built at first use; hashed bigrams in 2^22 buckets) and the host's
    sparse sentence scorer, 5 docs and 5 sentences a claim."""

    def __init__(self, wiki, device):
        self.wiki = wiki
        self.device = device
        self._ranker = None

    def ranker(self):
        if self._ranker is None:
            store = MemoryDocStore({d: r["text"] for d, r in self.wiki.docs.items()})
            index = tfidf_transform(build_count_index(store, ngram=2, hash_size=1 << 22))
            self._ranker = TfidfRanker(index, self.device)
        return self._ranker

    def __call__(self, claim_objs):
        return retrieve(
            [c.claim for c in claim_objs], self.ranker(), self.wiki.sentences,
            host_sparse_scorer(), k_docs=5, k_sents=5, batch_size=256,
        )


def curriculum(args, train_claims, doc_sents, build_aug, retrieve_sentences):
    """The phases ``(examples, max epochs, stop criterion, lr, keep_best)``
    and the examples the tokenizer is trained on: A pure gold, B gold among
    random-doc distractors, C the retrieval replay (or, without it, gold
    among half same-doc distractors)."""
    train_ex_gold = build_examples(train_claims, doc_sents)
    if args.train_distractors <= 0:
        return [(train_ex_gold, args.epochs, None, 3e-4, False)], train_ex_gold
    if args.phase_c_retrieved:
        # Phase C = the serving distribution itself: top-k retrieved
        # sentences a train claim, k ~ U{1, 3, 5}, in score order.
        t_r = time.time()
        r_train = retrieve_sentences(train_claims)
        ks = np.random.default_rng(13).choice([1, 3, 5], size=len(train_claims))
        phase_c_ex = build_examples(
            train_claims, doc_sents,
            evidence_override=[sents[: int(k)] for sents, k in zip(r_train.sentences, ks)],
        )
        print(f"phase-C retrieval replay built in {time.time() - t_r:.1f}s",
              file=sys.stderr, flush=True)
    else:
        phase_c_ex = build_aug(
            0.5, 13, fixed_n=True,
            refute_val_trap=args.phase_c_trap,
            gold_frac=0.25,
            gold_first=args.phase_c_gold_first,
        )
    phases = [
        (train_ex_gold, args.epochs, 0.90, 3e-4, False),
        (build_aug(0.0, 11), max(args.epochs // 2, 1), None, 1e-4, True),
        (phase_c_ex, max(args.epochs // 2, 1), None, 1e-4, True),
    ]
    return phases, phases[2][0]


def train_tokenizer(tok_corpus) -> WordPieceTokenizer:
    """The WordPiece vocabulary (4096) of the examples' claims and evidence."""
    return WordPieceTokenizer.train(
        [e.claim for e in tok_corpus] + [e.evidence_text for e in tok_corpus],
        vocab_size=4096,
    )


def encode_phases(phases, tok, max_length: int):
    """Each phase's examples encoded once (the restarts reuse them)."""
    return [
        (encode_examples(ex, tok, max_length), n_ep, target, lr, kb)
        for ex, n_ep, target, lr, kb in phases
    ]


def encode_variant(dev_claims, doc_sents, override, tok, max_length: int):
    """The dev claims' examples with one evidence source, encoded."""
    ex = build_examples(dev_claims, doc_sents, evidence_override=override)
    return encode_examples(ex, tok, max_length)


def verdict_config(args, tok) -> VerdictConfig:
    return VerdictConfig(
        encoder=TransformerConfig(
            vocab_size=tok.vocab_size,
            hidden=args.hidden,
            layers=args.layers,
            heads=4,
            intermediate=4 * args.hidden,
            max_positions=args.max_length,
        ),
        learning_rate=3e-4,
        warmup_steps=args.warmup,
        freeze_body_until_warmup=True,
        max_length=args.max_length,
    )


def train_restarts(encoded, vcfg, restarts: int, device):
    """The curriculum trained ``restarts`` times with seeds ``1009 + 101 r``
    on one fixed validation split (``split_seed=1009``). Returns the params
    and history of the restart with the best final val F1, and each
    restart's final val F1."""

    def run_curriculum(seed):
        params, history, hist, keep_best = None, [], [], False
        for (ids, mask, types, labels), n_ep, target, lr, keep_best in encoded:
            cfg_p = dataclasses.replace(vcfg, learning_rate=lr)
            params, hist = train_verdict(
                cfg_p, ids, mask, types, labels,
                epochs=n_ep, batch_size=32, val_fraction=0.05,
                init_params=params, stop_at_val_f1=target,
                keep_best=keep_best, seed=seed,
                split_seed=1009,
                device=device,
            )
            history = history + hist
        # val F1 of the params returned: the last phase's best epoch with
        # keep_best, its last epoch without
        final = (
            max((h["val_macro_f1"] or 0.0) for h in hist)
            if keep_best
            else (hist[-1]["val_macro_f1"] or 0.0)
        )
        return params, history, final

    best = None
    restart_vals = []
    for r in range(max(restarts, 1)):
        seed = 1009 + 101 * r  # reference QA seed + offsets
        params_r, history_r, final_r = run_curriculum(seed)
        restart_vals.append(round(final_r, 4))
        print(f"restart {r} (seed {seed}): final val F1 {final_r:.4f}",
              file=sys.stderr, flush=True)
        if best is None or final_r > best[2]:
            best = (params_r, history_r, final_r)
    return best, restart_vals


def dev_variants(dev_claims, doc_sents, retrieve_sentences, res):
    """The six evidence sources of the dev table (``tfidf_sentence_recall@1``
    and ``@5`` of the retrieval go into ``res``); the random evidence draws
    from ``default_rng(5)``."""
    rng = np.random.default_rng(5)
    doc_ids = list(doc_sents.keys())

    def tfidf_override():
        r = retrieve_sentences(dev_claims)
        ranks = []
        for c, sents in zip(dev_claims, r.sentences):
            gold = {(d, s) for d, ss in c.evidences.items() for s in ss}
            ranks.append(next((i for i, p in enumerate(sents) if p in gold), -1))
        ranks = np.asarray(ranks)
        for k in (1, 5):
            res[f"tfidf_sentence_recall@{k}"] = round(
                float(np.mean((ranks >= 0) & (ranks < k))), 3
            )
        return r.sentences

    def random_override():
        out = []
        for _ in dev_claims:
            picks = []
            for _ in range(3):
                d = doc_ids[int(rng.integers(len(doc_ids)))]
                picks.append((d, int(rng.integers(len(doc_sents[d])))))
            out.append(picks)
        return out

    retrieved = tfidf_override()
    return {
        "ground_truth": None,
        "tfidf_retrieval": retrieved,
        "tfidf_retrieval_k3": [sents[:3] for sents in retrieved],
        "tfidf_retrieval_k1": [sents[:1] for sents in retrieved],
        "claim_only": [[] for _ in dev_claims],
        "random_evidence": random_override(),
    }


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)

    wiki, train_claims, dev_claims = build_corpus(args)
    doc_sents = wiki.sentences
    res = {
        "docs": args.docs,
        "train_claims": len(train_claims),
        "dev_claims": len(dev_claims),
        "train_distractors": args.train_distractors,
        "phase_c": (
            "retrieved_k135"
            if args.phase_c_retrieved
            else f"sampled(gold_first={args.phase_c_gold_first})"
        ),
    }

    build_aug = make_build_aug(train_claims, doc_sents, args.train_distractors)
    retrieve_sentences = SentenceRetriever(wiki, device)
    phases, tok_corpus = curriculum(args, train_claims, doc_sents, build_aug,
                                    retrieve_sentences)
    tok = train_tokenizer(tok_corpus)
    vcfg = verdict_config(args, tok)
    t0 = time.time()
    encoded = encode_phases(phases, tok, args.max_length)
    best, restart_vals = train_restarts(encoded, vcfg, args.restarts, device)
    params, history, _ = best
    res["train_s"] = round(time.time() - t0, 1)
    res["restart_val_f1s"] = restart_vals
    res["final_val_macro_f1"] = best[2]
    log_hist = [
        (h["epoch"], round(h["train_loss"], 4), round(h["val_macro_f1"] or 0, 3))
        for h in history
    ]
    print("history (epoch, loss, val_f1):", log_hist, file=sys.stderr)

    # ---- evidence variants at eval time -------------------------------------
    variants = dev_variants(dev_claims, doc_sents, retrieve_sentences, res)
    table = {}
    for name, override in variants.items():
        e_ids, e_mask, e_types, e_labels = encode_variant(
            dev_claims, doc_sents, override, tok, args.max_length)
        preds = predict_in_batches(params, vcfg, e_ids, e_mask, e_types, device=device)
        rep = classification_report(e_labels, preds)
        table[name] = {
            "precision": round(rep["macro_precision"], 3),
            "recall": round(rep["macro_recall"], 3),
            "f1": round(rep["macro_f1"], 3),
            "accuracy": round(rep["accuracy"], 3),
        }

    print(json.dumps({"results": res, "table2": table}), flush=True)

    lines = [
        "## Verdict F1 vs evidence source (report Table 2 analogue)",
        "",
        f"Synthetic 2-class corpus ({args.docs} docs, refute_fraction 0.4, "
        f"fact-slot cardinality {args.val_range}); "
        f"verdict transformer ({args.layers}L/{args.hidden}h, len "
        f"{args.max_length}) trained {args.epochs} epochs on gold evidence "
        f"(+ up to {args.train_distractors} format distractors, "
        f"{res['train_s']}s; best of {max(args.restarts, 1)} seed restarts "
        f"by val F1: {res.get('restart_val_f1s')}), evaluated on "
        f"{len(dev_claims)} dev claims "
        "with the evidence input swapped. The tfidf retrieval feeding the "
        "tfidf_retrieval row achieves sentence recall@1 "
        f"{res.get('tfidf_sentence_recall@1')} / recall@5 "
        f"{res.get('tfidf_sentence_recall@5')} on these dev claims:",
        "",
        "| evidence source | macro-P | macro-R | macro-F1 | accuracy |",
        "|---|---|---|---|---|",
    ]
    for name, row in table.items():
        lines.append(
            f"| {name} | {row['precision']} | {row['recall']} | "
            f"{row['f1']} | {row['accuracy']} |"
        )
    write_section(args.out, MARK_BEGIN, MARK_END, lines, device)
    return res, table


if __name__ == "__main__":
    main()
