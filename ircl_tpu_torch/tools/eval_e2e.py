"""End-to-end measured evaluation of the port: the full two-stage pipeline.

    python3 -m ircl_tpu_torch.tools.eval_e2e [--docs 5000 --claims 500
        --steps 1500 --featurizer hash|transformer --skip-stem-ab
        --skip-proto --out RESULTS_TORCH.md --device cpu]

The port of ``scripts/eval_e2e.py``, with its arguments, defaults, seeds and
order of work. Builds a synthetic FEVER-like corpus, trains the contrastive
encoder on it (augment / uniform / tf_idf sampling) and measures doc and
sentence recall@k over a k-sweep (the report's Fig. 2 analogue) for:
sparse-only stage 2, untrained dense re-rank, and each trained dense
re-rank. Also A/Bs the sentence-pair similarity feature space (hashed
ngrams against suffix-stripped, lemma-ish ones) and, unless
``--skip-proto``, the ProtoNCE and HProtoNCE losses.

Runs on the card unless ``--device`` names another device. Writes the
section between the ``<!-- eval:begin/end -->`` markers of ``--out``
(``eval-transformer`` for that featurizer) and prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time

from ircl_tpu_torch.contrastive.state import TrainConfig, init_train_state
from ircl_tpu_torch.contrastive.trainer import ContrastiveTrainer
from ircl_tpu_torch.corpus.store import MemoryDocStore
from ircl_tpu_torch.corpus.synthetic import generate
from ircl_tpu_torch.data.pairs import DocPairSampler
from ircl_tpu_torch.data.similarity import sentence_pair_similarity
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.models.encoder import EncoderConfig
from ircl_tpu_torch.models.featurizer import FeaturizerConfig, make_featurizer
from ircl_tpu_torch.pipeline.dense_scorer import ContrastiveSentenceScorer
from ircl_tpu_torch.pipeline.intrinsic import mean_claim_evidence_cosine
from ircl_tpu_torch.pipeline.recall import doc_recall_at_k, sentence_recall_at_k
from ircl_tpu_torch.pipeline.retrieve import host_sparse_scorer, retrieve
from ircl_tpu_torch.tools.results import write_section
from ircl_tpu_torch.utils.device import resolve_device

KS = (1, 5, 10, 20, 50, 100)


def marks(featurizer: str):
    """Per-featurizer section markers (hash keeps the unsuffixed pair)."""
    tag = "eval" if featurizer == "hash" else f"eval-{featurizer}"
    return f"<!-- {tag}:begin -->", f"<!-- {tag}:end -->"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=5000)
    ap.add_argument("--claims", type=int, default=500)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--featurizer", choices=["hash", "transformer"], default="hash")
    ap.add_argument("--skip-stem-ab", action="store_true")
    ap.add_argument("--skip-proto", action="store_true")
    ap.add_argument("--out", default="RESULTS_TORCH.md")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def build_corpus(docs: int, claims: int, device):
    """The corpus of seed 42, its hashed-bigram tf-idf index (2^24 buckets)
    and the stage-1 ranker: ``(wiki, claims_text, ranker, seconds)``."""
    t0 = time.time()
    wiki = generate(num_docs=docs, num_claims=claims, seed=42)
    claims_text = [c.claim for c in wiki.claims]
    store = MemoryDocStore({d: r["text"] for d, r in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=1 << 24))
    ranker = TfidfRanker(index, device)
    return wiki, claims_text, ranker, time.time() - t0


def stage1_sweep(wiki, claims_text, ranker):
    """Stage-1 doc recall@k for every k of ``KS``, from one deep batch."""
    deep = ranker.closest_docs_batch(claims_text, k=max(KS))
    doc_lists = [ids for ids, _ in deep]
    return {k: round(doc_recall_at_k(wiki.claims, doc_lists, k=k), 4) for k in KS}


def featurizer_and_config(featurizer: str, wiki, device, results):
    """The featurizer and the training configuration of the script."""
    if featurizer == "hash":
        feat = make_featurizer(FeaturizerConfig(dim=768, max_len=32), device=device)
        enc = EncoderConfig(masked_mean=True)
    else:
        # The reference's architecture: a frozen transformer (bert-base
        # shape) under the BiLSTM head, random weights, corpus WordPiece.
        fcfg = FeaturizerConfig(kind="transformer", dim=768, max_len=32, wp_vocab=8192)
        corpus_texts = [r["text"] for r in wiki.docs.values()]
        t0 = time.time()
        feat = make_featurizer(fcfg, corpus_texts, device=device)
        results["wordpiece_train_s"] = round(time.time() - t0, 1)
        enc = EncoderConfig(masked_mean=True)
    cfg = TrainConfig(
        encoder=enc,
        micro_batch=128,
        accum_steps=2,
        queue_start_steps=300,
        learning_rate=2.5e-4,
    )
    return feat, cfg


def stage2(wiki, claims_text, ranker, scorer):
    """Two-stage sentence recall@k of one stage-2 scorer (20 docs a claim),
    and, for a dense scorer, ``mean_claim_evidence_cosine``'s numbers (else
    None)."""
    res = retrieve(
        claims_text, ranker, wiki.sentences, scorer,
        k_docs=20, k_sents=max(KS), batch_size=256,
    )
    row = {k: round(sentence_recall_at_k(wiki.claims, res.sentences, k=k), 4)
           for k in KS}
    cos = None
    if hasattr(scorer, "embed"):
        cos = mean_claim_evidence_cosine(scorer.embed, wiki.claims, wiki.sentences)
    return row, cos


def proto_config(cfg: TrainConfig, loss: str, docs: int, steps: int) -> TrainConfig:
    """Prototype losses scaled to this corpus: cluster counts sized for
    ``docs`` documents (the reference's 4096/6144/8192 assume the full-wiki
    sentence corpus) and the refresh schedule compressed into ``steps``."""
    nc = max(32, docs // 40)
    return dataclasses.replace(
        cfg,
        loss=loss,
        cluster_start_steps=max(steps // 3, 1),
        cluster_update_steps=max(steps // 6, 1),
        num_clusters=(nc, nc * 3 // 2, nc * 2),
    )


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)

    wiki, claims_text, ranker, t_index = build_corpus(args.docs, args.claims, device)
    results = {
        "corpus_docs": args.docs,
        "claims": args.claims,
        "index_s": round(t_index, 1),
    }
    sweep = {}  # tag -> {k: recall}

    # ---- stage 1: doc recall@k sweep from one deep batch -------------------
    t0 = time.time()
    sweep["doc_tfidf"] = stage1_sweep(wiki, claims_text, ranker)
    results["doc_recall@5"] = sweep["doc_tfidf"][5]
    results["stage1_s"] = round(time.time() - t0, 1)

    feat, cfg = featurizer_and_config(args.featurizer, wiki, device, results)

    def run_stage2(scorer, tag):
        t0 = time.time()
        sweep[tag], cos = stage2(wiki, claims_text, ranker, scorer)
        results[f"sentence_recall@5_{tag}"] = sweep[tag][5]
        results[f"stage2_{tag}_s"] = round(time.time() - t0, 1)
        if cos is not None:
            results[f"claim_evidence_cosine_{tag}"] = round(cos["mean_cosine"], 4)
            results[f"shuffled_cosine_{tag}"] = round(cos["shuffled_cosine"], 4)
            # Anisotropy-corrected: claim-evidence minus shuffled baseline.
            results[f"corrected_cosine_{tag}"] = round(
                cos["mean_cosine"] - cos["shuffled_cosine"], 4
            )
        print(f"{tag}: {json.dumps(sweep[tag])}", file=sys.stderr, flush=True)

    # ---- sparse-only stage 2 (the TF-IDF row of the Fig. 2 analogue) -------
    run_stage2(host_sparse_scorer(), "sparse")

    # ---- untrained dense baseline ------------------------------------------
    state0 = init_train_state(0, cfg, device=device)
    run_stage2(ContrastiveSentenceScorer(cfg, feat, state0), "dense_untrained")

    # ---- trained variants ----------------------------------------------------
    docs = list(wiki.sentences.values())
    sims = {}

    def train_variant(mode, tag, stem=False, loss=None):
        sim = None
        if mode == "tf_idf":
            if stem not in sims:
                t0 = time.time()
                sims[stem] = sentence_pair_similarity(docs, stem=stem)
                results[f"similarity_prep{'_stem' if stem else ''}_s"] = round(
                    time.time() - t0, 1
                )
            sim = sims[stem]
        run_cfg = cfg
        if loss is not None:
            run_cfg = proto_config(cfg, loss, args.docs, args.steps)
        sampler = DocPairSampler(docs, sample=mode, similarity=sim, seed=7)
        with tempfile.TemporaryDirectory() as td:
            tr = ContrastiveTrainer(
                run_cfg, feat, sampler, ckptdir=td + "/c", logdir=td + "/l",
                device=device,
            )
            t0 = time.time()
            state = tr.train(total_steps=args.steps, log_step=10**9)
            results[f"train_{tag}_s"] = round(time.time() - t0, 1)
            if tr.refresh_count:
                results[f"cluster_refresh_s_{tag}"] = round(tr.refresh_seconds, 1)
                results[f"cluster_refreshes_{tag}"] = tr.refresh_count
        run_stage2(ContrastiveSentenceScorer(run_cfg, feat, state), f"dense_{tag}")

    train_variant("augment", "augment")
    train_variant("uniform", "uniform")
    train_variant("tf_idf", "tf_idf")
    if not args.skip_stem_ab:
        # A/B: lemma-ish (suffix-stripped) similarity feature space vs hashed
        train_variant("tf_idf", "tf_idf_stem", stem=True)
    if not args.skip_proto:
        # ProtoNCE / HProtoNCE end to end (uniform pairs, so the delta
        # against dense_uniform isolates the prototype loss term)
        train_variant("uniform", "proto", loss="ProtoNCE")
        train_variant("uniform", "hproto", loss="HProtoNCE")

    print(json.dumps({"results": results, "recall_sweep": sweep}), flush=True)
    write_results(args.out, args, results, sweep, device)
    return results, sweep


def write_results(path, args, results, sweep, device):
    begin, end = marks(args.featurizer)
    body = [
        f"Synthetic FEVER-like corpus: {args.docs} docs, {args.claims} dev "
        f"claims; hashed-bigram index 2^24 buckets; featurizer = "
        f"{args.featurizer}; contrastive encoder = reference shapes "
        f"(768 -> BiLSTM 3x256 bi -> 128, masked mean), "
        f"{args.steps} steps @ effective batch 256.",
        "",
        "| metric | value |",
        "|---|---|",
    ]
    body += [f"| {k} | {v} |" for k, v in results.items()]
    body += [
        "",
        "Stage-2 variants: `sparse` = per-claim tf-idf sentence scorer (no "
        "dense model), `dense_untrained` = random-init encoder, "
        "`dense_uniform` = reference-style doc-pair training, `dense_tf_idf` "
        "= similarity-weighted pairs (the reference's TFIDF-CL), "
        "`dense_tf_idf_stem` = same with suffix-stripped (lemma-ish) "
        "similarity features, `dense_augment` = query->sentence augmented "
        "pairs.",
        "",
        "### Recall@k sweep (report Fig. 2 analogue)",
        "",
        "`doc_tfidf` = stage-1 document recall; other rows = two-stage "
        "sentence recall with that stage-2 scorer.",
        "",
        "| variant | " + " | ".join(f"k={k}" for k in KS) + " |",
        "|---|" + "---|" * len(KS),
    ]
    for tag, row in sweep.items():
        body.append(f"| {tag} | " + " | ".join(str(row[k]) for k in KS) + " |")
    return write_section(path, begin, end, body, device)


if __name__ == "__main__":
    main()
