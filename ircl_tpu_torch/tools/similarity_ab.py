"""A/B of the port: hashed-surface against lemma-ish similarity feature
space for TFIDF-CL.

    python3 -m ircl_tpu_torch.tools.similarity_ab [--docs 2000 --claims 300
        --steps 1500 --inflect 0.3 --out RESULTS_TORCH.md --device cpu]

The port of ``scripts/similarity_ab.py``, with its arguments, defaults, seeds
and order of work. The pair-similarity feature space is hashed surface
ngrams, where the reference's original used NLTK-lemmatized tf-idf
(``PARITY.md``). On a corpus with morphological surface variation
(``generate(inflect_prob=...)``) this measures:

1. the pair-ordering divergence between the two similarity spaces,
2. TFIDF-CL sentence recall@5 and claim-evidence cosine trained with each.

Runs on the card unless ``--device`` names another device. Writes the
section between the ``<!-- ab:begin/end -->`` markers of ``--out`` and
prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

from ircl_tpu_torch.contrastive.state import TrainConfig
from ircl_tpu_torch.contrastive.trainer import ContrastiveTrainer
from ircl_tpu_torch.corpus.store import MemoryDocStore
from ircl_tpu_torch.corpus.synthetic import generate
from ircl_tpu_torch.data.pairs import DocPairSampler
from ircl_tpu_torch.data.similarity import sentence_pair_similarity
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.models.encoder import EncoderConfig
from ircl_tpu_torch.models.featurizer import FeaturizerConfig, HashEmbedFeaturizer
from ircl_tpu_torch.pipeline.dense_scorer import ContrastiveSentenceScorer
from ircl_tpu_torch.pipeline.intrinsic import mean_claim_evidence_cosine
from ircl_tpu_torch.pipeline.recall import sentence_recall_at_k
from ircl_tpu_torch.pipeline.retrieve import retrieve
from ircl_tpu_torch.tools.results import write_section
from ircl_tpu_torch.utils.device import resolve_device

MARK_BEGIN = "<!-- ab:begin -->"
MARK_END = "<!-- ab:end -->"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--claims", type=int, default=300)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--inflect", type=float, default=0.3)
    ap.add_argument("--out", default="RESULTS_TORCH.md")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def build_corpus(docs: int, claims: int, inflect: float, device):
    """The inflected corpus of seed 42, the stage-1 ranker over its
    hashed-bigram index (2^22 buckets) and its per-doc sentence lists:
    ``(wiki, claims_text, ranker, docs)``."""
    wiki = generate(num_docs=docs, num_claims=claims, inflect_prob=inflect, seed=42)
    claims_text = [c.claim for c in wiki.claims]
    store = MemoryDocStore({d: r["text"] for d, r in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=1 << 22))
    ranker = TfidfRanker(index, device)
    return wiki, claims_text, ranker, list(wiki.sentences.values())


def divergence(sim_surface, sim_stem):
    """Shares of the docs with pairs whose top pair, and whose pair order,
    differ between the two similarity spaces."""
    top_changed = 0
    order_changed = 0
    eligible = 0
    for a, b in zip(sim_surface, sim_stem):
        if not a:
            continue
        eligible += 1
        if a[0][0] != b[0][0]:
            top_changed += 1
        if [p for p, _ in a] != [p for p, _ in b]:
            order_changed += 1
    return (round(top_changed / max(eligible, 1), 4),
            round(order_changed / max(eligible, 1), 4))


def train_config() -> TrainConfig:
    return TrainConfig(
        encoder=EncoderConfig(masked_mean=True),
        micro_batch=128,
        accum_steps=2,
        queue_start_steps=300,
        learning_rate=2.5e-4,
    )


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    wiki, claims_text, ranker, docs = build_corpus(
        args.docs, args.claims, args.inflect, device)

    res = {
        "docs": args.docs,
        "claims": args.claims,
        "inflect_prob": args.inflect,
        "steps": args.steps,
    }

    # -- similarity spaces + divergence ---------------------------------------
    t0 = time.time()
    sim_surface = sentence_pair_similarity(docs)
    sim_stem = sentence_pair_similarity(docs, stem=True)
    res["similarity_prep_s"] = round(time.time() - t0, 1)
    res["docs_top_pair_changed"], res["docs_ordering_changed"] = divergence(
        sim_surface, sim_stem)

    # -- train TFIDF-CL with each space ----------------------------------------
    feat = HashEmbedFeaturizer(FeaturizerConfig(dim=768, max_len=32), device=device)
    cfg = train_config()

    for tag, sim in (("surface", sim_surface), ("stem", sim_stem)):
        sampler = DocPairSampler(docs, sample="tf_idf", similarity=sim, seed=7)
        with tempfile.TemporaryDirectory() as td:
            tr = ContrastiveTrainer(
                cfg, feat, sampler, ckptdir=td + "/c", logdir=td + "/l",
                device=device,
            )
            t0 = time.time()
            state = tr.train(total_steps=args.steps, log_step=10**9)
            res[f"train_{tag}_s"] = round(time.time() - t0, 1)
        scorer = ContrastiveSentenceScorer(cfg, feat, state)
        r = retrieve(
            claims_text, ranker, wiki.sentences, scorer,
            k_docs=5, k_sents=5, batch_size=256,
        )
        res[f"sentence_recall@5_{tag}"] = round(
            sentence_recall_at_k(wiki.claims, r.sentences, k=5), 4
        )
        cos = mean_claim_evidence_cosine(scorer.embed, wiki.claims, wiki.sentences)
        res[f"cosine_{tag}"] = round(cos["mean_cosine"], 4)

    print(json.dumps(res), flush=True)

    lines = [
        "## Similarity feature-space A/B (hashed surface vs lemma-ish)",
        "",
        f"Corpus with morphological variation (inflect_prob="
        f"{args.inflect}, {args.docs} docs): the tf_idf pair sampler driven "
        "by hashed-surface-ngram similarity vs suffix-stripped (lemma-ish) "
        "similarity — quantifying the framework's documented deviation from "
        "the reference's NLTK-lemma tf-idf (PARITY.md).",
        "",
        "| metric | value |",
        "|---|---|",
    ]
    lines += [f"| {k} | {v} |" for k, v in res.items()]
    write_section(args.out, MARK_BEGIN, MARK_END, lines, device)
    return res


if __name__ == "__main__":
    main()
