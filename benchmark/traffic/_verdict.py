"""What the verdict drivers share: the pairs, the weights and the program's
configuration of the classifier, all from the cell's configuration."""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import log
from benchmark.reference import corpus as gen
from benchmark.reference import roberta
from benchmark.rooflines import verdict_model


class Pairs:
    """The pool of (claim, evidence) pairs and labels, drawn from the seed,
    and the corpus texts the WordPiece vocabulary is trained on."""

    def __init__(self, run, size: int):
        t = time.perf_counter()
        cfg = run.config
        corpus = gen.generate(cfg["corpus"]["num_docs"], seed=[run.seed, 1])
        claims = gen.draw_claims(corpus, size, seed=[run.seed, 2])
        self.claims = claims.texts
        self.labels = claims.labels
        self.evidence = gen.evidence_texts(corpus, claims.gold, seed=[run.seed, 3])
        self.vocab_texts = corpus.texts[: run.mix["vocab_docs"]]
        log(f"{size} pairs over {corpus.num_docs} docs in {time.perf_counter() - t:.2f}s")

    def slice(self, lo: int, hi: int):
        return self.claims[lo:hi], self.evidence[lo:hi]


def program_config(cfg: dict):
    """The port's ``VerdictConfig`` of the configuration's classifier."""
    import torch

    from ircl_tpu_torch.models.transformer import TransformerConfig
    from ircl_tpu_torch.verdict.model import VerdictConfig

    r, v, t = cfg["roberta"], cfg["verdict"], cfg["train"]
    enc = TransformerConfig(
        vocab_size=r["vocab_size"], hidden=r["hidden_size"], layers=r["num_hidden_layers"],
        heads=r["num_attention_heads"], intermediate=r["intermediate_size"],
        max_positions=r["max_position_embeddings"] - v["position_offset"],
        type_vocab=r["type_vocab_size"], layernorm_eps=r["layer_norm_eps"],
        position_offset=v["position_offset"], attention=v["attention"],
        dtype=getattr(torch, v["dtype"]))
    return VerdictConfig(encoder=enc, num_labels=r["num_labels"], learning_rate=t["learning_rate"],
                         warmup_steps=t["warmup_steps"], total_steps=t["total_steps"],
                         freeze_body_until_warmup=t["freeze_body_until_warmup"],
                         max_length=v["max_length"])


def weights(run):
    return roberta.init_params(run.config["roberta"], run.seed, run.device)


def lengths_histogram(lengths: np.ndarray, max_length: int) -> str:
    edges = sorted({1, max_length + 1} | {e for e in (65, 129, 257, 385, max_length)
                                          if e <= max_length})
    hist = np.histogram(lengths, bins=edges)[0]
    return " ".join(f"[{a},{b}):{int(h)}" for a, b, h in zip(edges[:-1], edges[1:], hist))


def request_work(run, lengths: np.ndarray) -> dict:
    """A request's work for the roofline and mfu readers: the real lengths
    of its rows at the pinned length."""
    return verdict_model.work(run.config, lengths)
