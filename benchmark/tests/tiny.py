"""Tiny cells of each traffic kind for the CPU tests: the configurations'
files with their sizes cut, run through the harness on the CPU."""

from __future__ import annotations

import copy
import os

from benchmark import harness

ROOT = harness.ROOT
E2E = {
    "retrieve": ["setup_s", "retrieval_qps", "request_p95_ms"],
    "verify": ["setup_s", "verify_claims_per_s", "request_p95_ms"],
    "finetune": ["setup_s", "train_samples_per_s"],
}
PER_LAYER = {
    "retrieve": ["host_ms_per_batch.retrieve", "device_ms_per_batch.retrieve",
                 "scoring_gemm_roofline.retrieve", "mfu.retrieve", "idle_share.retrieve"],
    "verify": ["device_ms_per_batch.verify", "flash_fwd_roofline.verify", "mfu.verify",
               "idle_share.verify"],
    "finetune": ["device_ms_per_step.finetune", "flash_bwd_roofline.finetune", "mfu.finetune",
                 "idle_share.finetune"],
}
KINDS = ("retrieve_claims", "retrieve_terms", "verify", "finetune")


def _load(*parts):
    return harness.load_json(os.path.join(ROOT, *parts))


def _roberta(cfg: dict) -> dict:
    cfg["corpus"]["num_docs"] = 300
    cfg["roberta"].update(hidden_size=128, num_hidden_layers=3, num_attention_heads=4,
                          intermediate_size=512, vocab_size=1024, max_position_embeddings=130)
    cfg["verdict"]["max_length"] = 128
    cfg["wordpiece"]["vocab_size"] = 600
    cfg["train"]["batch"] = 4
    return cfg


def cell(kind: str) -> harness.Cell:
    """A tiny cell: ``retrieve_claims`` (text corpus, fused light path),
    ``retrieve_terms`` (synthetic postings), ``verify`` or ``finetune``."""
    if kind == "retrieve_claims":
        cfg = _load("configs", "fever50k.json")
        cfg["corpus"].update(num_docs=400, hash_size=1 << 20)
        cfg["ranker"]["fixed_union_cap"] = 512
        mix = _load("workloads", "retrieve_claims4096.json")
        mix.update(batch=64, pool_batches=3, sample_queries=64)
    elif kind == "retrieve_terms":
        cfg = _load("configs", "fever1m.json")
        cfg["corpus"].update(num_docs=3000, vocab=20000, hash_size=1 << 20)
        cfg["ranker"]["df_threshold"] = 32
        mix = _load("workloads", "retrieve_terms1024.json")
        mix.update(batch=64, pool_batches=3, sample_queries=64)
    elif kind == "verify":
        cfg = _roberta(_load("configs", "fever50k.json"))
        mix = _load("workloads", "verify_pairs32.json")
        mix.update(batch=4, pool_requests=4, vocab_docs=100)
    else:
        cfg = _roberta(_load("configs", "fever50k.json"))
        mix = _load("workloads", "finetune_pairs8.json")
        mix.update(pool_steps=8, vocab_docs=100)
    short = mix["kind"]
    return harness.Cell("tiny." + kind, copy.deepcopy(cfg), mix, 1,
                        [{"name": n, "unit": "u"} for n in E2E[short]],
                        [{"name": n, "unit": "u"} for n in PER_LAYER[short]])


def run(kind: str, seed: int = 2 ** 31 + 11, trace: bool = False, control: bool = False,
        seconds: float = 0.4) -> dict:
    return harness.run_cell(cell(kind), seed, seconds, trace, "cpu", control=control)
