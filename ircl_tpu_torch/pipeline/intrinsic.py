"""Intrinsic embedding-quality metrics.

Counterpart of ``ircl_tpu/pipeline/intrinsic.py``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package.

The reference's Table 1 (report.pdf section 4.2.2; see BASELINE.md) compares
mean cosine similarity between each claim and its ground-truth evidence
sentence embedding across methods (TF-IDF 0.022, Uniform-CL -0.008,
TFIDF-CL 0.428). This module measures the same quantity for any embedding
function, plus the shuffled-control variant the reference prints in its
commented-out predict block (``src/evaluation.py:110-116``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ircl_tpu_torch.corpus.fever import Claim, nfkd


def claim_evidence_pairs(
    claims: Sequence[Claim], doc_sentences: Dict[str, List[str]]
) -> tuple:
    """(claim_texts, gold evidence sentence texts), one pair per claim using
    its first resolvable gold (doc, sent)."""
    ctexts, etexts = [], []
    for c in claims:
        found = None
        for doc_id, sids in c.evidences.items():
            sents = doc_sentences.get(nfkd(doc_id)) or doc_sentences.get(doc_id)
            if not sents:
                continue
            for s in sids:
                if 0 <= s < len(sents) and sents[s]:
                    found = sents[s]
                    break
            if found:
                break
        if found:
            ctexts.append(c.claim)
            etexts.append(found)
    return ctexts, etexts


def mean_claim_evidence_cosine(
    embed_fn, claims: Sequence[Claim], doc_sentences: Dict[str, List[str]],
    shuffled_control: bool = True, seed: int = 0,
) -> Dict[str, float]:
    """Mean cos(claim, gold evidence) for an embedding callable
    (texts -> [N, D] L2-normalized), plus a shuffled-evidence control."""
    ctexts, etexts = claim_evidence_pairs(claims, doc_sentences)
    if not ctexts:
        return {"mean_cosine": 0.0, "shuffled_cosine": 0.0, "pairs": 0}
    ce = embed_fn(ctexts)
    ee = embed_fn(etexts)
    out = {
        "mean_cosine": float(np.mean(np.sum(ce * ee, axis=1))),
        "pairs": len(ctexts),
    }
    if shuffled_control:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(etexts))
        out["shuffled_cosine"] = float(np.mean(np.sum(ce * ee[perm], axis=1)))
    return out
