"""Recall@k evaluation for FEVER-style evidence retrieval.

Counterpart of ``ircl_tpu/pipeline/recall.py``, carried over line for line
over the port's ``corpus/fever.py``; host code only.

The reference never computes recall numerically (report.pdf Fig. 2 is chart
only — see SURVEY.md section 6); the north-star metric is FEVER dev
doc recall@5 / sentence recall@5, so this harness is the framework's judged
measurement path.

Semantics: a claim counts as covered at k ("any" mode, the standard FEVER
oracle-recall convention) if at least one gold evidence document (resp.
(document, sentence) pair) appears in the top-k retrieved; "full" mode
requires at least one complete evidence annotation to be covered —
per-annotation when ``Claim.evidence_sets`` carries the real annotation
structure (``parse_claims_jsonl`` does), otherwise conservatively treating
ALL flattened evidence as one annotation. Doc ids are compared
NFKD-normalized, matching the evidence normalization of the reference
(``src/dataset.py:55``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

from ircl_tpu_torch.corpus.fever import Claim, nfkd


def _annotations(claim: Claim):
    """Per-annotation (doc, sent_id) lists; single flattened annotation when
    the producer carried no structure (see Claim.evidence_sets)."""
    if claim.evidence_sets:
        return [
            [(nfkd(d), int(s)) for d, s in ann] for ann in claim.evidence_sets
        ]
    return [
        [
            (nfkd(d), int(s))
            for d, sids in claim.evidences.items()
            for s in sids
        ]
    ]


def doc_recall_at_k(
    claims: Sequence[Claim],
    retrieved: Sequence[Sequence[str]],
    k: int = 5,
    mode: str = "any",
) -> float:
    """Fraction of claims whose gold evidence docs appear in top-k.

    ``retrieved[i]`` is the ranked doc-id list for ``claims[i]``.
    Claims with no evidence annotations are skipped.
    """
    assert len(claims) == len(retrieved)
    hit = 0
    total = 0
    for claim, docs in zip(claims, retrieved):
        gold = {nfkd(d) for d in claim.evidences}
        if not gold:
            continue
        total += 1
        top = [nfkd(d) for d in list(docs)[:k]]
        top_set = set(top)
        if mode == "any":
            if gold & top_set:
                hit += 1
        elif mode == "full":
            # at least one annotation has ALL its docs retrieved
            if any(
                {d for d, _ in ann} <= top_set for ann in _annotations(claim)
            ):
                hit += 1
        else:
            raise ValueError(f"invalid mode: {mode}")
    return hit / total if total else 0.0


def sentence_recall_at_k(
    claims: Sequence[Claim],
    retrieved: Sequence[Sequence[Tuple[str, int]]],
    k: int = 5,
    mode: str = "any",
) -> float:
    """Fraction of claims with a gold (doc, sent_id) pair in top-k sentences.

    ``retrieved[i]`` is a ranked list of (doc_id, sent_id) pairs.
    """
    assert len(claims) == len(retrieved)
    hit = 0
    total = 0
    for claim, sents in zip(claims, retrieved):
        gold = {
            (nfkd(d), int(s)) for d, sids in claim.evidences.items() for s in sids
        }
        if not gold:
            continue
        total += 1
        top = {(nfkd(d), int(s)) for d, s in list(sents)[:k]}
        if mode == "any":
            if gold & top:
                hit += 1
        elif mode == "full":
            # at least one annotation has ALL its (doc, sent) pairs
            # retrieved (the previous per-doc approximation marked a
            # multi-doc annotation covered from one doc alone)
            covered = any(
                all(pair in top for pair in ann)
                for ann in _annotations(claim)
            )
            if covered:
                hit += 1
        else:
            raise ValueError(f"invalid mode: {mode}")
    return hit / total if total else 0.0
