"""Verdict dataset prep: (claim, evidence-text) pairs -> token arrays.

Counterpart of ``ircl_tpu/verdict/data.py``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package.

Mirrors the reference's ``FeverDatasetTokenize`` assembly
(``src/QA/dataset.py:105-132``): evidence text is the doc-id words
(underscores split) followed by the gold evidence sentences, paired with the
claim and tokenized to ``max_length``. NOT-ENOUGH-INFO claims are dropped;
labels are SUPPORTS=1 / REFUTES=0 (``src/QA/dataset.py:77,90``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ircl_tpu_torch.corpus.fever import Claim, LABEL_MAP, nfkd
from ircl_tpu_torch.corpus.filters import normalize as _nfd
from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer


@dataclass
class VerdictExample:
    claim: str
    evidence_text: str
    label: int


def build_examples(
    claims: Sequence[Claim],
    doc_sentences: Dict[str, List[str]],
    evidence_override: Optional[Sequence[Sequence[Tuple[str, int]]]] = None,
) -> List[VerdictExample]:
    """Gold-evidence examples, or retrieved-evidence ones when
    ``evidence_override`` (per-claim (doc_id, sent_id) lists) is given —
    the extrinsic-evaluation path over retrieval output."""
    out = []
    for ci, claim in enumerate(claims):
        if claim.label not in LABEL_MAP:
            continue
        parts: List[str] = []
        if evidence_override is not None:
            ev = {}
            for d, s in evidence_override[ci]:
                ev.setdefault(d, []).append(s)
        else:
            ev = claim.evidences
        for doc_id, sent_ids in ev.items():
            parts.extend(doc_id.split("_"))
            # evidence ids are NFKD (reference flattening) while sentence
            # corpora key NFD store ids: try raw, then both normalizations
            # (compatibility characters differ) — same defense as
            # pipeline/intrinsic.py
            sents = (
                doc_sentences.get(doc_id)
                or doc_sentences.get(nfkd(doc_id))
                or doc_sentences.get(_nfd(doc_id))
                or []
            )
            for sid in sent_ids:
                if 0 <= sid < len(sents):
                    parts.append(sents[sid])
        out.append(
            VerdictExample(
                claim=claim.claim,
                evidence_text=" ".join(parts),
                label=LABEL_MAP[claim.label],
            )
        )
    return out


def encode_examples(
    examples: Sequence[VerdictExample],
    tokenizer: WordPieceTokenizer,
    max_length: int = 512,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    ids, mask, types = tokenizer.encode_batch(
        [(e.claim, e.evidence_text) for e in examples], max_length
    )
    labels = np.asarray([e.label for e in examples], np.int32)
    return ids, mask, types, labels
