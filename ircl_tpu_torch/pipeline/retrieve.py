"""Two-stage evidence retrieval: sparse doc candidates -> sentence re-rank.

Counterpart of ``ircl_tpu/pipeline/retrieve.py``, over the port's
``TfidfRanker``:

  stage 1: ``TfidfRanker.closest_docs_batch`` -> top-k_docs doc ids per claim
  stage 2: the candidate sentences of those docs, scored by a pluggable
           ``SentenceScorer`` (dense contrastive cosine, or a sparse tf-idf
           fallback) -> top-k_sents (doc_id, sent_id) pairs per claim.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Protocol, Sequence, Tuple

import numpy as np

from ircl_tpu_torch.corpus.fever import nfkd as _nfkd
from ircl_tpu_torch.corpus.filters import normalize as _nfd
from ircl_tpu_torch.index.ranker import TfidfRanker


class SentenceScorer(Protocol):
    def __call__(
        self, claims: Sequence[str], candidates: Sequence[Sequence[str]]
    ) -> List[np.ndarray]:
        """Per claim, scores for its candidate sentence list."""
        ...


@dataclass
class RetrievalResult:
    doc_ids: List[List[str]]  # per claim, ranked top docs
    doc_scores: List[np.ndarray]
    sentences: List[List[Tuple[str, int]]]  # per claim, ranked (doc, sent_id)
    sentence_scores: List[np.ndarray]


def sparse_sentence_scorer(ranker_factory: Callable[[Sequence[str]], "object"]):
    """Fallback stage-2 scorer: per-claim tf-idf over candidate sentences,
    through a ranker's ``dense_scores_batch`` (the port's ``TfidfRanker``
    raises for it until ROADMAP.md queue 1 item 6)."""

    def score(claims, candidates):
        out = []
        for claim, sents in zip(claims, candidates):
            if not sents:
                out.append(np.empty(0, dtype=np.float32))
                continue
            r = ranker_factory(sents)
            out.append(r.dense_scores_batch([claim])[0])
        return out

    return score


def host_sparse_scorer(hash_size: int = 1 << 18, ngram: int = 2):
    """Host-numpy stage-2 sparse scorer with the ranker's exact weighting
    (log1p(tf) * RSJ idf both sides, ``index/tfidf.py``), idf fitted per
    candidate set. Device-free."""
    from ircl_tpu_torch.index.build import doc_to_hashed_counts
    from ircl_tpu_torch.index.tfidf import idf_vector

    def score(claims, candidates):
        out = []
        for claim, sents in zip(claims, candidates):
            if not sents:
                out.append(np.empty(0, dtype=np.float32))
                continue
            rows = [doc_to_hashed_counts(s, ngram, hash_size) for s in sents]
            df = np.zeros(hash_size, np.int32)
            for b, _ in rows:
                df[b] += 1
            idf = idf_vector(df, len(sents))
            qb, qc = doc_to_hashed_counts(claim, ngram, hash_size)
            qw = np.log1p(qc.astype(np.float32)) * idf[qb]
            lut = {int(b): float(w) for b, w in zip(qb, qw)}
            out.append(
                np.array(
                    [
                        sum(
                            lut.get(int(b), 0.0)
                            * np.log1p(float(c))
                            * idf[int(b)]
                            for b, c in zip(bs, cs)
                        )
                        for bs, cs in rows
                    ],
                    dtype=np.float32,
                )
            )
        return out

    return score


def gather_candidates(
    all_doc_ids: Sequence[List[str]],
    doc_sentences: Dict[str, List[str]],
) -> Tuple[List[List[str]], List[List[Tuple[str, int]]]]:
    """Per claim: candidate sentences of its retrieved docs, plus their
    (doc_id, sent_id) keys. Shared by ``retrieve`` and the serving surface
    (``serve.py``)."""
    cand_sents: List[List[str]] = []
    cand_keys: List[List[Tuple[str, int]]] = []
    for ids in all_doc_ids:
        sents, keys = [], []
        for d in ids:
            # ranker ids are store (NFD) ids, but callers may pass a
            # doc_sentences keyed differently: try both normalizations
            d_sents = (
                doc_sentences.get(d)
                or doc_sentences.get(_nfkd(d))
                or doc_sentences.get(_nfd(d))
                or []
            )
            for si, s in enumerate(d_sents):
                if s:
                    sents.append(s)
                    keys.append((d, si))
        cand_sents.append(sents)
        cand_keys.append(keys)
    return cand_sents, cand_keys


def retrieve(
    claims: Sequence[str],
    doc_ranker: TfidfRanker,
    doc_sentences: Dict[str, List[str]],
    sentence_scorer: SentenceScorer,
    k_docs: int = 5,
    k_sents: int = 5,
    batch_size: int = 64,
) -> RetrievalResult:
    """Run the two-stage pipeline over a claim list."""
    all_doc_ids: List[List[str]] = []
    all_doc_scores: List[np.ndarray] = []
    for i in range(0, len(claims), batch_size):
        batch = list(claims[i : i + batch_size])
        for ids, scores in doc_ranker.closest_docs_batch(batch, k=k_docs):
            all_doc_ids.append(ids)
            all_doc_scores.append(scores)

    cand_sents, cand_keys = gather_candidates(all_doc_ids, doc_sentences)

    if hasattr(sentence_scorer, "score_keys"):
        # precomputed-table scorer: candidates come from this same
        # doc_sentences, so score by key (gather + dot, no re-embedding)
        scores = sentence_scorer.score_keys(claims, cand_keys)
    else:
        scores = sentence_scorer(claims, cand_sents)

    top_sentences: List[List[Tuple[str, int]]] = []
    top_scores: List[np.ndarray] = []
    for keys, sc in zip(cand_keys, scores):
        if len(keys) == 0:
            top_sentences.append([])
            top_scores.append(np.empty(0, dtype=np.float32))
            continue
        order = np.argsort(-sc)[:k_sents]
        top_sentences.append([keys[j] for j in order])
        top_scores.append(np.asarray(sc)[order])

    return RetrievalResult(
        doc_ids=all_doc_ids,
        doc_scores=all_doc_scores,
        sentences=top_sentences,
        sentence_scores=top_scores,
    )
