"""Stage-2 dense sentence scorers backed by the contrastive encoder.

Counterpart of ``ircl_tpu/pipeline/dense_scorer.py``. The reference left
dense re-ranking commented out in its predict path
(``src/evaluation.py:105-116``: claim/evidence cosine via ``ctx2vec``).
Here claims and candidate sentences embed through the query encoder, and a
score is the cosine, the dot of two L2-normalized rows, on the host.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from ircl_tpu_torch.contrastive.state import TrainConfig, TrainState
from ircl_tpu_torch.contrastive.train import make_embed_fn
from ircl_tpu_torch.dense.embed import embed_corpus


def _score_by_embed(
    embed: Callable[[Sequence[str]], np.ndarray],
    claims: Sequence[str],
    candidates: Sequence[Sequence[str]],
) -> List[np.ndarray]:
    """SentenceScorer protocol body: embed claims + flattened candidates,
    cosine = dot of the L2-normalized rows. Shared by the on-the-fly and
    precomputed scorers (the latter only for texts outside its table)."""
    claim_emb = embed(list(claims))
    flat = [s for cand in candidates for s in cand]
    if not flat:
        return [np.empty(0, np.float32) for _ in candidates]
    sent_emb = embed(flat)
    out: List[np.ndarray] = []
    pos = 0
    for ci, cand in enumerate(candidates):
        n = len(cand)
        if n == 0:
            out.append(np.empty(0, np.float32))
            continue
        out.append(sent_emb[pos : pos + n] @ claim_emb[ci])
        pos += n
    return out


class ContrastiveSentenceScorer:
    """Embeds claims and candidate sentences on every call, with the query
    encoder of ``state`` (a ``TrainState`` on the featurizer's device)."""

    def __init__(self, config: TrainConfig, featurizer, state: TrainState,
                 batch_size: int = 256):
        self.config = config
        self.featurizer = featurizer
        self.params = state.params_q
        self.embed_fn = make_embed_fn(config, featurizer)
        self.batch_size = batch_size

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        return embed_corpus(
            self.embed_fn, self.params, self.featurizer, texts, self.batch_size
        )

    def __call__(
        self, claims: Sequence[str], candidates: Sequence[Sequence[str]]
    ) -> List[np.ndarray]:
        return _score_by_embed(self.embed, claims, candidates)


class PrecomputedSentenceScorer:
    """Stage-2 scorer over an offline sentence-embedding table.

    Every corpus sentence is embedded once at build (the ``embed_corpus``
    sweep) into an ``[S, D]`` table; per request, stage 2 is the claims'
    embed plus a row gather and dot per claim on the host. Scores equal the
    on-the-fly scorer's up to embed-batch padding (rows are independent of
    their batch: pinned shapes, row-wise ops).

    ``score_keys`` is the fast path, keyed by the (doc_id, sent_id) pairs
    ``gather_candidates`` produces; ``serve.RetrievalService`` and
    ``pipeline.retrieve`` use it when present. ``__call__`` embeds texts
    outside the table on the fly.
    """

    def __init__(
        self,
        embed: Callable[[Sequence[str]], np.ndarray],
        doc_sentences: Dict[str, List[str]],
        table: np.ndarray = None,
    ):
        """``table``: optionally a previously built [S, D] table; S must
        match the non-empty sentence count of ``doc_sentences`` in its
        iteration order, the order ``__init__`` embeds in."""
        self._embed = embed
        self._row: Dict[Tuple[str, int], int] = {}
        flat: List[str] = []
        for d, sents in doc_sentences.items():
            for si, s in enumerate(sents):
                if s:
                    self._row[(d, si)] = len(flat)
                    flat.append(s)
        if table is not None:
            if table.shape[0] != len(flat):
                raise ValueError(
                    f"preloaded table has {table.shape[0]} rows, "
                    f"doc_sentences has {len(flat)} non-empty sentences"
                )
            self.table = table
        else:
            self.table = (
                embed(flat) if flat else np.empty((0, 0), np.float32)
            )  # [S, D] L2-normalized

    @classmethod
    def from_scorer(
        cls,
        scorer: ContrastiveSentenceScorer,
        doc_sentences: Dict[str, List[str]],
    ) -> "PrecomputedSentenceScorer":
        return cls(scorer.embed, doc_sentences)

    def score_keys(
        self,
        claims: Sequence[str],
        cand_keys: Sequence[Sequence[Tuple[str, int]]],
    ) -> List[np.ndarray]:
        """Per claim, scores for its (doc_id, sent_id) candidate keys. An
        unknown key is a caller bug and raises KeyError rather than scoring
        the wrong row."""
        claim_emb = self._embed(list(claims))
        out: List[np.ndarray] = []
        for ci, keys in enumerate(cand_keys):
            if not keys:
                out.append(np.empty(0, np.float32))
                continue
            rows = self.table[[self._row[k] for k in keys]]
            out.append(rows @ claim_emb[ci])
        return out

    def __call__(
        self, claims: Sequence[str], candidates: Sequence[Sequence[str]]
    ) -> List[np.ndarray]:
        return _score_by_embed(self._embed, claims, candidates)
