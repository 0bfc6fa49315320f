"""Contrastive pair sampling: the reference's ``DocDataset`` as a host-side
batch generator.

Counterpart of ``ircl_tpu/data/pairs.py``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package.

Reference semantics (``src/dataset.py:73-101`` + ``get_dataloader``
shuffle/drop_last):

- ``uniform``: two distinct sentences drawn from a document.
- ``tf_idf``: a pair drawn from the top ``ceil(len(pairs) * 0.1)`` most
  tf-idf-similar intra-doc sentence pairs (precomputed by
  ``data/similarity.py``); single-sentence docs yield the ``(0, 0)``
  self-pair, as the reference's similarity file does.
- ``augment`` (ours, not in the reference): anchor = a claim-like degraded
  view of a sentence (random contiguous word crop + word dropout), positive =
  the full sentence. Trains query->sentence alignment directly, which is what
  stage-2 dense re-ranking actually consumes.

Docs are visited in shuffled epochs without replacement (the reference's
``DataLoader(shuffle=True, drop_last=True)``), so every eligible document is
seen once per epoch. Batches are assembled on the host (1 CPU core: the
tokenize+hash work here overlaps the TPU step through JAX async dispatch) and
shaped ``[accum, micro, L]`` for the scanned micro-batch train step
(``contrastive/train.py::make_train_step``).
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ircl_tpu_torch.data.similarity import PairScores


class DocPairSampler:
    """Samples (anchor, positive) sentence pairs from a sentence-split corpus.

    ``docs``: one list of sentences per document. Indexing is preserved —
    ``similarity[i]`` and cluster assignments (``trainer._refresh_clusters``)
    both key on the position in ``docs``.
    """

    def __init__(
        self,
        docs: Sequence[Sequence[str]],
        sample: str = "uniform",
        similarity: Optional[List[PairScores]] = None,
        seed: int = 0,
        ratio: float = 0.1,
    ):
        if sample not in ("uniform", "tf_idf", "augment"):
            raise ValueError(f"unknown sample mode: {sample!r}")
        if sample == "tf_idf" and similarity is None:
            raise ValueError("sample='tf_idf' requires a similarity list")
        self.docs: List[List[str]] = [list(d) for d in docs]
        self.sample = sample
        self.similarity = similarity
        self.ratio = ratio  # reference: DocDataset.ratio = 0.1
        self.rng = np.random.default_rng(seed)

        if sample == "uniform":
            ok = lambda i, d: len(d) >= 2
        elif sample == "tf_idf":
            ok = lambda i, d: len(similarity[i]) > 0
        else:  # augment: any doc with one non-empty sentence
            ok = lambda i, d: any(s.split() for s in d)
        self._eligible = np.array(
            [i for i, d in enumerate(self.docs) if ok(i, d)], dtype=np.int64
        )
        if len(self._eligible) == 0:
            raise ValueError(f"no documents eligible for sample={sample!r}")
        self._epoch: np.ndarray = np.empty(0, dtype=np.int64)
        self._cursor = 0

    # -- doc stream (shuffled epochs, no replacement) ------------------------

    def _next_doc_indices(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.int64)
        filled = 0
        while filled < n:
            if self._cursor >= len(self._epoch):
                self._epoch = self.rng.permutation(self._eligible)
                self._cursor = 0
            take = min(n - filled, len(self._epoch) - self._cursor)
            out[filled : filled + take] = self._epoch[
                self._cursor : self._cursor + take
            ]
            self._cursor += take
            filled += take
        return out

    # -- pair draws -----------------------------------------------------------

    def _draw(self, di: int) -> Tuple[str, str]:
        doc = self.docs[di]
        if self.sample == "uniform":
            i, j = self.rng.choice(len(doc), size=2, replace=False)
            return doc[int(i)], doc[int(j)]
        if self.sample == "tf_idf":
            pairs = self.similarity[di]
            k = max(1, math.ceil(len(pairs) * self.ratio))
            (i, j), _ = pairs[int(self.rng.integers(k))]
            return doc[i], doc[j]
        # augment
        nonempty = [s for s in doc if s.split()]
        sent = nonempty[int(self.rng.integers(len(nonempty)))]
        return self._augment(sent), sent

    def _augment(self, sentence: str) -> str:
        """Claim-like view: random contiguous crop + light word dropout."""
        words = sentence.split()
        n = len(words)
        if n <= 3:
            return sentence
        # crop to a contiguous window of 50-90% of the words
        span = max(3, int(self.rng.integers(n // 2, n)))
        start = int(self.rng.integers(0, n - span + 1))
        kept = words[start : start + span]
        if len(kept) > 4:
            keep = self.rng.random(len(kept)) >= 0.1
            keep[0] = True  # never empty
            kept = [w for w, k in zip(kept, keep) if k]
        return " ".join(kept)

    def sample_pairs(
        self, n: int
    ) -> Tuple[np.ndarray, List[str], List[str]]:
        """Draw ``n`` pairs -> (doc indices [n], anchors, positives)."""
        idxs = self._next_doc_indices(n)
        anchors, positives = [], []
        for di in idxs:
            a, p = self._draw(int(di))
            anchors.append(a)
            positives.append(p)
        return idxs, anchors, positives

    # -- batch assembly ---------------------------------------------------------

    def batches(
        self, featurizer, accum_steps: int, micro_batch: int, num_steps: int
    ) -> Iterator[tuple]:
        """Yields ``num_steps`` train-step inputs:
        ``(doc_idx [A, B], ids_a, mask_a, ids_k, mask_k)`` with id/mask
        arrays shaped ``[A, B, L]`` (A=accum_steps, B=micro_batch)."""
        A, B = accum_steps, micro_batch
        L = featurizer.config.max_len
        for _ in range(num_steps):
            idxs, anchors, positives = self.sample_pairs(A * B)
            ids_a, mask_a = featurizer.encode_host(anchors)
            ids_k, mask_k = featurizer.encode_host(positives)
            yield (
                idxs.reshape(A, B),
                ids_a.reshape(A, B, L),
                mask_a.reshape(A, B, L),
                ids_k.reshape(A, B, L),
                mask_k.reshape(A, B, L),
            )
