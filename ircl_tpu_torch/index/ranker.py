"""Batched TF-IDF document ranking on a PyTorch device.

Counterpart of ``ircl_tpu/index/ranker.py``. The same batch-first ranker:
all queries of a batch are vectorized on the host (tokenize/hash/tf-idf
weights) and scored together on the device. Three exact engines:

- ``"ell"``: doc-major membership slab + fp32 GEMM + top-k
  (``ops/membership_cuda.py``).
- ``"hybrid"``: df-split engine (``index/split`` + ``ops/hybrid``) — heavy
  terms through a small membership slab, light terms through host-gathered
  posting pools, exact merge. ``width_buckets=1`` at any size;
  ``width_buckets=2`` (the bench engine) takes the fused light-add kernel
  up to ``FUSED_LIGHT_MAX_DOCS`` and the staged engine
  (``hybrid_topk_bucketed``) past it or with ``select_rescore``.
- ``"ragged"``: term-major gather + sort + segment top-k (``ops/ragged``),
  posting-mass proportional, kept for validation; ``dense_scores_batch``
  runs on it in every mode.

Every ranker names its ``device``: tensors on a CUDA device run the
hand-written kernels, tensors on the CPU their plain versions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ircl_tpu_torch.corpus.fastpath import batch_vectorize
from ircl_tpu_torch.index.build import CountIndex
from ircl_tpu_torch.index.tfidf import idf_vector
from ircl_tpu_torch.ops import ragged
from ircl_tpu_torch.utils.profiling import span


def candidate_docs(
    index: CountIndex,
    queries: Sequence[str],
    bigram_only: bool = False,
) -> List[List[str]]:
    """Boolean candidate filtering: docs containing ANY query ngram.

    The reference's ``documents_filtering`` (``src/evaluation.py:57-84``):
    tokenize + hash the claim's 1..n-grams (optionally n>=2 only), take the
    posting union over those buckets, and return the matching doc ids.
    Host-side, as in ``ircl_tpu``. The default ``bigram_only=False`` follows
    the reference's one exercised call site (``src/evaluation.py:101``).
    """
    from ircl_tpu_torch.corpus.filters import filter_ngram, normalize
    from ircl_tpu_torch.corpus.hashing import hash_token
    from ircl_tpu_torch.corpus.tokenizer import default_tokenizer

    out: List[List[str]] = []
    tok = default_tokenizer()
    for q in queries:
        grams = tok.tokenize(normalize(q)).ngrams(
            n=index.ngram, uncased=True, filter_fn=filter_ngram
        )
        if bigram_only:
            grams = [g for g in grams if len(g.split()) > 1]
        docs: set = set()
        for w in {hash_token(g, index.hash_size) for g in grams}:
            s, e = int(index.indptr[w]), int(index.indptr[w + 1])
            docs.update(index.post_docs[s:e].tolist())
        out.append([index.doc_ids[d] for d in sorted(docs)])
    return out


def vectorize_queries(
    queries: Sequence[str],
    hash_size: int,
    ngram: int,
    doc_freqs: np.ndarray,
    num_docs: int,
    max_terms: Optional[int] = None,
    binary_tf: bool = False,
    idfs: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Queries -> padded (buckets [B, T], weights [B, T]).

    Weight semantics match reference ``text2spvec``
    (``tfidf_doc_ranker.py:92-126``): unique hashed ngrams, log1p(tf) * idf
    with clipped idf. ``binary_tf=True`` reproduces the reference's "BM25"
    ranker variant (tf = 1 per present term). Empty queries produce
    all-zero rows. Pads are bucket 0 with weight 0. Traced as the span
    ``ranker.vectorize``.
    """
    with span("ranker.vectorize"):
        if idfs is None:
            idfs = idf_vector(doc_freqs, num_docs)
        per_q = batch_vectorize(queries, hash_size, ngram)
        B = len(queries)
        lens = np.fromiter(
            (len(u) for u, _ in per_q), dtype=np.int64, count=B
        ) if B else np.empty(0, np.int64)
        T = max_terms or int(lens.max(initial=1)) or 1
        buckets = np.zeros((B, T), dtype=np.int32)
        weights = np.zeros((B, T), dtype=np.float32)
        if B and lens.sum():
            # Bulk run-expansion: every query's (uniq, counts) concatenated,
            # weights in one vectorized pass, scattered into the padded [B, T]
            # arrays by (row, position within the query), truncated at T.
            all_u = np.concatenate([u for u, _ in per_q])
            all_c = np.concatenate([c for _, c in per_q])
            all_w = (
                idfs[all_u].astype(np.float32)
                if binary_tf
                else np.log1p(all_c.astype(np.float32)) * idfs[all_u]
            )
            rows = np.repeat(np.arange(B, dtype=np.int64), lens)
            offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
            cols = np.arange(len(all_u), dtype=np.int64) - offsets[rows]
            keep = cols < T
            buckets[rows[keep], cols[keep]] = all_u[keep].astype(np.int32)
            weights[rows[keep], cols[keep]] = all_w[keep].astype(np.float32)
        return buckets, weights


def _put(x: np.ndarray, device) -> torch.Tensor:
    """Host array -> device tensor (a copy, never a view of ``x``)."""
    return torch.tensor(np.ascontiguousarray(x), device=device)


@dataclass
class DeviceIndex:
    """Device-resident postings (torch tensors), plus host-side metadata.
    The postings serve the ragged engine and ``dense_scores_batch``."""

    indptr: torch.Tensor  # [H+1] int32
    post_docs: torch.Tensor  # [nnz] int32
    post_vals: torch.Tensor  # [nnz] f32
    hash_size: int
    ngram: int
    num_docs: int
    doc_ids: List[str]
    doc_freqs: np.ndarray  # host, used for query idf

    @classmethod
    def from_count_index(cls, index: CountIndex, device) -> "DeviceIndex":
        if index.nnz >= 2**31 - 1:  # int32 indptr
            raise ValueError(f"{index.nnz} postings overflow an int32 indptr")
        return cls(
            indptr=_put(index.indptr.astype(np.int32), device),
            post_docs=_put(index.post_docs, device),
            post_vals=_put(index.post_vals, device),
            hash_size=index.hash_size,
            ngram=index.ngram,
            num_docs=index.num_docs,
            doc_ids=index.doc_ids,
            doc_freqs=index.doc_freqs.copy(),
        )


class TfidfRanker:
    """Batch top-k document ranking over a tf-idf weighted CountIndex.

    Arguments as in ``ircl_tpu.index.ranker.TfidfRanker``, except that
    ``device`` ("cuda", "cuda:0", "cpu", a ``torch.device``) is required.
    ``mode``: ``"ell"``, ``"hybrid"``, ``"ragged"`` or ``"auto"`` (ell at
    ``ELL_MAX_DOCS`` docs or fewer, hybrid beyond). ``precision``:
    "highest" and "high" score in full fp32, "default" allows TF32.
    ``select_rescore`` (staged bucketed engine only): >0 selects that many
    candidates a query from a bf16 scores product and rescores them exactly;
    the selection is approximate, so verify with a parity gate where
    certainty matters. 16-32 are sensible values.
    """

    # The reference's engine gates, kept for parity. Both were measured on
    # the TPU; deriving them again on the GPU is later work.
    ELL_MAX_DOCS = 20_000
    FUSED_LIGHT_MAX_DOCS = 200_000

    def __init__(
        self,
        index: CountIndex,
        device,
        binary_tf: bool = False,
        mode: str = "auto",
        fixed_union_cap: Optional[int] = None,
        fixed_max_terms: Optional[int] = None,
        df_threshold="auto",  # int, or "auto" (index/autotune.py)
        autotune_profile: Optional[dict] = None,
        precision: str = "highest",
        width_buckets: int = 1,
        d_tile: Optional[int] = None,
        split=None,  # prebuilt SplitIndex (index/split.py::load_split)
        select_rescore: int = 0,
        union_round: Optional[int] = None,
    ):
        from ircl_tpu_torch.ops.hybrid import _PREC

        if union_round is not None and (
            union_round <= 0 or union_round % 512
        ):
            raise ValueError(
                f"union_round must be a positive multiple of 512 (the slab "
                f"u-tile), got {union_round}"
            )
        self.select_rescore = int(select_rescore)
        if self.select_rescore and width_buckets != 2:
            raise ValueError(
                "select_rescore requires the bucketed hybrid engine "
                "(width_buckets=2) — it would be silently ignored otherwise"
            )
        if mode not in ("auto", "ell", "hybrid", "ragged"):
            raise ValueError(f"unknown mode {mode!r}")
        _PREC[precision]  # unknown names raise here, not at the first batch
        self.device = torch.device(device)
        self.union_round = union_round
        self.precision = precision
        # fixed_* pin the batch shapes for serving; a batch union exceeding
        # fixed_union_cap (a floor) grows to the next bucket.
        self.fixed_union_cap = fixed_union_cap
        self.fixed_max_terms = fixed_max_terms
        if not index.weighted and not binary_tf:
            from ircl_tpu_torch.index.tfidf import tfidf_transform

            index = tfidf_transform(index)
        self.dev = DeviceIndex.from_count_index(index, self.device)
        self.binary_tf = binary_tf
        self._idfs = idf_vector(index.doc_freqs, index.num_docs)
        if mode == "auto":
            mode = "ell" if index.num_docs <= self.ELL_MAX_DOCS else "hybrid"
        self.mode = mode
        if d_tile is None:
            d_tile = (
                512
                if mode == "hybrid"
                and index.num_docs > self.FUSED_LIGHT_MAX_DOCS
                else 1024
            )
        self.d_tile = d_tile
        self._ell_terms_t = self._ell_vals_t = None
        self._split = None
        self._bucketed = None
        put = lambda x: _put(x, self.device)  # noqa: E731
        if mode == "hybrid":
            from ircl_tpu_torch.index.split import bucket_heavy, split_index
            from ircl_tpu_torch.ops.membership_cuda import pad_for_slab

            if split is not None:
                if (
                    split.num_docs != index.num_docs
                    or split.hash_size != index.hash_size
                ):
                    raise ValueError(
                        f"prebuilt split does not match the index: "
                        f"docs {split.num_docs} vs {index.num_docs}, "
                        f"hash {split.hash_size} vs {index.hash_size}"
                    )
                df_threshold = split.df_threshold
            elif df_threshold == "auto":
                from ircl_tpu_torch.index.autotune import auto_df_threshold

                kw = dict(
                    max_terms=fixed_max_terms or 24,
                    union_floor=fixed_union_cap or 512,
                    union_round=union_round,
                )
                kw.update(autotune_profile or {})
                df_threshold = auto_df_threshold(index, **kw)
            self.df_threshold = df_threshold
            self._split = (
                split
                if split is not None
                else split_index(index, df_threshold=df_threshold)
            )
            if width_buckets == 2:
                # lcm(d_tile, 1024): the fused light path takes the largest
                # doc tile (1024/512/256) dividing the padded doc count. The
                # bucket cut MUST use the same tile as pad_for_slab below —
                # old2pos encodes bucket_b's concat offset as na_pad, and a
                # mismatched pad silently shifts every bucket_b doc id.
                pad_tile = math.lcm(d_tile, 1024)
                bk = bucket_heavy(self._split.heavy, d_tile=pad_tile)
                self._bucketed = bk
                ta, va = pad_for_slab(
                    np.ascontiguousarray(bk.ell_a.terms.T),
                    np.ascontiguousarray(bk.ell_a.vals.T),
                    d_tile=pad_tile,
                )
                tb, vb = pad_for_slab(
                    np.ascontiguousarray(bk.ell_b.terms.T),
                    np.ascontiguousarray(bk.ell_b.vals.T),
                    d_tile=pad_tile,
                )
                self._heavy_a = (put(ta), put(va))
                self._heavy_b = (put(tb), put(vb))
            else:
                tt, vt = pad_for_slab(
                    np.ascontiguousarray(self._split.heavy.terms.T),
                    np.ascontiguousarray(self._split.heavy.vals.T),
                    d_tile=math.lcm(d_tile, 256),
                )
                self._heavy_terms_t = put(tt)
                self._heavy_vals_t = put(vt)
        if mode == "ell":
            from ircl_tpu_torch.index.ell import to_ell
            from ircl_tpu_torch.ops.membership_cuda import pad_for_slab

            ell = to_ell(index)
            # k-major, tile-padded: the layout the slab kernel reads
            tt, vt = pad_for_slab(
                np.ascontiguousarray(ell.terms.T),
                np.ascontiguousarray(ell.vals.T),
                d_tile=256,
            )
            self._ell_terms_t = put(tt)
            self._ell_vals_t = put(vt)

    def get_doc_id(self, doc_index: int) -> str:
        return self.dev.doc_ids[doc_index]

    def _vectorize(self, queries: Sequence[str]):
        return vectorize_queries(
            queries,
            self.dev.hash_size,
            self.dev.ngram,
            self.dev.doc_freqs,
            self.dev.num_docs,
            max_terms=self.fixed_max_terms,
            binary_tf=self.binary_tf,
            idfs=self._idfs,
        )

    @staticmethod
    def _pow2(n: int, floor: int = 16) -> int:
        # Canonical implementation lives in index/autotune.py — the cost
        # model's u_pad/p_pad must mirror this bucketing exactly.
        from ircl_tpu_torch.index.autotune import _pow2

        return _pow2(n, floor)

    def _union_slots(
        self, buckets: np.ndarray, weights: np.ndarray, floor: int = 16
    ) -> np.ndarray:
        """Sorted union of the batch's live buckets, sentinel-padded to a
        power-of-two width (or a multiple of ``union_round``)."""
        nz = weights != 0.0
        u = np.unique(buckets[nz]) if nz.any() else np.empty(0, np.int64)
        if self.union_round is not None:
            r = self.union_round
            u_cap = -(-max(len(u), floor, 1) // r) * r
        else:
            u_cap = self._pow2(max(len(u), 1), floor=floor)
        sentinel = np.int32(min(self.dev.hash_size, 2**31 - 1))
        u_pad = np.full(u_cap, sentinel, dtype=np.int32)
        u_pad[: len(u)] = u.astype(np.int32)
        return u_pad

    def _closest_ell_async(self, queries: Sequence[str], k: int):
        """Dispatch ELL scoring; returns device tensors (no sync)."""
        from ircl_tpu_torch.ops.membership_cuda import (
            membership_topk_fused,
            pad_for_slab,
        )

        buckets, weights = self._vectorize(queries)
        u_pad = self._union_slots(
            buckets, weights, floor=self.fixed_union_cap or 512
        )
        qb_t, qw_t = pad_for_slab(
            np.ascontiguousarray(buckets.T.astype(np.int32)),
            np.ascontiguousarray(weights.T),
            d_tile=128,
        )
        put = lambda x: _put(x, self.device)  # noqa: E731
        return membership_topk_fused(
            self._ell_terms_t,
            self._ell_vals_t,
            put(u_pad),
            put(qb_t),
            put(qw_t),
            k=k,
            num_real_docs=self.dev.num_docs,
        )

    def _closest_hybrid_async(self, queries: Sequence[str], k: int):
        buckets, weights = self._vectorize(queries)
        return self.hybrid_from_vectors_async(buckets, weights, k)

    def hybrid_host_inputs(self, buckets: np.ndarray, weights: np.ndarray):
        """Host half of a hybrid batch, as numpy arrays: (u_pad [U], qb_t
        [T8, B_pad], qw_t [T8, B_pad], light docs [B, P], light contribs
        [B, P]). Pools are in the permuted doc space and doc-sorted when the
        ranker has width buckets. Traced as two spans: ``ranker.query_slab``
        (heavy terms, their union and the query slab rows) and
        ``ranker.light_pools`` (the light terms' posting pools)."""
        from ircl_tpu_torch.index.split import gather_light_pools
        from ircl_tpu_torch.ops.membership_cuda import pad_for_slab

        with span("ranker.query_slab"):
            heavy_q = self._split.doc_freqs[buckets] > self._split.df_threshold
            hw = np.where(heavy_q, weights, 0.0).astype(np.float32)
            u_pad = self._union_slots(
                buckets, hw, floor=self.fixed_union_cap or 512
            )
            # Per-query ascending term sort (pads trailing): the windowed
            # slab's precondition. Term order within a query does not change
            # scores.
            key = np.where(hw != 0.0, buckets, np.int32(2**31 - 1))
            order = np.argsort(key, axis=1, kind="stable")
            sb = np.take_along_axis(buckets, order, axis=1).astype(np.int32)
            sw = np.take_along_axis(hw, order, axis=1)
            sb = np.where(sw != 0.0, sb, -1)
            qb_t, qw_t = pad_for_slab(
                np.ascontiguousarray(sb.T),
                np.ascontiguousarray(sw.T),
                d_tile=128,
            )
        with span("ranker.light_pools"):
            if self._bucketed is not None:
                # Pools remapped to the permuted doc space and doc-sorted in
                # one C++ pass; pads carry an out-of-range position, so no
                # doc tile ever reads them.
                ld, lc, _ = gather_light_pools(
                    self._split,
                    buckets,
                    weights,
                    old2pos=self._bucketed.old2pos,
                    sort_pools=True,
                    pad_doc=len(self._bucketed.pos2old),
                )
            else:
                ld, lc, _ = gather_light_pools(self._split, buckets, weights)
        return u_pad, qb_t, qw_t, ld, lc

    def hybrid_from_vectors_async(
        self, buckets: np.ndarray, weights: np.ndarray, k: int
    ):
        """Hybrid scoring from prebuilt query vectors ([B, T] buckets +
        weights); returns device tensors (no sync)."""
        return self.hybrid_from_host_async(
            self.hybrid_host_inputs(buckets, weights), k
        )

    def hybrid_from_host_async(self, host, k: int):
        """The device half of a hybrid batch: ``hybrid_host_inputs``'
        arrays uploaded and scored; returns device tensors (no sync).
        Traced as two spans: ``ranker.upload`` (the five host-to-device
        copies) and ``ranker.launch`` (the engine's launches)."""
        from ircl_tpu_torch.ops.hybrid import (
            hybrid_topk,
            hybrid_topk_bucketed,
            hybrid_topk_bucketed_fused,
        )

        with span("ranker.upload"):
            u_pad, qb_t, qw_t, ld, lc = (_put(x, self.device) for x in host)
        with span("ranker.launch"):
            if self._bucketed is not None:
                kw = dict(
                    k=k,
                    precision=self.precision,
                    queries_sorted=True,
                    pools_sorted=True,  # the C++ gather sorted the pools
                    d_tile=self.d_tile,
                )
                # select_rescore lives in the staged engine (the fused kernel
                # never materializes the score matrix the option is about),
                # so it forces the staged path.
                if (
                    self.dev.num_docs <= self.FUSED_LIGHT_MAX_DOCS
                    and not self.select_rescore
                ):
                    return hybrid_topk_bucketed_fused(
                        *self._heavy_a, *self._heavy_b,
                        u_pad, qb_t, qw_t, ld, lc, **kw,
                    )
                return hybrid_topk_bucketed(
                    *self._heavy_a, *self._heavy_b,
                    u_pad, qb_t, qw_t, ld, lc,
                    select_rescore=self.select_rescore, **kw,
                )
            return hybrid_topk(
                self._heavy_terms_t,
                self._heavy_vals_t,
                u_pad, qb_t, qw_t, ld, lc,
                k=k,
                num_real_docs=self.dev.num_docs,
                d_tile=self.d_tile,
                precision=self.precision,
                queries_sorted=True,
            )

    def hybrid_from_vectors(
        self, buckets: np.ndarray, weights: np.ndarray, k: int
    ):
        """Sync hybrid top-k from prebuilt query vectors: (scores [B, k],
        doc indices [B, k], -1 padded)."""
        return self._finish_hybrid(
            self.hybrid_from_vectors_async(buckets, weights, k), len(buckets)
        )

    def _read_back(self, pending, b: int):
        """A pending top-k's first ``b`` rows copied to the host, the wait
        for the device included; traced as the span ``ranker.readback``."""
        scores, doc_idx = pending
        with span("ranker.readback"):
            return scores.cpu().numpy()[:b], doc_idx.cpu().numpy()[:b]

    def _doc_indices(self, doc_idx: np.ndarray) -> np.ndarray:
        """Engine positions -> original doc indices (-1 stays -1): the
        width-bucketed engine scores docs in a permuted order."""
        if self._bucketed is None:
            return doc_idx
        valid = doc_idx >= 0
        return np.where(
            valid, self._bucketed.pos2old[np.maximum(doc_idx, 0)], -1
        )

    def _finish_hybrid(self, pending, b: int):
        scores, doc_idx = self._read_back(pending, b)
        with span("ranker.id_map"):
            return scores, self._doc_indices(doc_idx)

    def finalize_closest(
        self, pending, n: int
    ) -> List[Tuple[List[str], np.ndarray]]:
        """Turn a pending async result (from ``_closest_hybrid_async`` /
        ``_closest_ell_async``) into ``closest_docs_batch``'s output
        format; this is where the host waits for the device. Traced as two
        spans: ``ranker.readback`` (the wait and the copies) and
        ``ranker.id_map`` (positions to doc ids, one list a query)."""
        scores, doc_idx = self._read_back(pending, n)
        with span("ranker.id_map"):
            doc_idx = self._doc_indices(doc_idx)
            out = []
            for b in range(n):
                keep = doc_idx[b] >= 0
                ids = [self.dev.doc_ids[i] for i in doc_idx[b][keep]]
                out.append((ids, scores[b][keep]))
            return out

    def closest_docs_batch(
        self, queries: Sequence[str], k: int = 5
    ) -> List[Tuple[List[str], np.ndarray]]:
        """Top-k (doc_ids, scores) per query. Exact w.r.t. the sparse matvec."""
        if self.mode in ("ell", "hybrid"):
            if self.mode == "ell":
                pending = self._closest_ell_async(queries, k)
            else:
                pending = self._closest_hybrid_async(queries, k)
            return self.finalize_closest(pending, len(queries))
        docs, contribs, nnz_cap = self._gather_ragged(queries)
        scores, doc_idx = ragged.segment_topk(
            docs, contribs, k=min(k, max(1, nnz_cap))
        )
        scores = scores.cpu().numpy()
        doc_idx = doc_idx.cpu().numpy()
        out = []
        for b in range(len(queries)):
            keep = doc_idx[b] >= 0
            ids = [self.dev.doc_ids[i] for i in doc_idx[b][keep]]
            out.append((ids, scores[b][keep]))
        return out

    def closest_docs(self, query: str, k: int = 5) -> Tuple[List[str], np.ndarray]:
        return self.closest_docs_batch([query], k)[0]

    def _gather_ragged_vectors(self, buckets: np.ndarray, weights: np.ndarray):
        """posting bound -> nnz cap -> gathered (docs [B, nnz_cap], contribs
        [B, nnz_cap], nnz_cap) of prebuilt query vectors, on the device."""
        total_posting_bound = int(
            np.sum(
                np.where(
                    weights != 0.0,
                    self.dev.doc_freqs[buckets].astype(np.int64),
                    0,
                ),
                axis=1,
            ).max()
            if len(buckets)
            else 1
        )
        nnz_cap = ragged.choose_nnz_cap(max(total_posting_bound, 1))
        docs, contribs, _ = ragged.gather_postings(
            self.dev.indptr,
            self.dev.post_docs,
            self.dev.post_vals,
            _put(buckets.astype(np.int32), self.device),
            _put(weights.astype(np.float32), self.device),
            nnz_cap=nnz_cap,
        )
        return docs, contribs, nnz_cap

    def _gather_ragged(self, queries: Sequence[str]):
        """vectorize -> posting bound -> nnz cap -> gathered (docs,
        contribs): the one copy shared by the ragged top-k path and the
        dense validation scorer it is parity-checked against."""
        return self._gather_ragged_vectors(*self._vectorize(queries))

    def dense_scores_batch(self, queries: Sequence[str]) -> np.ndarray:
        """Full [B, num_docs] score matrix (validation / small corpora)."""
        docs, contribs, _ = self._gather_ragged(queries)
        return (
            ragged.dense_scores(docs, contribs, num_docs=self.dev.num_docs)
            .cpu().numpy()
        )
