"""Chunked hybrid ranking: full-wiki scale (5.4M docs) on one device.

Counterpart of ``ircl_tpu/index/chunked.py``, carried over line for line
apart from its imports and the ``device`` argument. The staged hybrid
engine's transient device memory is the membership slab M [U, N] plus the
score matrix H [B, N], both proportional to the corpus. The chunked ranker
slices the corpus into document-range chunks, scores each with the staged
engine (temporaries live only for the active chunk; the resident cost is
just the per-chunk ELL postings), and merges the per-chunk winners on the
host. Exactness is preserved: query idf comes from the GLOBAL document
frequencies (postings are globally tf-idf weighted before slicing), and
each chunk's df-split is merely a routing choice.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ircl_tpu_torch.index.build import CountIndex


def _native_window_lib():
    import ctypes

    from ircl_tpu_torch.corpus.hashing import get_native

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    if get_native(
        "ircl_csr_doc_window",
        [i64p, ctypes.c_int64, i32p, ctypes.c_int32, ctypes.c_int32,
         i64p, i64p],
        None,
    ) is None:
        return None
    return get_native(
        "ircl_csr_window_extract",
        [i64p, i64p, ctypes.c_int64, i32p, f32p, ctypes.c_int32,
         i32p, f32p],
        None,
    )


def slice_doc_range(index: CountIndex, lo: int, hi: int) -> CountIndex:
    """Column (document-range) slice [lo, hi) of a term-major CSR index.
    Doc ids are renumbered to the chunk-local range.

    Posting lists are doc-ascending, so each term's chunk window is found
    by two C++ binary searches and copied sequentially — the numpy
    formulation (``_slice_doc_range_np``, kept as the parity reference)
    repeats + masks ALL postings per chunk, minutes at full-wiki scale."""
    lib = _native_window_lib()
    if lib is None:
        return _slice_doc_range_np(index, lo, hi)
    import ctypes

    indptr = np.ascontiguousarray(index.indptr, dtype=np.int64)
    post_docs = np.ascontiguousarray(index.post_docs, dtype=np.int32)
    post_vals = np.ascontiguousarray(index.post_vals, dtype=np.float32)
    start = np.empty(index.hash_size, dtype=np.int64)
    end = np.empty(index.hash_size, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ircl_csr_doc_window(
        indptr.ctypes.data_as(i64p),
        index.hash_size,
        post_docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lo,
        hi,
        start.ctypes.data_as(i64p),
        end.ctypes.data_as(i64p),
    )
    counts = end - start
    new_indptr = np.zeros(index.hash_size + 1, dtype=np.int64)
    np.cumsum(counts, out=new_indptr[1:])
    nnz = int(new_indptr[-1])
    out_docs = np.empty(nnz, dtype=np.int32)
    out_vals = np.empty(nnz, dtype=np.float32)
    lib.ircl_csr_window_extract(
        start.ctypes.data_as(i64p),
        end.ctypes.data_as(i64p),
        index.hash_size,
        post_docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        post_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lo,
        out_docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return CountIndex(
        hash_size=index.hash_size,
        ngram=index.ngram,
        doc_ids=index.doc_ids[lo:hi],
        indptr=new_indptr,
        post_docs=out_docs,
        post_vals=out_vals,
        doc_freqs=counts.astype(np.int32),
        weighted=index.weighted,
    )


def _slice_doc_range_np(index: CountIndex, lo: int, hi: int) -> CountIndex:
    """Pure-numpy doc-range slice (fallback + native parity reference)."""
    mask = (index.post_docs >= lo) & (index.post_docs < hi)
    term_of_posting = np.repeat(
        np.arange(index.hash_size, dtype=np.int64), np.diff(index.indptr)
    )
    counts = np.bincount(
        term_of_posting[mask], minlength=index.hash_size
    ).astype(np.int64)
    indptr = np.zeros(index.hash_size + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CountIndex(
        hash_size=index.hash_size,
        ngram=index.ngram,
        doc_ids=index.doc_ids[lo:hi],
        indptr=indptr,
        post_docs=(index.post_docs[mask] - lo).astype(np.int32),
        post_vals=index.post_vals[mask],
        doc_freqs=counts.astype(np.int32),
        weighted=index.weighted,
    )


class ChunkedHybridRanker:
    """Exact batched top-k over a corpus too large for one staged pass.

    Same results contract as ``TfidfRanker`` (mode="hybrid"); ``chunk_docs``
    bounds the per-chunk transient device memory. ``device`` goes to every
    chunk's ``TfidfRanker``.
    """

    def __init__(
        self,
        index: CountIndex,
        device,
        chunk_docs: int = 1_000_000,
        split_cache_dir: str = None,  # dir of per-chunk split artifacts
        #   (chunk_<lo>_<hi>.npz): load when present, build-and-save when
        #   not — serving cold-start at 5.4M docs skips 6 chunk re-splits
        **ranker_kwargs,
    ):
        from ircl_tpu_torch.index.ranker import TfidfRanker
        from ircl_tpu_torch.index.tfidf import idf_vector, tfidf_transform

        if not index.weighted and not ranker_kwargs.get("binary_tf", False):
            index = tfidf_transform(index)  # global idf BEFORE slicing
        self.num_docs = index.num_docs
        self.doc_ids = index.doc_ids
        self.hash_size = index.hash_size
        self.ngram = index.ngram
        # query weights always use GLOBAL document frequencies
        self._doc_freqs = index.doc_freqs.copy()
        self._idfs = idf_vector(index.doc_freqs, index.num_docs)
        self._binary_tf = ranker_kwargs.get("binary_tf", False)
        self._max_terms = ranker_kwargs.pop("fixed_max_terms", None)

        self.offsets: List[int] = []
        self.chunks: List[TfidfRanker] = []
        for lo in range(0, index.num_docs, chunk_docs):
            hi = min(lo + chunk_docs, index.num_docs)
            sub = slice_doc_range(index, lo, hi)
            self.offsets.append(lo)
            kw = dict(ranker_kwargs)
            if split_cache_dir is not None:
                kw["split"] = self._cached_split(
                    split_cache_dir, sub, lo, hi, ranker_kwargs,
                    self._max_terms,
                )
            self.chunks.append(
                TfidfRanker(
                    sub, device, mode="hybrid",
                    fixed_max_terms=self._max_terms, **kw,
                )
            )

    @staticmethod
    def _cached_split(cache_dir, sub, lo, hi, ranker_kwargs, max_terms):
        """Load the chunk's split artifact, or build and persist it. The
        requested df_threshold must match a cached artifact's (an "auto"
        request accepts whatever the cache holds — it was autotuned or
        chosen at save time)."""
        import os

        from ircl_tpu_torch.index.split import load_split, save_split, split_index

        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"chunk_{lo}_{hi}.npz")
        want_df = ranker_kwargs.get("df_threshold", "auto")
        if os.path.exists(path):
            split = load_split(path)
            if want_df != "auto" and split.df_threshold != want_df:
                raise ValueError(
                    f"{path}: cached df_threshold {split.df_threshold} != "
                    f"requested {want_df} — delete the cache or match it"
                )
            return split
        df = want_df
        if df == "auto":
            from ircl_tpu_torch.index.autotune import auto_df_threshold

            # mirror TfidfRanker's auto contract (same pads/term cap)
            df = auto_df_threshold(
                sub,
                max_terms=max_terms or 24,
                union_floor=ranker_kwargs.get("fixed_union_cap") or 512,
                union_round=ranker_kwargs.get("union_round"),
            )
        split = split_index(sub, df_threshold=df)
        save_split(split, path)
        return split

    def _vectorize(self, queries: Sequence[str]):
        from ircl_tpu_torch.index.ranker import vectorize_queries

        return vectorize_queries(
            queries,
            self.hash_size,
            self.ngram,
            self._doc_freqs,
            self.num_docs,
            max_terms=self._max_terms,
            binary_tf=self._binary_tf,
            idfs=self._idfs,
        )

    def hybrid_from_vectors(
        self, buckets: np.ndarray, weights: np.ndarray, k: int = 5
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [B, k], global doc indices [B, k], -1 padded). Chunks are
        dispatched asynchronously (the single device stream serializes their
        temporaries) and merged on the host."""
        pending = [
            c.hybrid_from_vectors_async(buckets, weights, k)
            for c in self.chunks
        ]
        B = len(buckets)
        all_s, all_i = [], []
        for chunk, off, p in zip(self.chunks, self.offsets, pending):
            s, i = chunk._finish_hybrid(p, B)
            all_s.append(s)
            all_i.append(np.where(i >= 0, i + off, -1))
        s = np.concatenate(all_s, axis=1)  # [B, C*k]
        i = np.concatenate(all_i, axis=1)
        order = np.argsort(-s, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(s, order, axis=1), np.take_along_axis(
            i, order, axis=1
        )

    def closest_docs_batch(
        self, queries: Sequence[str], k: int = 5
    ) -> List[Tuple[List[str], np.ndarray]]:
        buckets, weights = self._vectorize(queries)
        scores, doc_idx = self.hybrid_from_vectors(buckets, weights, k)
        out = []
        for b in range(len(queries)):
            keep = doc_idx[b] >= 0
            out.append(
                ([self.doc_ids[i] for i in doc_idx[b][keep]], scores[b][keep])
            )
        return out
