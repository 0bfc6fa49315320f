"""Host-side sparse index build: text -> hashed-ngram CSR postings.

Counterpart of ``ircl_tpu/index/build.py``, carried over line for line
apart from imports: ``ircl_tpu.index`` loads JAX through its package
``__init__``, and this port runs where JAX is not installed.

The reference builds a (hash_size x num_docs) scipy CSR via a multiprocessing
pool of tokenizer workers and COO assembly
(``preprocessing/drqa/build_tfidf.py:86-126``). Here the build is a
single-pass streaming loop (tokenize -> ngrams -> hash -> per-doc Counter)
emitting term-major CSR arrays directly; duplicate merging happens per
document (a Counter) so the global COO dedup the reference needs is
unnecessary. The arrays are flat numpy, ready for upload to the device.

Feature semantics are bit-identical to the reference ``count`` function
(``build_tfidf.py:64-83``): NFD-normalize, SimpleTokenizer, 1..n-grams
uncased with ``filter_ngram``, murmur3 mod hash_size.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ircl_tpu_torch.corpus.filters import filter_ngram, normalize
from ircl_tpu_torch.corpus.hashing import hash_tokens
from ircl_tpu_torch.corpus.tokenizer import default_tokenizer

DEFAULT_HASH_SIZE = 1 << 24
DEFAULT_NGRAM = 2


@dataclass
class CountIndex:
    """Term-major hashed-ngram postings (CSR over hash buckets).

    Equivalent content to the reference's count matrix
    (``build_tfidf.py:86-126``) in a layout chosen for device residency:
    three flat arrays instead of a scipy object.
    """

    hash_size: int
    ngram: int
    doc_ids: List[str]  # position -> external doc id
    indptr: np.ndarray  # [hash_size + 1] int64 offsets
    post_docs: np.ndarray  # [nnz] int32 doc indices, ascending within a term
    post_vals: np.ndarray  # [nnz] float32 counts (or tf-idf after transform)
    doc_freqs: np.ndarray  # [hash_size] int32 number of docs per term
    weighted: bool = False  # False: raw counts; True: tf-idf values

    @property
    def num_docs(self) -> int:
        return len(self.doc_ids)

    @property
    def nnz(self) -> int:
        return int(self.post_docs.shape[0])

    @property
    def doc2idx(self) -> Dict[str, int]:
        """doc id -> position, memoized: rebuilding the dict is O(num_docs)
        (seconds at full-wiki 5.4M on this host) and property syntax invites
        per-query use. doc_ids never mutates after construction."""
        cached = getattr(self, "_doc2idx", None)
        if cached is None or len(cached) != len(self.doc_ids):
            cached = {d: i for i, d in enumerate(self.doc_ids)}
            object.__setattr__(self, "_doc2idx", cached)
        return cached

    def max_doc_freq(self) -> int:
        return int(self.doc_freqs.max()) if self.nnz else 0

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(
            path,
            hash_size=self.hash_size,
            ngram=self.ngram,
            indptr=self.indptr,
            post_docs=self.post_docs,
            post_vals=self.post_vals,
            doc_freqs=self.doc_freqs,
            weighted=self.weighted,
            doc_ids=json.dumps(self.doc_ids),
        )

    @classmethod
    def load(cls, path: str) -> "CountIndex":
        z = np.load(path, allow_pickle=False)
        return cls(
            hash_size=int(z["hash_size"]),
            ngram=int(z["ngram"]),
            doc_ids=json.loads(str(z["doc_ids"])),
            indptr=z["indptr"],
            post_docs=z["post_docs"],
            post_vals=z["post_vals"],
            doc_freqs=z["doc_freqs"],
            weighted=bool(z["weighted"]),
        )


def doc_to_hashed_counts(
    text: str, ngram: int, hash_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """One document -> (unique hashed ngram buckets, counts)."""
    tokens = default_tokenizer().tokenize(normalize(text))
    grams = tokens.ngrams(n=ngram, uncased=True, filter_fn=filter_ngram)
    if not grams:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int32)
    hashed = hash_tokens(grams, hash_size)
    buckets, counts = np.unique(hashed, return_counts=True)
    return buckets.astype(np.int64), counts.astype(np.int32)


def build_count_index(
    store,
    ngram: int = DEFAULT_NGRAM,
    hash_size: int = DEFAULT_HASH_SIZE,
    doc_ids: Optional[Sequence] = None,
    chunk_docs: int = 8192,
) -> CountIndex:
    """Build the term-major postings index from a doc store.

    ``store`` exposes ``get_doc_ids`` / ``get_doc_text`` (see corpus.store).
    Documents stream through the native batch vectorizer in chunks.
    """
    from ircl_tpu_torch.corpus.fastpath import batch_vectorize

    if doc_ids is None:
        doc_ids = store.get_doc_ids()
    doc_ids = list(doc_ids)

    rows: List[np.ndarray] = []  # hashed buckets (one array per chunk)
    cols: List[np.ndarray] = []  # doc index per posting
    vals: List[np.ndarray] = []
    for lo in range(0, len(doc_ids), chunk_docs):
        chunk_ids = doc_ids[lo : lo + chunk_docs]
        texts = [store.get_doc_text(d) or "" for d in chunk_ids]
        per_doc = batch_vectorize(texts, hash_size, ngram)
        # Bulk per chunk (a per-doc append loop costs ~0.3ms/doc in Python
        # — minutes at full-wiki scale): one concatenate per chunk and the
        # doc column via run-expansion over the per-doc lengths.
        lens = np.fromiter(
            (len(b) for b, _ in per_doc), dtype=np.int64, count=len(per_doc)
        )
        if not lens.sum():
            continue
        rows.append(np.concatenate([b for b, _ in per_doc]))
        vals.append(np.concatenate([c for _, c in per_doc]))
        cols.append(
            np.repeat(
                np.arange(lo, lo + len(per_doc), dtype=np.int32), lens
            )
        )

    if rows:
        row = np.concatenate(rows)
        col = np.concatenate(cols)
        val = np.concatenate(vals)
    else:
        row = np.empty(0, dtype=np.int64)
        col = np.empty(0, dtype=np.int32)
        val = np.empty(0, dtype=np.int32)

    return assemble_csr(row, col, val, hash_size, ngram, [str(d) for d in doc_ids])


def _native_csr_lib():
    import ctypes

    from ircl_tpu_torch.corpus.hashing import get_native

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    return get_native(
        "ircl_csr_scatter",
        [i64p, i32p, i32p, ctypes.c_int64, i64p, i32p, f32p],
        None,
    )


def assemble_csr(
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    hash_size: int,
    ngram: int,
    doc_ids: List[str],
) -> CountIndex:
    """COO (already deduped per doc) -> term-major CSR arrays.

    Postings end up sorted by (term bucket, doc index): term-major CSR with
    ascending doc ids inside each posting list. When the input is doc-major
    (col non-decreasing — true for every in-repo producer) and the native
    library is available, a C++ stable counting-sort pass replaces the
    lexsort + three fancy-index permutes (~13s -> ~0.3s at 5.5M postings).
    """
    counts_per_bucket = np.bincount(row, minlength=hash_size)
    indptr = np.zeros(hash_size + 1, dtype=np.int64)
    np.cumsum(counts_per_bucket, out=indptr[1:])
    doc_freqs = counts_per_bucket.astype(np.int32)  # one posting per (term, doc)

    lib = _native_csr_lib()
    nnz = len(row)
    if (
        lib is not None
        and nnz
        and np.issubdtype(val.dtype, np.integer)
        # monotonicity check on the raw dtype: np.diff on an int64 copy
        # would allocate ~16 bytes/posting of transients (7GB at full-wiki
        # 447M postings) just to guard the fast path
        and bool((col[1:] >= col[:-1]).all())
    ):
        import ctypes

        row_c = np.ascontiguousarray(row, dtype=np.int64)
        col_c = np.ascontiguousarray(col, dtype=np.int32)
        val_c = np.ascontiguousarray(val, dtype=np.int32)
        cursor = indptr[:-1].copy()
        post_docs = np.empty(nnz, dtype=np.int32)
        post_vals = np.empty(nnz, dtype=np.float32)
        lib.ircl_csr_scatter(
            row_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            col_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            val_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            nnz,
            cursor.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            post_docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            post_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
    else:
        order = np.lexsort((col, row))
        post_docs = col[order].astype(np.int32)
        post_vals = val[order].astype(np.float32)

    return CountIndex(
        hash_size=hash_size,
        ngram=ngram,
        doc_ids=doc_ids,
        indptr=indptr,
        post_docs=post_docs,
        post_vals=post_vals,
        doc_freqs=doc_freqs,
    )


def to_scipy(index: CountIndex):
    """CountIndex -> scipy CSR (hash_size x num_docs), for validation only."""
    import scipy.sparse as sp

    return sp.csr_matrix(
        (index.post_vals, index.post_docs, index.indptr),
        shape=(index.hash_size, index.num_docs),
    )


def scipy_query_scores(
    mat, buckets: np.ndarray, weights: np.ndarray, hash_size: int
) -> np.ndarray:
    """Exact per-query scipy CSR matvec reference scores, [B, num_docs] f32.

    THE parity reference for every sparse engine (the reference pipeline's
    ``spvec * doc_mat``, ``tfidf_doc_ranker.py:65``): one sparse row per
    query from its (bucket, weight) vector — duplicate buckets sum, zero
    weights drop — times the full index CSR. All engine parity gates
    (bench_scale, sweep_df, sharded_scale, tests) share this one copy so
    tolerance/tie policy can't silently diverge.
    """
    import scipy.sparse as sp

    rows = []
    for b in range(len(buckets)):
        nz = weights[b] != 0
        spvec = sp.csr_matrix(
            (weights[b][nz], buckets[b][nz], [0, int(nz.sum())]),
            shape=(1, hash_size),
        )
        rows.append(np.asarray((spvec @ mat).todense()).ravel())
    return np.stack(rows).astype(np.float32, copy=False)
