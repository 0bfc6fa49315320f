"""Doc-major ELL layout of the sparse index (for membership-matmul scoring).

Counterpart of ``ircl_tpu/index/ell.py``, carried over line for line
apart from imports: ``ircl_tpu.index`` loads JAX through its package
``__init__``, and this port runs where JAX is not installed.

Inverts the term-major CSR postings into per-document padded rows:
``terms [N, K] int32`` (each doc's hashed term buckets, ascending, -1 pad)
and ``vals [N, K] f32``. K is the corpus max distinct terms per doc (FEVER
wiki docs are short intro paragraphs, so K stays modest). Equal-memory note:
ELL holds the same nnz as the CSR plus padding to K.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ircl_tpu_torch.index.build import CountIndex


@dataclass
class EllIndex:
    terms: np.ndarray  # [N, K] int32, -1 padded, ascending per row
    vals: np.ndarray  # [N, K] float32
    num_docs: int
    hash_size: int

    @property
    def k_width(self) -> int:
        return int(self.terms.shape[1])

    def nbytes(self) -> int:
        return self.terms.nbytes + self.vals.nbytes


def to_ell(index: CountIndex, k_width: int | None = None) -> EllIndex:
    """CountIndex (term-major CSR) -> doc-major ELL."""
    n = index.num_docs
    term_of_posting = np.repeat(
        np.arange(index.hash_size, dtype=np.int64), np.diff(index.indptr)
    )
    order = np.lexsort((term_of_posting, index.post_docs))
    docs = index.post_docs[order]
    terms = term_of_posting[order]
    vals = index.post_vals[order]

    counts = np.bincount(docs, minlength=n)
    K = k_width or (int(counts.max()) if len(counts) else 1)

    out_t = np.full((n, K), -1, dtype=np.int32)
    out_v = np.zeros((n, K), dtype=np.float32)
    # position of each posting within its doc row
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    within = np.arange(len(docs)) - starts[docs]
    keep = within < K  # spill truncation if k_width was forced smaller
    # Terms fit int32 only if hash_size <= 2^31; assert (2^24 default).
    assert index.hash_size < 2**31
    out_t[docs[keep], within[keep]] = terms[keep].astype(np.int32)
    out_v[docs[keep], within[keep]] = vals[keep]
    return EllIndex(
        terms=out_t, vals=out_v, num_docs=n, hash_size=index.hash_size
    )
