"""Document-frequency split of the sparse index (hybrid scoring).

Counterpart of ``ircl_tpu/index/split.py``, carried over line for line
apart from imports: ``ircl_tpu.index`` loads JAX through its package
``__init__``, and this port runs where JAX is not installed.

Posting mass in a hashed-ngram index is power-law: a few thousand common
terms own most postings, while the discriminative terms (entities, rare
bigrams) have tiny document frequency. The hybrid scorer exploits this:

- **heavy terms** (df > threshold): doc-major ELL, scored by the Pallas
  membership slab. The per-doc heavy width K_h and the per-batch heavy union
  are both much smaller than their full-index counterparts, cutting the
  slab's U*N*K compare cost by ~an order of magnitude.
- **light terms** (df <= threshold): term-major postings kept host-side;
  a query's light posting pool is at most T * threshold entries, gathered by
  vectorized numpy (contiguous CSR slices — the one pattern CPUs do well)
  and shipped to the device as a tiny dense pool.

Exact merge (``ops/hybrid.py``): scores = H + L with H, L >= 0, so
top-k(H+L) is contained in top-k(H) union {docs with L > 0}; both parts are
computed exactly and the stale heavy-only duplicates are masked out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ircl_tpu_torch.index.build import CountIndex
from ircl_tpu_torch.index.ell import EllIndex, to_ell


@dataclass
class SplitIndex:
    heavy: EllIndex  # doc-major, heavy terms only
    # light term-major postings (full-width indptr; heavy rows empty)
    light_indptr: np.ndarray  # [hash_size + 1] int64
    light_docs: np.ndarray  # [nnz_light] int32
    light_vals: np.ndarray  # [nnz_light] float32
    df_threshold: int
    num_docs: int
    hash_size: int
    doc_freqs: np.ndarray  # full df vector (query-side routing + idf)


def split_index(index: CountIndex, df_threshold: int = 128) -> SplitIndex:
    """df-split build. Uses the C++ two-pass fill when the native library is
    available (~4x at 1M docs / 83M postings in a fair alternating A/B on
    the shared host: 61-69s numpy repeat/extract/sort/scatter vs 15-26s
    native; the residual is the 600MB ELL first-touch write);
    ``_split_index_np`` is the bit-identical reference the native path is
    parity-tested against."""
    lib = _native_split_lib()
    if lib is None:
        return _split_index_np(index, df_threshold)
    import ctypes

    n = index.num_docs
    heavy_mask = (index.doc_freqs > df_threshold).astype(np.uint8)
    indptr = np.ascontiguousarray(index.indptr, dtype=np.int64)
    post_docs = np.ascontiguousarray(index.post_docs, dtype=np.int32)
    post_vals = np.ascontiguousarray(index.post_vals, dtype=np.float32)

    widths = np.zeros(n, dtype=np.int32)
    lib.ircl_split_widths(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        index.hash_size,
        post_docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        heavy_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    # K matches to_ell exactly, including the K=0 all-light edge case
    K = int(widths.max(initial=0))
    assert index.hash_size < 2**31
    out_t = np.full((n, K), -1, dtype=np.int32)
    out_v = np.zeros((n, K), dtype=np.float32)
    fill = np.zeros(n, dtype=np.int32)
    nnz_light = int(index.nnz - int(widths.sum(dtype=np.int64)))
    light_docs = np.empty(nnz_light, dtype=np.int32)
    light_vals = np.empty(nnz_light, dtype=np.float32)
    lp = lib.ircl_split_fill(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        index.hash_size,
        post_docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        post_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        heavy_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        K,
        out_t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fill.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        light_docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        light_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    assert lp == nnz_light, (lp, nnz_light)

    light_counts = np.where(heavy_mask.astype(bool), 0, index.doc_freqs)
    light_indptr = np.zeros(index.hash_size + 1, dtype=np.int64)
    np.cumsum(light_counts, out=light_indptr[1:])

    return SplitIndex(
        heavy=EllIndex(
            terms=out_t, vals=out_v, num_docs=n, hash_size=index.hash_size
        ),
        light_indptr=light_indptr,
        light_docs=light_docs,
        light_vals=light_vals,
        df_threshold=df_threshold,
        num_docs=n,
        hash_size=index.hash_size,
        doc_freqs=index.doc_freqs,
    )


def save_split(split: SplitIndex, path: str) -> None:
    """Persist a df-split to ``path`` (uncompressed npz — the heavy ELL is
    hundreds of MB at 1M docs and zlib would dominate the save).

    Serving cold-start: ``split_index`` costs 15-26s at 1M docs even with
    the C++ fill (the 600MB ELL first-touch write is the floor); loading
    the prebuilt artifact replaces that with one sequential read. Pass the
    result to ``TfidfRanker(index, split=...)``.
    """
    np.savez(
        path,
        heavy_terms=split.heavy.terms,
        heavy_vals=split.heavy.vals,
        light_indptr=split.light_indptr,
        light_docs=split.light_docs,
        light_vals=split.light_vals,
        doc_freqs=split.doc_freqs,
        meta=np.array(
            [split.df_threshold, split.num_docs, split.hash_size], np.int64
        ),
    )


def load_split(path: str) -> SplitIndex:
    """Load a df-split saved by ``save_split``."""
    with np.load(path) as z:
        df_threshold, num_docs, hash_size = (int(x) for x in z["meta"])
        return SplitIndex(
            heavy=EllIndex(
                terms=z["heavy_terms"],
                vals=z["heavy_vals"],
                num_docs=num_docs,
                hash_size=hash_size,
            ),
            light_indptr=z["light_indptr"],
            light_docs=z["light_docs"],
            light_vals=z["light_vals"],
            df_threshold=df_threshold,
            num_docs=num_docs,
            hash_size=hash_size,
            doc_freqs=z["doc_freqs"],
        )


def _split_index_np(index: CountIndex, df_threshold: int = 128) -> SplitIndex:
    """Pure-numpy df-split (fallback + the native path's parity reference)."""
    heavy_mask_term = index.doc_freqs > df_threshold  # [hash_size]
    term_of_posting = np.repeat(
        np.arange(index.hash_size, dtype=np.int64), np.diff(index.indptr)
    )
    posting_is_heavy = heavy_mask_term[term_of_posting]

    # heavy sub-index -> ELL
    heavy_counts = np.where(heavy_mask_term, index.doc_freqs, 0)
    heavy_indptr = np.zeros(index.hash_size + 1, dtype=np.int64)
    np.cumsum(heavy_counts, out=heavy_indptr[1:])
    heavy_sub = CountIndex(
        hash_size=index.hash_size,
        ngram=index.ngram,
        doc_ids=index.doc_ids,
        indptr=heavy_indptr,
        post_docs=index.post_docs[posting_is_heavy],
        post_vals=index.post_vals[posting_is_heavy],
        doc_freqs=heavy_counts.astype(np.int32),
        weighted=index.weighted,
    )
    heavy_ell = to_ell(heavy_sub)

    light_counts = np.where(~heavy_mask_term, index.doc_freqs, 0)
    light_indptr = np.zeros(index.hash_size + 1, dtype=np.int64)
    np.cumsum(light_counts, out=light_indptr[1:])

    return SplitIndex(
        heavy=heavy_ell,
        light_indptr=light_indptr,
        light_docs=index.post_docs[~posting_is_heavy],
        light_vals=index.post_vals[~posting_is_heavy],
        df_threshold=df_threshold,
        num_docs=index.num_docs,
        hash_size=index.hash_size,
        doc_freqs=index.doc_freqs,
    )


@dataclass
class BucketedHeavy:
    """Heavy ELL split into width buckets (docs sorted by heavy term count).

    Slab compare cost is U * N * K with K padded to the per-bucket max;
    splitting at a width quantile removes most padding work (the bulk of
    docs are much narrower than the max). Positions are permuted:
    ``pos2old`` maps a device-space position (concatenated, padded buckets)
    back to the original doc id (-1 for padding slots); ``old2pos`` maps the
    other way (light pools are remapped through it before upload).
    """

    ell_a: EllIndex  # narrow bucket (permuted order)
    ell_b: EllIndex  # wide bucket
    pos2old: np.ndarray  # [Na_pad + Nb_pad] int32, -1 at pads
    # [num_docs + 1] int32. Only real doc ids (< num_docs) are ever looked
    # up: both light-pool gathers (C++ and numpy) write the out-of-range
    # pad_doc id into pad slots directly, never remapping them — the fused
    # kernel's window bounds rely on pads sorting past every real position.
    old2pos: np.ndarray


def bucket_heavy(heavy: EllIndex, d_tile: int = 256) -> BucketedHeavy:
    widths = (heavy.terms >= 0).sum(axis=1)
    order = np.argsort(widths, kind="stable")
    sw = widths[order]
    n = len(order)

    def padded(x, m):
        return -(-max(x, 1) // m) * m

    # choose the cut minimizing padded compare work Na*Ka + Nb*Kb
    best = (None, None)
    for q in (0.5, 0.65, 0.8, 0.9, 0.95, 1.0):
        cut = min(max(int(n * q), 1), n)
        ka = int(sw[cut - 1]) if cut else 1
        kb = int(sw[-1]) if cut < n else 1
        cost = padded(cut, d_tile) * max(ka, 1) + (
            padded(n - cut, d_tile) * max(kb, 1) if cut < n else 0
        )
        if best[0] is None or cost < best[0]:
            best = (cost, cut)
    cut = best[1]

    def subset(idxs, k_width):
        k_width = max(int(k_width), 1)
        # slice columns BEFORE the fancy index: [idxs][:, :k] would copy the
        # full-width rows first (gigabytes of transient at 1M docs)
        terms = heavy.terms[:, :k_width][idxs]
        vals = heavy.vals[:, :k_width][idxs]
        return EllIndex(
            terms=np.ascontiguousarray(terms),
            vals=np.ascontiguousarray(vals),
            num_docs=len(idxs),
            hash_size=heavy.hash_size,
        )

    a_idx, b_idx = order[:cut], order[cut:]
    ell_a = subset(a_idx, sw[cut - 1] if cut else 1)
    ell_b = subset(b_idx, sw[-1] if cut < n else 1)

    na_pad = padded(len(a_idx), d_tile)
    nb_pad = padded(len(b_idx), d_tile)
    pos2old = np.full(na_pad + nb_pad, -1, dtype=np.int32)
    pos2old[: len(a_idx)] = a_idx
    pos2old[na_pad : na_pad + len(b_idx)] = b_idx
    old2pos = np.zeros(heavy.num_docs + 1, dtype=np.int32)
    old2pos[a_idx] = np.arange(len(a_idx), dtype=np.int32)
    old2pos[b_idx] = na_pad + np.arange(len(b_idx), dtype=np.int32)
    # Sentinel entry (index num_docs): never looked up — pad slots get the
    # out-of-range pad_doc id written directly by both gathers (see
    # BucketedHeavy docstring); kept so old2pos indexes stay in bounds for
    # any doc id <= num_docs.
    old2pos[-1] = 0
    return BucketedHeavy(ell_a=ell_a, ell_b=ell_b, pos2old=pos2old, old2pos=old2pos)


def _native_split_lib():
    import ctypes

    from ircl_tpu_torch.corpus.hashing import get_native

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if get_native(
        "ircl_split_widths", [i64p, ctypes.c_int64, i32p, u8p, i32p], None
    ) is None:
        return None
    return get_native(
        "ircl_split_fill",
        [i64p, ctypes.c_int64, i32p, f32p, u8p, ctypes.c_int64,
         i32p, f32p, i32p, i32p, f32p],
        ctypes.c_int64,
    )


def _native_light_lib():
    import ctypes

    from ircl_tpu_torch.corpus.hashing import get_native

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    if get_native(
        "ircl_light_pool_max",
        [i32p, f32p, ctypes.c_int64, ctypes.c_int64, i64p],
        ctypes.c_int64,
    ) is None:
        return None
    return get_native(
        "ircl_gather_light_pools",
        [i32p, f32p, ctypes.c_int64, ctypes.c_int64,
         i64p, i32p, f32p, i32p,
         ctypes.c_int32, ctypes.c_int32, i32p, f32p, ctypes.c_int64],
        ctypes.c_int64,
    )


def gather_light_pools(
    split: SplitIndex,
    buckets: np.ndarray,  # [B, T] int32 query buckets
    weights: np.ndarray,  # [B, T] f32 query weights
    pool_floor: int = 128,
    old2pos: np.ndarray = None,  # optional doc-id remap (width-bucket perm)
    sort_pools: bool = False,  # doc-sort each pool ascending (stable)
    pad_doc: int = None,  # padding doc id (default: num_docs)
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Per-query light posting pools (docs [B, NNZ], w*val contribs [B, NNZ]).

    NNZ is the batch max rounded to a power of two (compile-shape bucketing).
    Padding entries carry doc id = ``pad_doc`` and contribution 0. Fast path:
    the C++ runtime (``native/src/ircl_native.cpp::ircl_gather_light_pools``)
    fuses gather + remap + per-pool doc sort; the vectorized-numpy fallback
    reproduces it exactly (contiguous CSR slices in (query, term) order,
    stable sort).
    """
    if pad_doc is None:
        pad_doc = split.num_docs
    B, T = buckets.shape
    buckets32 = np.ascontiguousarray(buckets, dtype=np.int32)
    weights32 = np.ascontiguousarray(weights, dtype=np.float32)

    lib = _native_light_lib()
    if lib is not None and B:
        import ctypes

        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        bp = buckets32.ctypes.data_as(i32p)
        wp = weights32.ctypes.data_as(f32p)
        ipp = split.light_indptr.ctypes.data_as(i64p)
        max_fill = lib.ircl_light_pool_max(bp, wp, B, T, ipp)
        nnz = pool_floor
        while nnz < max_fill:
            nnz *= 2
        docs = np.empty((B, nnz), dtype=np.int32)
        contribs = np.empty((B, nnz), dtype=np.float32)
        o2p = (
            np.ascontiguousarray(old2pos, dtype=np.int32)
            if old2pos is not None
            else None
        )
        rc = lib.ircl_gather_light_pools(
            bp, wp, B, T, ipp,
            split.light_docs.ctypes.data_as(i32p),
            split.light_vals.ctypes.data_as(f32p),
            o2p.ctypes.data_as(i32p) if o2p is not None else None,
            np.int32(pad_doc), np.int32(1 if sort_pools else 0),
            docs.ctypes.data_as(i32p),
            contribs.ctypes.data_as(f32p),
            nnz,
        )
        assert rc >= 0, "pool capacity underestimated"
        return docs, contribs, nnz
    return _gather_light_pools_np(
        split, buckets32, weights32, pool_floor, old2pos, sort_pools, pad_doc
    )


def _gather_light_pools_np(
    split: SplitIndex,
    buckets: np.ndarray,
    weights: np.ndarray,
    pool_floor: int,
    old2pos: np.ndarray,
    sort_pools: bool,
    pad_doc: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    B, T = buckets.shape
    is_light = (weights != 0.0) & (
        split.doc_freqs[buckets] <= split.df_threshold
    )
    starts = split.light_indptr[buckets]  # [B, T]
    lens = np.where(is_light, np.diff(split.light_indptr)[buckets], 0)

    cum = np.zeros((B, T + 1), dtype=np.int64)
    np.cumsum(lens, axis=1, out=cum[:, 1:])
    totals = cum[:, -1]
    nnz = pool_floor
    while nnz < totals.max(initial=0):
        nnz *= 2

    docs = np.full((B, nnz), pad_doc, dtype=np.int32)
    contribs = np.zeros((B, nnz), dtype=np.float32)

    # Flatten all (query, term) segments into one index expression.
    b_idx, t_idx = np.nonzero(lens)
    seg_lens = lens[b_idx, t_idx]
    seg_starts = starts[b_idx, t_idx]
    seg_out0 = cum[b_idx, t_idx]
    seg_w = weights[b_idx, t_idx]
    if len(seg_lens):
        flat_total = int(seg_lens.sum())
        seg_offsets = np.zeros(len(seg_lens) + 1, dtype=np.int64)
        np.cumsum(seg_lens, out=seg_offsets[1:])
        within = np.arange(flat_total, dtype=np.int64) - np.repeat(
            seg_offsets[:-1], seg_lens
        )
        src = np.repeat(seg_starts, seg_lens) + within
        dst_col = np.repeat(seg_out0, seg_lens) + within
        dst_row = np.repeat(b_idx, seg_lens)
        gathered = split.light_docs[src]
        if old2pos is not None:
            gathered = old2pos[gathered].astype(np.int32)
        docs[dst_row, dst_col] = gathered
        contribs[dst_row, dst_col] = split.light_vals[src] * np.repeat(
            seg_w, seg_lens
        )
    if sort_pools:
        order = np.argsort(docs, axis=1, kind="stable")
        docs = np.take_along_axis(docs, order, axis=1)
        contribs = np.take_along_axis(contribs, order, axis=1)
    return docs, contribs, nnz
