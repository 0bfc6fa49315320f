"""Ragged posting-list scoring: the term-major validation engine.

Counterpart of ``ircl_tpu/ops/ragged.py``, plain tensor ops throughout (the
reference has no Pallas kernel here either):

1. **Ragged gather** — each query touches the posting segments of its
   (padded) term list. Segment starts and lengths come from two ``indptr``
   gathers; a ``searchsorted`` over the exclusive cumsum of segment lengths
   turns a flat position j in [0, NNZ) into (term slot, offset), so every
   query's postings concatenate into a dense ``[B, NNZ]`` pool. Work is
   proportional to the posting mass, never to the hash space.
2. **Sort + segment-sum** — postings are sorted by doc id per query; runs
   of equal doc ids are reduced by ``ops/hybrid._run_totals`` (fp64 prefix
   differences). Padding sorts to the end under doc id INT32_MAX.
3. **top-k** over the per-run totals. Exact: equal to the dense matvec
   result for every doc.
"""

from __future__ import annotations

from typing import Tuple

import torch

_PAD_DOC = 2**31 - 1  # doc id of pool padding


def gather_postings(
    indptr: torch.Tensor,  # [H+1] int32 posting offsets per hash bucket
    post_docs: torch.Tensor,  # [NNZ_total] int32 doc ids (term-major CSR)
    post_vals: torch.Tensor,  # [NNZ_total] float32 index values
    q_buckets: torch.Tensor,  # [B, T] int32 hash buckets (padded with 0)
    q_weights: torch.Tensor,  # [B, T] float32 query weights (0 on padding)
    nnz_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Concatenate each query's weighted postings into a [B, nnz_cap] pool.

    Returns (doc_ids [B, nnz_cap] int32, contribs [B, nnz_cap] f32,
    total [B] int32 true posting counts). Positions beyond total[b] carry
    doc id INT32_MAX and contribution 0.
    """
    qb = q_buckets.long()
    starts = indptr[qb]  # [B, T]
    lens = indptr[qb + 1] - starts
    # Padded term slots (weight 0) occupy no posting positions.
    lens = torch.where(q_weights != 0.0, lens, 0)

    B, T = q_buckets.shape
    cum = torch.cumsum(lens, dim=1, dtype=torch.int32)  # inclusive
    cum_ex = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)  # [B, T+1]
    total = cum_ex[:, -1]

    j = torch.arange(nnz_cap, dtype=torch.int32, device=indptr.device)
    t_of_j = torch.searchsorted(
        cum_ex, j.expand(B, nnz_cap).contiguous(), right=True
    ) - 1
    t_of_j = t_of_j.clamp(0, T - 1)  # [B, NNZ] term slot of each position

    within = j[None, :] - torch.gather(cum_ex, 1, t_of_j)
    idx = torch.gather(starts, 1, t_of_j) + within
    valid = j[None, :] < total[:, None]
    idx = torch.where(valid, idx, 0).long()

    docs = torch.where(valid, post_docs[idx], _PAD_DOC)
    w = torch.gather(q_weights, 1, t_of_j)
    contribs = torch.where(valid, w * post_vals[idx], 0.0)
    return docs, contribs, total


def segment_topk(
    docs: torch.Tensor,  # [B, NNZ] int32 doc ids (padding = INT32_MAX)
    contribs: torch.Tensor,  # [B, NNZ] f32 per-posting contributions
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-doc totals + top-k without scatter.

    Sorts (doc, contrib) by doc per row, reduces equal-doc runs at run
    boundaries, then top-k over run totals. Returns (scores [B, k] f32,
    doc_ids [B, k] int32); empty slots have score 0 and doc id -1 (ranked
    after any positive score).
    """
    from ircl_tpu_torch.ops.hybrid import _run_totals

    sdocs, order = torch.sort(docs, dim=1, stable=True)
    svals = torch.gather(contribs, 1, order)
    is_end, l_tot = _run_totals(sdocs, svals)
    totals = torch.where(is_end & (sdocs != _PAD_DOC), l_tot, -torch.inf)
    top_vals, top_idx = torch.topk(totals, k, dim=1)
    top_docs = torch.gather(sdocs, 1, top_idx)
    empty = top_vals == -torch.inf
    return (
        torch.where(empty, 0.0, top_vals),
        torch.where(empty, -1, top_docs),
    )


def dense_scores(
    docs: torch.Tensor,  # [B, NNZ] int32 (padding = INT32_MAX)
    contribs: torch.Tensor,  # [B, NNZ] f32
    num_docs: int,
) -> torch.Tensor:
    """Dense [B, num_docs] score matrix by scatter-add (validation path).
    On a CUDA device the adds are atomic, so a doc's postings sum in an
    order that may change from run to run."""
    clipped = docs.clamp(max=num_docs).long()  # padding falls into an extra bin
    out = torch.zeros(
        (docs.shape[0], num_docs + 1), dtype=contribs.dtype, device=docs.device
    )
    out.scatter_add_(1, clipped, contribs)
    return out[:, :num_docs]


def choose_nnz_cap(total_postings: int, floor: int = 1024) -> int:
    """Round a batch's max posting count up to the next power of two (the
    reference's shape bucketing, kept so both packages see the same pools)."""
    cap = floor
    while cap < total_postings:
        cap *= 2
    return cap
