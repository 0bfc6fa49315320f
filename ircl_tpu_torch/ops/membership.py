"""Membership-matmul sparse scoring in plain tensor ops (the ELL scorer).

Counterpart of ``ircl_tpu/ops/membership.py``, the reference's pure-XLA
ELL scorer, which reaches no Pallas kernel and which
``tests/test_membership.py`` holds against the gather/sort path. For a
query batch whose union of hashed buckets is ``u_sorted``:

1. ``build_w``: the ``[B, U]`` weight matrix from the padded query arrays;
2. every stored ``(doc, term)`` of the doc-major ELL index (``terms [N, K]``
   sorted in each doc, pad -1) is looked up in the union; the matched
   values form the slab ``M[u, d] = sum_k vals[d, k] * (terms[d, k] ==
   u_sorted[u])``;
3. ``scores = W @ M`` in full fp32, then the top-k.

The slab is written by one scatter here, where the reference compares every
(slot, doc, term) triple: a doc holds each term once, so each cell takes at
most one value and the slab is exact either way. The top-k walks the docs
in blocks of ``doc_block`` and keeps the reference's order among equal
scores (the lowest doc id first). The engine that serving runs is
``ops/membership_cuda.py::membership_topk_fused``; this module is off every
path. Every function computes on the device of its inputs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ircl_tpu_torch.utils.precision import float32_precision


def build_w(
    u_sorted: torch.Tensor,  # [U] int32 sorted union slots (sentinel padded)
    q_buckets: torch.Tensor,  # [B, T] int32 per-query buckets (0 padded)
    q_weights: torch.Tensor,  # [B, T] f32 weights (0 on padding)
) -> torch.Tensor:
    """``[B, U]`` f32 weight matrix: each query's weight added at its
    bucket's union slot; a bucket outside the union, or a zero weight,
    adds nothing."""
    U = u_sorted.shape[0]
    pos = torch.searchsorted(u_sorted, q_buckets).clamp(0, U - 1)
    valid = (u_sorted[pos] == q_buckets) & (q_weights != 0.0)
    w = torch.zeros((q_buckets.shape[0], U), dtype=torch.float32,
                    device=q_weights.device)
    rows = torch.arange(q_buckets.shape[0], device=q_buckets.device)[:, None]
    return w.index_put_(
        (rows.expand_as(pos), pos),
        torch.where(valid, q_weights, torch.zeros_like(q_weights)),
        accumulate=True,
    )


def _slab(terms_ell, vals_ell, u_sorted) -> torch.Tensor:
    """``[U, N]`` f32 slab of the union's rows of the ELL index."""
    U = u_sorted.shape[0]
    N, K = terms_ell.shape
    u_pos = torch.searchsorted(u_sorted, terms_ell).clamp(0, U - 1)
    matched = (u_sorted[u_pos] == terms_ell) & (terms_ell >= 0)
    contrib = torch.where(matched, vals_ell, torch.zeros_like(vals_ell))
    m = torch.zeros((U, N), dtype=torch.float32, device=vals_ell.device)
    docs = torch.arange(N, device=terms_ell.device)[:, None].expand(N, K)
    return m.index_put_((u_pos, docs), contrib, accumulate=True)


def membership_dense_scores(
    terms_ell: torch.Tensor,  # [N, K] int32, sorted in each doc, pad -1
    vals_ell: torch.Tensor,  # [N, K] f32
    u_sorted: torch.Tensor,  # [U] int32 sorted union slots
    q_buckets: torch.Tensor,  # [B, T] int32 padded query buckets
    q_weights: torch.Tensor,  # [B, T] f32 padded query weights
    doc_block: int = 1024,
) -> torch.Tensor:
    """Full ``[B, N]`` score matrix (the validation path), in full fp32.
    ``doc_block`` is the reference's argument; the whole slab is built at
    once, as the reference builds it."""
    w = build_w(u_sorted, q_buckets, q_weights)
    with float32_precision():
        return w @ _slab(terms_ell, vals_ell, u_sorted)


def membership_topk(
    terms_ell: torch.Tensor,  # [N, K] int32, sorted in each doc, pad -1
    vals_ell: torch.Tensor,  # [N, K] f32
    u_sorted: torch.Tensor,  # [U] int32 sorted unique batch buckets
    q_buckets: torch.Tensor,  # [B, T] int32 padded query buckets
    q_weights: torch.Tensor,  # [B, T] f32 padded query weights
    k: int,
    doc_block: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact batched top-k: ``(scores [B, k'], doc_ids [B, k'])`` with
    ``k' = min(k, N)``. A result whose score is <= 0 is empty: (0, -1).
    Among equal scores the lowest doc id comes first, as ``lax.top_k``
    over the reference's running concatenation gives them."""
    N = terms_ell.shape[0]
    B = q_buckets.shape[0]
    kk = min(k, N)
    w = build_w(u_sorted, q_buckets, q_weights)
    m = _slab(terms_ell, vals_ell, u_sorted)
    dev = w.device
    best_s = torch.full((B, kk), float("-inf"), device=dev)
    best_i = torch.full((B, kk), -1, dtype=torch.int64, device=dev)
    with float32_precision():
        for lo in range(0, N, doc_block):
            s = w @ m[:, lo : lo + doc_block]  # [B, <= doc_block]
            ids = torch.arange(lo, lo + s.shape[1], device=dev).expand(B, -1)
            cat_s = torch.cat([best_s, s], dim=1)
            cat_i = torch.cat([best_i, ids], dim=1)
            # a stable sort keeps the running best, then the block in doc
            # order, ahead of equal scores: lax.top_k's lowest index first
            order = torch.sort(cat_s, dim=1, descending=True, stable=True).indices[:, :kk]
            best_s = torch.gather(cat_s, 1, order)
            best_i = torch.gather(cat_i, 1, order)
    empty = best_s <= 0.0
    return (
        torch.where(empty, torch.zeros_like(best_s), best_s),
        torch.where(empty, -1, best_i).to(torch.int32),
    )
