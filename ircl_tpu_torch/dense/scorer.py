"""Exhaustive cosine top-k over an embedding matrix.

Counterpart of ``ircl_tpu/dense/scorer.py``: brute-force scoring as one
matrix product (embeddings are L2-normalized, so dot = cosine), then top-k.
The products are plain PyTorch matrix products, as they were XLA's in the
reference, and run in full fp32 (TF32 off). The reference's precisions
``"default"`` and ``"high"`` are bf16-class on the TPU; CUDA has no bf16_3x
matrix product, so all three precisions run fp32 here, as the sparse
scoring GEMM does (``ops/membership_cuda.py::scores_matmul``).

Equal scores may come back in another order than ``lax.top_k``'s (lowest
index first). The corpus-sharded scorer (``shard_corpus``,
``make_sharded_topk``, ``sharded_cosine_topk``) keeps one block of rows on
each rank of a mesh (``parallel/``), scores it with the two-phase top-k, as
the reference's sharded path does, and merges the ranks' top-k.
"""

from __future__ import annotations

import numpy as np
import torch

from ircl_tpu_torch.parallel.common import gather_topk_merge
from ircl_tpu_torch.parallel.mesh import axis_rank, axis_size, check_mesh, mesh_device
from ircl_tpu_torch.utils.precision import float32_precision

_DENSE_PREC = {"highest", "high", "default"}  # all fp32 on CUDA


def _check_precision(precision: str) -> None:
    if precision not in _DENSE_PREC:
        raise KeyError(precision)  # the reference's dict lookup


def cosine_topk(
    queries: torch.Tensor,  # [B, D] L2-normalized
    corpus: torch.Tensor,  # [M, D] L2-normalized
    k: int,
    block: int = 0,  # 0: single matmul; >0: loop over corpus blocks
):
    """Single-device exact top-k. Returns (scores [B, k], indices [B, k]
    int32). With ``block``, blocks of ``block`` rows carry a running top-k;
    a ragged tail re-reads the last ``block`` rows and masks the rows
    already seen to -inf, so no doc enters the merge twice."""
    m = corpus.shape[0]
    kk = min(k, m)
    with float32_precision():
        if block and m > block:
            B = queries.shape[0]
            best_s = queries.new_full((B, kk), float("-inf"))
            best_i = torch.full((B, kk), -1, dtype=torch.int64,
                                device=queries.device)
            for blk in range(-(-m // block)):
                start = min(blk * block, m - block)
                s = queries @ corpus[start : start + block].T  # [B, block]
                ids = torch.arange(start, start + block, device=queries.device)
                s = s.masked_fill((ids < blk * block)[None, :], float("-inf"))
                cat_s = torch.cat([best_s, s], dim=1)
                cat_i = torch.cat([best_i, ids.expand(B, -1)], dim=1)
                best_s, idx = torch.topk(cat_s, kk, dim=1)
                best_i = torch.gather(cat_i, 1, idx)
            return best_s, best_i.to(torch.int32)
        scores = queries @ corpus.T
    top_s, top_i = torch.topk(scores, kk, dim=1)
    return top_s, top_i.to(torch.int32)


def cosine_topk_twophase(
    queries: torch.Tensor,  # [B, D] L2-normalized
    corpus: torch.Tensor,  # [M, D] L2-normalized (any M: -inf column pad)
    k: int,
    chunk: int = 128,
    precision: str = "highest",
):
    """Exact top-k in two phases over the materialized ``[B, M]`` scores:
    a narrow top-k over chunk maxima, then a top-k over the winning chunks'
    score spans. The top-k lie in at most k chunks, each with a maximum at
    least the k-th score, so the top-k chunks by maximum hold the answer.
    A ragged M pads the score matrix (never the corpus: cosines can be
    negative) with -inf columns."""
    _check_precision(precision)
    B = queries.shape[0]
    m = corpus.shape[0]
    kk = min(k, m)
    nc = -(-m // chunk)
    with float32_precision():
        h = queries @ corpus.T  # [B, M]
    if nc * chunk != m:
        h = torch.cat([h, h.new_full((B, nc * chunk - m), float("-inf"))], dim=1)
    cmax = h.view(B, nc, chunk).amax(dim=-1)
    kc = min(kk, nc)
    _, cidx = torch.topk(cmax, kc, dim=1)
    flat = (cidx[:, :, None] * chunk + torch.arange(chunk, device=h.device))
    flat = flat.reshape(B, kc * chunk)
    cand = torch.gather(h, 1, flat)
    s, si = torch.topk(cand, kk, dim=1)
    return s, torch.gather(flat, 1, si).to(torch.int32)


def cosine_topk_scan(
    queries: torch.Tensor,  # [B, D] L2-normalized
    corpus: torch.Tensor,  # [M, D] L2-normalized, M % block == 0
    k: int,
    chunk: int = 128,
    block: int = 62_500 * 16,  # corpus rows per step
    precision: str = "highest",
    extra_chunks: int = 0,  # slack chunks kept past k (near-tie margin)
):
    """Two-phase top-k whose phase 1 never materializes ``[B, M]``: each
    corpus block is scored and reduced to chunk maxima at once; phase 2
    gathers the winning chunks' corpus rows and rescores them. Phases 1 and
    2 are different products of the same contraction, so selection is exact
    only where they agree on near-ties; ``extra_chunks`` adds margin (the
    reference's contract)."""
    _check_precision(precision)
    B = queries.shape[0]
    m = corpus.shape[0]
    kk = min(k, m)
    if m % block or block % chunk:
        raise ValueError(
            f"M={m} must be a multiple of block={block}, and block a multiple "
            f"of chunk={chunk}"
        )
    cmax = queries.new_empty((B, m // chunk))
    with float32_precision():
        for lo in range(0, m, block):
            s = queries @ corpus[lo : lo + block].T  # [B, block]
            cmax[:, lo // chunk : (lo + block) // chunk] = s.view(
                B, block // chunk, chunk
            ).amax(dim=-1)
        kc = min(kk + extra_chunks, m // chunk)
        _, cidx = torch.topk(cmax, kc, dim=1)
        flat = cidx[:, :, None] * chunk + torch.arange(chunk, device=cmax.device)
        flat = flat.reshape(B, kc * chunk)
        rows_sel = corpus[flat]  # [B, kc*chunk, D] gather
        cand = torch.bmm(rows_sel, queries[:, :, None])[:, :, 0]
    s, si = torch.topk(cand, kk, dim=1)
    return s, torch.gather(flat, 1, si).to(torch.int32)


def shard_corpus(corpus, mesh, axis: str = "corpus"):
    """This rank's block of ``corpus`` rows, padded to a multiple of the
    axis size with zero rows, on its device; and the real row count.
    Padding rows score cosine 0, which CAN outrank real negative-cosine
    docs, so the scorer masks pad positions to -inf by row id (``true_m``)
    before the merge."""
    check_mesh(mesh, axis)
    n_shards = axis_size(mesh, axis)
    m = corpus.shape[0]
    rows = -(-m // n_shards)
    lo = min(axis_rank(mesh, axis) * rows, m)
    block = torch.as_tensor(corpus[lo : lo + rows])
    if block.shape[0] < rows:
        pad = block.new_zeros((rows - block.shape[0], block.shape[1]))
        block = torch.cat([block, pad])
    return block.to(mesh_device(mesh)).contiguous(), m


def make_sharded_topk(mesh, k: int, axis: str = "corpus", true_m: int = None):
    """The sharded scorer ``fn(queries, corpus_shard) -> (scores [B, k],
    global ids [B, k])``, replicated on every rank: the local two-phase
    top-k (exact), offset to global ids, merged over the axis's group.
    ``true_m``: the real (unpadded) corpus rows; pad rows are masked to
    -inf before the merge, since their cosine 0 would displace real
    negative-cosine docs."""
    check_mesh(mesh, axis)

    def fn(queries, corpus_shard):
        q = torch.as_tensor(queries, device=corpus_shard.device)
        rows = corpus_shard.shape[0]
        s, i = cosine_topk_twophase(q, corpus_shard, min(k, rows))
        gids = i + axis_rank(mesh, axis) * rows
        if true_m is not None:
            s = torch.where(gids < true_m, s, float("-inf"))
        return gather_topk_merge(s, gids, k, mesh, axis)

    return fn


def sharded_cosine_topk(queries, corpus, k: int, mesh, axis: str = "corpus"):
    """Shard, score, merge: ``(scores, indices into corpus rows)`` as numpy
    arrays on every rank."""
    corpus_shard, true_m = shard_corpus(corpus, mesh, axis)
    s, i = make_sharded_topk(mesh, k, axis, true_m=true_m)(queries, corpus_shard)
    s, i = s.cpu().numpy(), i.cpu().numpy()
    # Pad rows were masked to -inf pre-merge; they can only surface when a
    # shard holds fewer than k real rows. Normalize them to (-inf, -1).
    valid = i < true_m
    return np.where(valid, s, -np.inf), np.where(valid, i, -1)
