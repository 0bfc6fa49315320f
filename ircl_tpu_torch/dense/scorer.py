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
``make_sharded_topk``, ``sharded_cosine_topk``) waits for ROADMAP.md
queue 1 item 12.
"""

from __future__ import annotations

import torch

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


def _not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} (the corpus-sharded scorer) is not ported yet "
        "(ROADMAP.md queue 1 item 12)"
    )


def shard_corpus(corpus, mesh, axis: str = "corpus"):
    raise _not_ported("shard_corpus")


def make_sharded_topk(mesh, k: int, axis: str = "corpus", true_m: int = None):
    raise _not_ported("make_sharded_topk")


def sharded_cosine_topk(queries, corpus, k: int, mesh, axis: str = "corpus"):
    raise _not_ported("sharded_cosine_topk")
