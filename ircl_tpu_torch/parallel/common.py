"""Shared building blocks of the corpus-sharded scorers.

Counterpart of ``ircl_tpu/parallel/common.py``. ``ShardedEllIndex``,
``ShardedHybridIndex`` and the sharded dense scorer share one layout and one
merge: doc-major ELL transposed to ``[K, N]``, K padded to 8 and N to
``shards * 256``, each rank keeping its own column block; then a local top-k
whose (scores, global ids) are all-gathered over the axis's group and
re-top-k'd on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ircl_tpu_torch.parallel.mesh import axis_rank, axis_size, mesh_device


def pad_and_shard_ell_t(ell_terms, ell_vals, mesh, axis: str):
    """``[N, K]`` ELL -> this rank's block of the transposed
    ``[K_pad, N_pad]`` arrays, on its device. Returns ``(terms_t, vals_t,
    rows_per_shard)``. K pads to 8 with -1 terms; N pads to
    ``shards * 256`` with empty docs."""
    n_shards = axis_size(mesh, axis)
    terms_t = np.ascontiguousarray(ell_terms.T)  # [K, N]
    vals_t = np.ascontiguousarray(ell_vals.T)
    k_w, n = terms_t.shape
    k_pad = -(-k_w // 8) * 8 - k_w
    chunk = n_shards * 256
    n_pad = -(-n // chunk) * chunk - n
    terms_t = np.pad(terms_t, ((0, k_pad), (0, n_pad)), constant_values=-1)
    vals_t = np.pad(vals_t, ((0, k_pad), (0, n_pad)), constant_values=0.0)
    rows = terms_t.shape[1] // n_shards
    lo = axis_rank(mesh, axis) * rows
    cols = slice(lo, lo + rows)
    dev = mesh_device(mesh)
    return (
        torch.tensor(np.ascontiguousarray(terms_t[:, cols]), device=dev),
        torch.tensor(np.ascontiguousarray(vals_t[:, cols]), device=dev),
        rows,
    )


def all_gather_rows(x: torch.Tensor, mesh, axis: str) -> list:
    """Every rank's ``x`` along ``axis``, in rank order (``x``'s shape on
    every rank)."""
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(axis))
    return parts


def replicate(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The axis's first rank's ``x``, on every rank, in a new tensor of
    ``x``'s strides (the collectives take contiguous tensors; a layout can
    change which kernel a product takes, and so its bits)."""
    buf = x.clone(memory_format=torch.contiguous_format)
    src = int(mesh[axis].mesh.flatten()[0])  # the axis's first rank, globally
    dist.broadcast(buf, src=src, group=mesh.get_group(axis))
    return buf if x.is_contiguous() else torch.empty_like(x).copy_(buf)


def gather_topk_merge(s: torch.Tensor, gids: torch.Tensor, k: int, mesh, axis: str):
    """Merge the ranks' local top-k: all-gather the small ``[B, kk]``
    (scores, global ids), then one narrow top-k. Each row's candidates lie
    shard-major, as the reference's ``moveaxis(0, 1).reshape`` lays them,
    so ties meet the top-k in the same order."""
    b = s.shape[0]
    all_s = torch.stack(all_gather_rows(s, mesh, axis), dim=1).reshape(b, -1)
    all_i = torch.stack(all_gather_rows(gids, mesh, axis), dim=1).reshape(b, -1)
    ms, midx = torch.topk(all_s, min(k, all_s.shape[1]), dim=1)
    return ms, torch.gather(all_i, 1, midx)
