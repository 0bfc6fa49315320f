"""Corpus-sharded sparse scoring: the ELL engine over a device mesh.

Counterpart of ``ircl_tpu/parallel/sharded_index.py``. The ELL rows
(documents) shard over the ``corpus`` axis; the query batch and its union
are replicated. Each rank builds the membership slabs of its doc shard and
of the queries (kernel #1, ``csrc/membership_slab.cu``, on CUDA tensors),
scores them with one full-fp32 product, takes a local top-k, offsets it to
global doc ids and merges over the group (``common.gather_topk_merge``).
The score matrix never leaves its rank.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ircl_tpu_torch.ops.membership_cuda import membership_slab, scores_matmul
from ircl_tpu_torch.parallel.common import gather_topk_merge, pad_and_shard_ell_t
from ircl_tpu_torch.parallel.mesh import axis_rank, check_mesh, mesh_device


def to_device(x, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


class ShardedEllIndex:
    """This rank's shard of an ELL index and the sharded top-k over it."""

    def __init__(self, ell, mesh, axis: str = "corpus"):
        check_mesh(mesh, axis)
        self.mesh = mesh
        self.axis = axis
        self.device = mesh_device(mesh)
        self.num_real_docs = ell.num_docs
        self.terms_t, self.vals_t, self.rows_per_shard = pad_and_shard_ell_t(
            ell.terms, ell.vals, mesh, axis
        )

    def topk(
        self,
        u_sorted: np.ndarray,  # [U] int32 union slots
        qb_t: np.ndarray,  # [T8, B_pad] int32 query buckets
        qw_t: np.ndarray,  # [T8, B_pad] f32 query weights
        k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """``(scores [B_pad, k], doc ids [B_pad, k])`` on every rank, empty
        slots ``(0, -1)``."""
        u, qb, qw = (to_device(x, self.device) for x in (u_sorted, qb_t, qw_t))
        rows = self.rows_per_shard
        u_tile = min(512, u.shape[0])
        m = membership_slab(u, self.terms_t, self.vals_t, u_tile=u_tile,
                            d_tile=256)  # [U, rows]
        wt = membership_slab(u, qb, qw, u_tile=u_tile, d_tile=128)  # [U, B]
        scores = scores_matmul(wt.T, m)  # [B, rows], full fp32
        s, i = torch.topk(scores, min(k, rows), dim=1)
        gids = i.to(torch.int32) + axis_rank(self.mesh, self.axis) * rows
        ms, mi = gather_topk_merge(s, gids, k, self.mesh, self.axis)
        empty = (ms <= 0.0) | (mi >= self.num_real_docs)
        return (torch.where(empty, 0.0, ms).cpu().numpy(),
                torch.where(empty, -1, mi).cpu().numpy())
