"""Corpus-sharded hybrid scoring: the df-split index over a device mesh.

Counterpart of ``ircl_tpu/parallel/sharded_hybrid.py``:

- the heavy ELL shards over the ``corpus`` axis, each rank scoring its doc
  range with the small membership slab (kernel #2,
  ``membership_slab_windowed``, on CUDA tensors);
- the light posting pools are routed on the host to the shard that owns
  each doc (``route_light``, carried over line for line), and each rank
  takes its own ``[B, P_s]`` pools;
- each rank runs the exact hybrid merge (``ops/hybrid.py::hybrid_topk``)
  over its local docs, then the (k scores, k global ids) merge over the
  group, as the ELL and dense sharded paths do.

Exactness holds shard by shard (the heavy/light candidate argument applies
within each doc range), and the global merge is a max-k of exact local
top-ks. The reference's ``interpret`` and ``slab_impl`` arguments have no
counterpart: CPU tensors take the plain slab, CUDA tensors the kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ircl_tpu_torch.index.split import SplitIndex
from ircl_tpu_torch.ops.hybrid import hybrid_topk
from ircl_tpu_torch.parallel.common import gather_topk_merge, pad_and_shard_ell_t
from ircl_tpu_torch.parallel.mesh import axis_rank, axis_size, check_mesh, mesh_device
from ircl_tpu_torch.parallel.sharded_index import to_device


class ShardedHybridIndex:
    def __init__(self, split: SplitIndex, mesh, axis: str = "corpus"):
        check_mesh(mesh, axis)
        self.split = split
        self.mesh = mesh
        self.axis = axis
        self.device = mesh_device(mesh)
        self.n_shards = axis_size(mesh, axis)
        self.num_real_docs = split.num_docs
        self.terms_t, self.vals_t, self.rows_per_shard = pad_and_shard_ell_t(
            split.heavy.terms, split.heavy.vals, mesh, axis
        )

    # -- host-side light routing ---------------------------------------------

    def route_light(
        self, light_docs: np.ndarray, light_contribs: np.ndarray, floor: int = 64
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Global [B, P] pools -> per-shard [S, B, P_s] pools with LOCAL doc
        ids (padding = rows_per_shard, i.e. past the local range)."""
        B, Pw = light_docs.shape
        S, rows = self.n_shards, self.rows_per_shard
        shard_of = light_docs // rows  # padding ids (num_docs) land in-range
        valid = light_docs < self.num_real_docs
        shard_of = np.where(valid, shard_of, -1)

        counts = np.zeros((S, B), np.int64)
        for s in range(S):
            counts[s] = (shard_of == s).sum(axis=1)
        p_s = floor
        while p_s < counts.max(initial=0):
            p_s *= 2

        out_d = np.full((S, B, p_s), rows, dtype=np.int32)
        out_c = np.zeros((S, B, p_s), dtype=np.float32)
        order = np.argsort(shard_of, axis=1, kind="stable")  # group by shard
        sd = np.take_along_axis(shard_of, order, axis=1)
        dd = np.take_along_axis(light_docs, order, axis=1)
        cc = np.take_along_axis(light_contribs, order, axis=1)
        for s in range(S):
            m = sd == s
            cols = np.cumsum(m, axis=1) - 1
            rows_idx = np.broadcast_to(np.arange(B)[:, None], m.shape)
            out_d[s, rows_idx[m], cols[m]] = dd[m] - s * rows
            out_c[s, rows_idx[m], cols[m]] = cc[m]
        return out_d, out_c

    # -- device scoring --------------------------------------------------------

    def topk(self, u_sorted, qb_t, qw_t, light_docs, light_contribs, k: int):
        """``(scores [B, k], doc ids [B, k])`` on every rank, empty slots
        ``(0, -1)``."""
        ld, lc = self.route_light(light_docs, light_contribs)
        my = axis_rank(self.mesh, self.axis)
        rows = self.rows_per_shard
        put = lambda x: to_device(x, self.device)  # noqa: E731
        s, i = hybrid_topk(
            self.terms_t, self.vals_t, put(u_sorted), put(qb_t), put(qw_t),
            put(ld[my]), put(lc[my]),
            k=k,
            num_real_docs=rows,  # the local range; the global filter is below
        )
        # docs past this shard's real range leave the merge
        local_real = min(max(self.num_real_docs - my * rows, 0), rows)
        bad = (i < 0) | (i >= local_real)
        s = torch.where(bad, 0.0, s)
        gids = torch.where(bad, -1, i + my * rows).to(torch.int32)
        ms, mi = gather_topk_merge(s, gids, k, self.mesh, self.axis)
        empty = (ms <= 0.0) | (mi < 0)
        return (torch.where(empty, 0.0, ms).cpu().numpy(),
                torch.where(empty, -1, mi).cpu().numpy())
