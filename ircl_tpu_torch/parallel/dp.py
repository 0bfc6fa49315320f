"""Data-parallel contrastive training over a device mesh.

Counterpart of ``ircl_tpu/parallel/dp.py``. The global batch shards over the
``data`` axis; parameters, optimizer state, queue and pointer are
replicated. The step is ``contrastive/train.py``'s, with two hooks where the
reference's GSPMD inserts its collectives:

- each rank embeds its rows of a micro-batch, and the embeddings are
  all-gathered in rank order, so NT-Xent's similarity matrix, the ProtoNCE
  term and the queue's enqueue cover the global micro-batch in global row
  order (the same math as one device, not local negatives). The other
  ranks' rows arrive detached and this rank's stay live, so each rank's
  gradient holds exactly its own rows' share of the global loss's;
- the ranks' gradients are summed (one all-reduce of one flat buffer)
  before the global norm, the clip and the update, which then run alike on
  every rank. The loss is the global loss on every rank.

ProtoNCE inputs ride along: the batch's cluster ids shard with the batch and
are gathered back in the step; centroids, densities and the negative draw
are replicated.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from ircl_tpu_torch.contrastive.state import TrainConfig, TrainState
from ircl_tpu_torch.contrastive.train import build_train_step
from ircl_tpu_torch.parallel.common import all_gather_rows, replicate
from ircl_tpu_torch.parallel.mesh import axis_rank, axis_size, check_mesh
from ircl_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def make_dp_train_step(config: TrainConfig, featurizer, mesh, axis: str = "data"):
    """DP step over batch arrays ``[A, B, L]`` whose ``B`` rows shard
    rank-major in contiguous blocks. Returns ``(step, place_state,
    place_batch, place_proto)``: ``place_state`` replicates rank 0's state,
    ``place_batch`` and ``place_proto`` keep this rank's rows of the global
    arrays, on the featurizer's device."""
    check_mesh(mesh, axis)
    n = axis_size(mesh, axis)
    rank = axis_rank(mesh, axis)
    group = mesh.get_group(axis)
    device = featurizer.device
    if config.micro_batch % n:
        raise ValueError(f"micro_batch {config.micro_batch} does not divide "
                         f"over {n} ranks")
    part = config.micro_batch // n
    lo = rank * part  # this rank's first row of a micro-batch

    def gather_rows(x: torch.Tensor) -> torch.Tensor:
        parts = all_gather_rows(x.detach(), mesh, axis)
        parts[rank] = x
        return torch.cat(parts)

    def reduce_grads(grads):
        leaves = tree_leaves(grads)
        flat = torch.cat([g.reshape(-1) for g in leaves])
        dist.all_reduce(flat, group=group)
        out = torch.split(flat, [g.numel() for g in leaves])
        return tree_unflatten(grads, [o.view_as(g) for o, g in zip(out, leaves)])

    raw_step = build_train_step(config, featurizer, gather_rows, reduce_grads)

    def rank0s(x):
        return replicate(x, mesh, axis) if isinstance(x, torch.Tensor) else x

    def place_state(state: TrainState) -> TrainState:
        return TrainState(
            params_q=tree_map(rank0s, state.params_q),
            params_k=tree_map(rank0s, state.params_k),
            opt_state=tree_map(rank0s, state.opt_state),
            queue=rank0s(state.queue),
            queue_ptr=state.queue_ptr,
            step=state.step,
        )

    def local_rows(a):
        """``[A, B, ...]`` -> this rank's ``[A, B / n, ...]`` on the device."""
        a = torch.as_tensor(a)
        if a.shape[1] != config.micro_batch:
            raise ValueError(f"{a.shape[1]} rows where the global micro-batch "
                             f"has {config.micro_batch}")
        return a[:, lo : lo + part].to(device)

    def place_batch(*arrays):
        return tuple(local_rows(a) for a in arrays)

    def place_proto(proto):
        """(cluster_ids [G][A, B], centroids, densities, neg_ids): the ids
        keep this rank's rows; the prototype tables stay whole."""
        if proto is None:
            return None
        cluster_ids, centroids, densities, neg_ids = proto
        whole = lambda t: [torch.as_tensor(x, device=device) for x in t]  # noqa: E731
        return ([local_rows(i) for i in cluster_ids], whole(centroids),
                whole(densities), whole(neg_ids))

    def step(state, ids_a, mask_a, ids_k, mask_k, proto: Optional[Any] = None):
        if proto is not None:
            cluster_ids, centroids, densities, neg_ids = proto
            cluster_ids = [gather_rows(i.T.contiguous()).T for i in cluster_ids]
            proto = (cluster_ids, centroids, densities, neg_ids)
        return raw_step(state, ids_a, mask_a, ids_k, mask_k, proto)

    return step, place_state, place_batch, place_proto
