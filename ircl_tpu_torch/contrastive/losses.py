"""Contrastive losses: NT-Xent with queue, MoCo InfoNCE, ProtoNCE.

Counterpart of ``ircl_tpu/contrastive/losses.py``, whose math is the
reference's ``NCELoss`` / ``InfoNCE`` (``src/contrastor/contrastive_loss.py``)
with the same arithmetic:

- the diagonal and the positive column leave the negative pool through an
  additive ``-1e9`` mask, not a boolean ``view`` (no data-dependent shapes);
- the queue term is always in the logits, switched by a flag as
  ``ql * flag + (1 - flag) * -1e9``, so enabling the queue at
  ``queue_start_steps`` (reference ``src/train.py:124-130``) changes no shape;
- CE(label=0, reduction='sum') is ``logsumexp(logits) - logits[:, 0]`` summed
  over rows.

``sample_negative_prototypes`` draws from a ``torch.Generator`` on the
tensors' device: it keeps the reference's contract (distinct ids, batch
positives last), not JAX's random bits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_NEG_INF = -1.0e9


def nt_xent_loss(
    q: torch.Tensor,  # [N, D] L2-normalized query embeddings
    k: torch.Tensor,  # [N, D] L2-normalized key embeddings
    temperature: float,
    queue: Optional[torch.Tensor] = None,  # [D, Q] normalized negatives
    use_queue=False,  # flag: a bool, a float, or a 0-dim tensor
) -> torch.Tensor:
    """Symmetric NT-Xent over [q; k] with optional queue negatives
    (reference ``NCELoss._compute_info_loss``, ``contrastive_loss.py:
    56-93``): 2N rows; each row's positive is its cross-view twin, its
    negatives the other 2N-2 batch embeddings plus (optionally)
    ``q @ queue``, the q-side queue logits for both views; CE-sum / 2."""
    n = q.shape[0]
    feats = torch.cat([q, k], dim=0)  # [2N, D]
    sim = feats @ feats.T  # [2N, 2N]

    rows = torch.arange(2 * n, device=q.device)
    pos_col = (rows + n) % (2 * n)
    l_pos = sim[rows, pos_col]  # [2N]

    # the diagonal and the positive column leave the negative pool
    neg_mask = torch.ones((2 * n, 2 * n), dtype=torch.bool, device=q.device)
    neg_mask[rows, rows] = False
    neg_mask[rows, pos_col] = False
    l_neg = torch.where(neg_mask, sim, _NEG_INF)  # [2N, 2N], 2N-2 live

    logits = torch.cat([l_pos[:, None], l_neg], dim=1)

    if queue is not None:
        ql = (q @ queue).repeat(2, 1)  # [2N, Q]: q-side logits for both views
        flag = (use_queue.to(ql.dtype) if isinstance(use_queue, torch.Tensor)
                else float(use_queue))
        ql = ql * flag + (1.0 - flag) * _NEG_INF
        logits = torch.cat([logits, ql], dim=1)

    logits = logits / temperature
    loss_rows = torch.logsumexp(logits, dim=1) - logits[:, 0]
    return loss_rows.sum() / 2.0


def moco_infonce_loss(
    q: torch.Tensor,  # [N, D]
    k: torch.Tensor,  # [N, D]
    queue: torch.Tensor,  # [D, Q]
    temperature: float,
) -> torch.Tensor:
    """MoCo-style InfoNCE (reference ``InfoNCE``, ``contrastive_loss.py:
    20-44``): positive q.k, negatives ``q @ queue``, CE mean."""
    l_pos = (q * k).sum(dim=1, keepdim=True)  # [N, 1]
    l_neg = q @ queue  # [N, Q]
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    loss_rows = torch.logsumexp(logits, dim=1) - logits[:, 0]
    return loss_rows.mean()


def sample_negative_prototypes(
    gen: torch.Generator,  # on pos_ids' device
    num_clusters: int,
    pos_ids: torch.Tensor,  # [N] positive cluster ids of the batch
    num_neg: int,
) -> torch.Tensor:
    """``num_neg`` distinct cluster ids, the batch positives last: a random
    priority per cluster, the positives set to -1, then the top ``num_neg``
    (the reference's ``set`` difference + ``sample``,
    ``contrastive_loss.py:105-110``). Positives come in only when fewer than
    ``num_neg`` other clusters exist."""
    pri = torch.rand(num_clusters, generator=gen, device=pos_ids.device)
    pri[pos_ids.long()] = -1.0
    return torch.topk(pri, num_neg).indices


def proto_loss(
    q: torch.Tensor,  # [N, D]
    batch_cluster_ids: Sequence[torch.Tensor],  # per granularity: [N] ids
    centroids: Sequence[torch.Tensor],  # per granularity: [K_g, D] normalized
    densities: Sequence[torch.Tensor],  # per granularity: [K_g] temperatures
    neg_ids: Sequence[torch.Tensor],  # per granularity: [R] sampled negatives
) -> torch.Tensor:
    """ProtoNCE prototype loss (reference ``_compute_proto_loss``,
    ``contrastive_loss.py:95-135``). Per granularity: logits
    ``q @ [pos_protos; neg_protos]^T`` over per-prototype temperatures (the
    density vector), row i's positive in column i, CE-sum; averaged over the
    granularities. A row's own prototype among the sampled negatives (a
    small corpus or few clusters) is masked to -inf there, so the positive
    never sits in the denominator twice."""
    n = q.shape[0]
    labels = torch.arange(n, device=q.device)
    total = 0.0
    for ids, protos, dens, negs in zip(batch_cluster_ids, centroids, densities, neg_ids):
        ids, negs = ids.long(), negs.long()
        selected = torch.cat([protos[ids], protos[negs]], dim=0)  # [N+R, D]
        logits = q @ selected.T
        temp = torch.cat([dens[ids], dens[negs]], dim=0)  # [N+R]
        logits = logits / temp[None, :]
        own = ids[:, None] == negs[None, :]  # [N, R]
        logits = torch.cat(
            [logits[:, :n], torch.where(own, -torch.inf, logits[:, n:])], dim=1
        )
        row_loss = torch.logsumexp(logits, dim=1) - logits[labels, labels]
        total = total + row_loss.sum()
    return total / len(centroids)
