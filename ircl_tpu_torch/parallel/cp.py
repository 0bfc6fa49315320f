"""Context parallelism (CP): the verdict transformer with its sequence split.

Counterpart of ``ircl_tpu/parallel/cp.py``. The sequence is split over the
``"seq"`` axis of a ``("data", "seq")`` mesh and attention runs as ring
attention (``ops/ring_attention.py``): attention memory a rank drops from
O(L^2) to O(L_local^2), and the key and value blocks travel one hop a step.

- Each rank takes its block of the batch: its ``data`` rows and its
  ``seq`` block of positions. The parameters are replicated.
- The embeddings are position-wise once they know the block's first global
  position (``transformer_embed(pos_start=seq_rank * L_local)``); the
  LayerNorms, residuals and FFN are position-wise too, so only attention
  needs a collective, the ring.
- ``[CLS]`` is global position 0, on seq-rank 0. It is broadcast over
  ``seq`` by an autograd Function whose backward is the broadcast's own
  adjoint (the cotangents summed over ``seq`` onto seq-rank 0, zero on the
  other ranks), and every rank runs the small head.
- Training counts the loss on seq-rank 0 only (the head runs everywhere,
  the term once). Every rank runs the backward, the reverse rings included,
  and the gradients are summed over ``("data", "seq")``, so every rank
  holds the exact global gradient of every leaf, the head and the
  embeddings included. The reference divides its gradients by
  ``data * seq`` before that sum, which only undoes JAX's transpose of
  ``psum``; the port has no such factor to undo.

MoE blocks and ``attention="flash"`` are refused, as the reference refuses
them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ircl_tpu_torch.models.transformer import (
    attention_mask_inputs,
    transformer_block,
    transformer_embed,
)
from ircl_tpu_torch.parallel.common import all_gather_rows
from ircl_tpu_torch.parallel.mesh import (
    axis_groups,
    axis_rank,
    axis_size,
    check_mesh,
    group_size,
    make_mesh,
    mesh_device,
)
from ircl_tpu_torch.utils.precision import float32_precision
from ircl_tpu_torch.utils.tree import tree_leaves, tree_unflatten, value_and_grad
from ircl_tpu_torch.verdict.model import VerdictConfig, VerdictOptimizer, verdict_head


def make_cp_mesh(seq: Optional[int] = None, data: int = 1, device=None):
    """``("data", "seq")`` mesh; defaults to data = 1, seq = every rank. A
    mesh of fewer ranks than the group runs as replicas
    (``parallel/mesh.py::make_mesh``)."""
    if seq is None:
        seq = group_size(device) // data
    return make_mesh(("data", "seq"), (data, seq), device)


def _check(cfg: VerdictConfig) -> None:
    if cfg.encoder.moe is not None:
        raise ValueError("CP does not compose with MoE (see module doc)")
    if cfg.encoder.attention == "flash":
        raise ValueError("CP rings the XLA attention path, not flash")


def _block(mesh, *arrays):
    """This rank's block of each whole ``[B, ...]`` array: its ``data`` rows
    and, for arrays of two dimensions or more, its ``seq`` block of
    columns, as tensors on the mesh's device."""
    d, n_d = axis_rank(mesh, "data"), axis_size(mesh, "data")
    s, n_s = axis_rank(mesh, "seq"), axis_size(mesh, "seq")
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.shape[0] % n_d:
            raise ValueError(f"batch {t.shape[0]} does not divide over data axis {n_d}")
        t = t.chunk(n_d)[d]
        if t.dim() > 1:
            if t.shape[1] % n_s:
                raise ValueError(f"length {t.shape[1]} does not divide over seq axis {n_s}")
            t = t.chunk(n_s, dim=1)[s]
        out.append(t.contiguous().to(mesh_device(mesh)))
    return out


class _BroadcastFirst(torch.autograd.Function):
    """Seq-rank 0's ``x`` on every rank of the axis. Backward: the ranks'
    cotangents summed onto seq-rank 0; the other ranks' ``x`` took no
    part, so their gradient is zero."""

    @staticmethod
    def forward(ctx, x, group, first: bool):
        ctx.group, ctx.first = group, first
        buf = x.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return (g if ctx.first else torch.zeros_like(g)), None, None


def _cp_logits(params, cfg: VerdictConfig, ids, mask, type_ids, mesh):
    """This rank's ``[B_l, L_l]`` block -> the logits of its rows
    ``[B_l, num_labels]``, the same on every rank of ``seq``."""
    enc = cfg.encoder
    s = axis_rank(mesh, "seq")
    x = transformer_embed(params["body"], enc, ids, type_ids, pos_start=s * ids.shape[1])
    attn_ctx = attention_mask_inputs(enc, mask)  # the local block's pad bias
    for lp in params["body"]["layers"]:
        x = transformer_block(x, lp, enc, attn_ctx, seq_axis="seq", mesh=mesh)
    cls = x[:, 0, :]
    if axis_size(mesh, "seq") > 1:
        cls = _BroadcastFirst.apply(cls, mesh.get_group("seq"), s == 0)
    return verdict_head(params, cls)


def make_cp_verdict_forward(cfg: VerdictConfig, mesh):
    """``(params, ids, mask, type_ids) -> logits [B, num_labels]`` with the
    sequence split over ``mesh``'s ``"seq"`` axis. Every rank takes the
    whole batch and runs its block of it; every rank returns the whole
    batch's logits, which equal the single-device ``verdict_apply``'s up
    to f32 reassociation (the online softmax)."""
    _check(cfg)
    check_mesh(mesh, "seq")

    @torch.no_grad()
    def forward(params, ids, mask, type_ids):
        ids, mask, type_ids = _block(mesh, ids, mask, type_ids)
        with float32_precision():
            logits = _cp_logits(params, cfg, ids.long(), mask.float(), type_ids.long(), mesh)
        if axis_size(mesh, "data") > 1:
            logits = torch.cat(all_gather_rows(logits, mesh, "data"))
        return logits

    return forward


class _Adam(VerdictOptimizer):
    """``optax.adam(learning_rate)`` over the parameter tree: b1 0.9, b2
    0.999, eps 1e-8, bias correction, a constant step, no weight decay
    (``VerdictOptimizer``'s arithmetic with the decay and the schedule
    taken out)."""

    weight_decay = 0.0

    def __init__(self, learning_rate: float = 1e-3):
        self.lr = learning_rate

    def learning_rate(self, count: int) -> float:
        return self.lr


def make_cp_verdict_grad_fn(cfg: VerdictConfig, mesh):
    """``fn(params, ids, mask, type_ids, labels) -> (loss, grads)``: the
    mean cross-entropy of the whole batch, which every rank takes, and its
    exact gradient of every leaf, on every rank. Each rank runs its block;
    the loss counts on seq-rank 0 only (the head runs everywhere, the term
    once), and the gradients and the loss are summed over ``("data",
    "seq")`` in one flat all-reduce."""
    _check(cfg)
    check_mesh(mesh, "seq")
    groups = axis_groups(mesh, "data", "seq")
    first = axis_rank(mesh, "seq") == 0
    share = 1.0 / axis_size(mesh, "data")

    def loss_fn(params, ids, mask, type_ids, labels):
        logits = _cp_logits(params, cfg, ids, mask, type_ids, mesh)
        # the other ranks' zero still carries their backward, whose
        # reverse rings every rank runs
        return F.cross_entropy(logits.float(), labels) * (share if first else 0.0), None

    def fn(params, ids, mask, type_ids, labels):
        ids, mask, type_ids, labels = _block(mesh, ids, mask, type_ids, labels)
        with float32_precision():
            loss, _, grads = value_and_grad(loss_fn, params, ids.long(), mask.float(),
                                            type_ids.long(), labels.long())
        leaves = tree_leaves(grads)
        flat = torch.cat([g.reshape(-1) for g in leaves] + [loss.reshape(1)])
        for group in groups:
            dist.all_reduce(flat, group=group)
        out = torch.split(flat[:-1], [g.numel() for g in leaves])
        return flat[-1], tree_unflatten(grads, [o.view_as(g) for o, g in zip(out, leaves)])

    return fn


def make_cp_verdict_train_step(cfg: VerdictConfig, mesh, tx=None):
    """``(step, tx)``. ``step(params, opt_state, ids, mask, type_ids,
    labels) -> (params, opt_state, loss)`` takes one optimizer step on the
    mean cross-entropy of the whole batch, which every rank takes
    (``make_cp_verdict_grad_fn``); the parameters and the state are
    replicated and updated in place, and the loss is the whole batch's.
    ``tx`` defaults to Adam(1e-3), as the reference's does;
    ``make_verdict_optimizer(cfg)`` gives the verdict model's AdamW and
    schedule."""
    tx = tx if tx is not None else _Adam(1e-3)
    grad_fn = make_cp_verdict_grad_fn(cfg, mesh)

    def step(params, opt_state, ids, mask, type_ids, labels):
        loss, grads = grad_fn(params, ids, mask, type_ids, labels)
        tx.update_(params, grads, opt_state)
        return params, opt_state, loss

    return step, tx
