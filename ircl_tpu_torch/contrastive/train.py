"""The contrastive train step and the encoder's inference path.

Counterpart of ``ircl_tpu/contrastive/train.py``. One call of the step
covers the reference's inner loop (``src/train.py:86-175``), in the
reference's order:

1. per micro-batch: the frozen featurizer without autograd (the reference
   runs BERT under ``torch.no_grad``, ``contrastive_module.py:36-41``); q
   from ``params_q``; k from ``params_k`` without autograd when
   ``use_momentum``, else from ``params_q`` with it; the loss over the
   effective batch (``loss / acml_batch_size``, ``src/train.py:137-146``),
   its gradient; then the keys enqueued, so that the next micro-batch sees
   them (``_dequeue_and_enqueue`` runs inside each forward there);
2. the gradients summed, their global norm, one optimizer update (clip
   included), and last the EMA of the key encoder from the updated query
   encoder (``contrastive_module.py:43-53``).

The queue term is switched on at ``queue_start_steps`` by a flag the host
computes from ``state.step``: no shape changes. The step reads nothing back
from the device; it runs in full fp32 (``float32_precision``), or with TF32
products under ``compute_dtype="bfloat16"``, where the encoder's operands
are bf16 and so exact in TF32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ircl_tpu_torch.contrastive.losses import nt_xent_loss, proto_loss
from ircl_tpu_torch.contrastive.state import (
    TrainConfig, TrainState, global_norm, make_optimizer,
)
from ircl_tpu_torch.models.encoder import seq2vec
from ircl_tpu_torch.utils.precision import float32_precision
from ircl_tpu_torch.utils.tree import (
    tree_leaves, tree_leaves_like, tree_unflatten, value_and_grad,
)

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _enqueue(
    queue: torch.Tensor, ptr: int, keys: torch.Tensor, queue_size: int
) -> Tuple[torch.Tensor, int]:
    """Ring-buffer write of ``keys [N, D]`` at column ``ptr`` of ``queue``,
    in place (reference ``_dequeue_and_enqueue``,
    ``contrastive_module.py:55-68``); returns the queue and the next
    pointer. bf16 keys are cast into the f32 queue."""
    n = keys.shape[0]
    queue[:, ptr : ptr + n] = keys.T.to(queue.dtype)
    return queue, (ptr + n) % queue_size


def ema_update(params_k, params_q, momentum: float):
    """The key encoder's EMA ``pk * m + pq * (1 - m)``, a new tree."""
    out = torch._foreach_mul(tree_leaves(params_k), momentum)
    torch._foreach_add_(out, tree_leaves_like(params_k, params_q), alpha=1.0 - momentum)
    return tree_unflatten(params_k, out)


def make_train_step(config: TrainConfig, featurizer):
    """``step(state, ids_a, mask_a, ids_k, mask_k, proto=None) -> (state,
    loss_sum, grad_norm)`` on the featurizer's device, where ``state`` must
    lie. Ids and masks of the anchor and positive views are ``[accum,
    micro, L]`` arrays or tensors. ``proto``, for ProtoNCE, is ``(cluster
    ids, centroids, densities, negative ids)``: per granularity ``[accum,
    micro]`` ids, ``[K, D]`` centroids, ``[K]`` densities, ``[R]`` sampled
    negatives. The loss sum and the gradients' global norm are 0-dim
    tensors left on the device; the given state is not changed."""
    return build_train_step(config, featurizer)


def build_train_step(config: TrainConfig, featurizer, gather_rows=None,
                     reduce_grads=None):
    """``make_train_step``'s step with the data-parallel hooks of
    ``parallel/dp.py``: ``gather_rows`` maps this rank's ``[b, D]``
    embeddings to the global micro-batch's ``[B, D]`` (the losses and the
    queue see the global batch), and ``reduce_grads`` sums the ranks'
    gradient trees before the global norm and the update. ``None``: one
    device."""
    tx = make_optimizer(config)
    enc_cfg = config.encoder
    eff_batch = config.micro_batch * config.accum_steps
    if config.use_queue and config.queue_size % config.micro_batch != 0:
        # The reference SILENTLY skips the ring-buffer write in this case
        # (contrastive_module.py:59) — training would then run forever
        # against the frozen random-init queue while the queue term stays
        # in the loss. Deliberate deviation: fail fast instead.
        raise ValueError(
            f"queue_size ({config.queue_size}) must be a multiple of "
            f"micro_batch ({config.micro_batch}) when use_queue=True; "
            "otherwise keys are never enqueued and the loss trains against "
            "the random-init queue"
        )
    if config.compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype: {config.compute_dtype!r}")
    compute_dtype = _COMPUTE_DTYPES[config.compute_dtype]
    device = featurizer.device

    def micro_loss(params_q, params_k, queue, use_queue_flag, batch, proto):
        ids_a, mask_a, ids_k, mask_k = batch
        with torch.no_grad():
            feats_a = featurizer.apply(featurizer.params, ids_a, mask_a)
            feats_k = featurizer.apply(featurizer.params, ids_k, mask_k)
        # mixed precision: the encoder's products follow the features'
        # dtype; losses, normalization and the optimizer stay f32
        feats_a, feats_k = feats_a.to(compute_dtype), feats_k.to(compute_dtype)
        q = seq2vec(params_q, enc_cfg, feats_a, mask_a)
        if config.use_momentum:
            with torch.no_grad():
                k = seq2vec(params_k, enc_cfg, feats_k, mask_k)
        else:
            k = seq2vec(params_q, enc_cfg, feats_k, mask_k)
        if gather_rows is not None:
            q, k = gather_rows(q), gather_rows(k)
        loss = nt_xent_loss(
            q, k, config.temperature,
            queue=queue if config.use_queue else None,
            use_queue=use_queue_flag,
        )
        if proto is not None:
            loss = loss + proto_loss(q, *proto)
        return loss / eff_batch, k.detach()

    def train_step(
        state: TrainState, ids_a, mask_a, ids_k, mask_k, proto: Optional[tuple] = None,
    ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
        ids_a, ids_k = (torch.as_tensor(t, dtype=torch.int32, device=device)
                        for t in (ids_a, ids_k))
        mask_a, mask_k = (torch.as_tensor(t, dtype=torch.float32, device=device)
                          for t in (mask_a, mask_k))
        use_queue_flag = float(state.step >= config.queue_start_steps)
        queue, ptr = state.queue, state.queue_ptr
        if config.use_queue:
            queue = queue.clone()  # written in place below
        grads = loss_sum = None
        with float32_precision(tf32=compute_dtype == torch.bfloat16):
            for a in range(config.accum_steps):
                p = None
                if proto is not None:
                    cluster_ids, centroids, densities, neg_ids = proto
                    p = ([ids[a] for ids in cluster_ids], centroids, densities, neg_ids)
                loss, k, g = value_and_grad(
                    micro_loss, state.params_q, state.params_k, queue,
                    use_queue_flag, (ids_a[a], mask_a[a], ids_k[a], mask_k[a]), p,
                )
                if config.use_queue:
                    queue, ptr = _enqueue(queue, ptr, k, config.queue_size)
                if grads is None:
                    grads, loss_sum = g, loss
                else:
                    torch._foreach_add_(tree_leaves(grads), tree_leaves_like(grads, g))
                    loss_sum = loss_sum + loss
            if reduce_grads is not None:
                grads = reduce_grads(grads)
            grad_norm = global_norm(tree_leaves(grads))
            params_q, opt_state = tx.update(state.params_q, grads, state.opt_state,
                                            grad_norm)
            params_k = (ema_update(state.params_k, params_q, config.momentum)
                        if config.use_momentum else state.params_k)
        new_state = TrainState(
            params_q=params_q,
            params_k=params_k,
            opt_state=opt_state,
            queue=queue,
            queue_ptr=ptr,
            step=state.step + 1,
        )
        return new_state, loss_sum, grad_norm

    return train_step


def make_embed_fn(config: TrainConfig, featurizer):
    """Text features -> normalized embeddings: ``call(params_q, ids, mask)``
    takes host ``(ids, mask)`` arrays (``featurizer.encode_host``), runs the
    frozen featurizer and ``seq2vec`` on the featurizer's device without
    autograd and in full fp32, and returns a ``[B, output_size]`` tensor
    there (the reference's ``ctx2vec``, ``contrastive_module.py:96-100``).
    ``params_q`` are the encoder's parameters on that device."""

    def call(params_q, ids, mask):
        with torch.no_grad(), float32_precision():
            feats = featurizer.features(ids, mask)
            mask_t = torch.as_tensor(mask, dtype=torch.float32, device=feats.device)
            return seq2vec(params_q, config.encoder, feats, mask_t)

    return call
