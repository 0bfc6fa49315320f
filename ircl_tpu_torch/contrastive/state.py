"""Contrastive training configuration, optimizer and state.

Counterpart of ``ircl_tpu/contrastive/state.py``. The reference holds the
queue, its pointer and the momentum encoder as module buffers mutated under
``torch.no_grad`` (``src/contrastor/contrastive_module.py:24-68``); here, as
in the JAX package, all of it is one ``TrainState`` that the train step
takes and returns. ``queue_ptr`` and ``step`` are host ints: the pointer
advances by ``micro_batch`` a micro-step and the step by one, so the host
knows both without reading the device.

``ContrastiveOptimizer`` is the JAX package's optax chain written out over
the parameter tree, as ``verdict/model.py::VerdictOptimizer`` does for
AdamW: ``clip_by_global_norm(grad_clip)``, then Adam (``src/model.py:52-57``)
or SGD with weight decay, momentum and cosine decay (``src/train.py:18-23``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import torch

from ircl_tpu_torch.models.encoder import EncoderConfig, init_encoder_params
from ircl_tpu_torch.utils.device import resolve_device
from ircl_tpu_torch.utils.tree import (
    tree_leaves, tree_leaves_like, tree_map, tree_unflatten,
)


@dataclass(frozen=True)
class TrainConfig:
    encoder: EncoderConfig = EncoderConfig()
    loss: str = "InfoNCE"  # InfoNCE | ProtoNCE | HProtoNCE
    temperature: float = 0.05
    use_momentum: bool = True
    momentum: float = 0.9
    use_queue: bool = True
    queue_size: int = 12544
    queue_start_steps: int = 5000
    optimizer: str = "adam"  # adam | sgd
    learning_rate: float = 2.5e-4
    adam_betas: tuple = (0.9, 0.999)
    sgd_momentum: float = 0.9
    sgd_weight_decay: float = 1e-4
    grad_clip: float = 1.0
    total_steps: int = 100_000
    micro_batch: int = 128
    accum_steps: int = 2  # effective batch = micro_batch * accum_steps
    # ProtoNCE
    cluster_start_steps: int = 8000
    cluster_update_steps: int = 4000
    num_clusters: tuple = (4096, 6144, 8192)
    num_neg_proto: int = 3072
    # "bfloat16" runs encoder matmuls in bf16 (params and loss stay f32).
    compute_dtype: str = "float32"


@dataclass
class TrainState:
    params_q: Any
    params_k: Any
    opt_state: Dict[str, Any]
    queue: torch.Tensor  # [D, Q] L2-normalized negatives
    queue_ptr: int
    step: int


def global_norm(leaves) -> torch.Tensor:
    """The square root of the sum of every leaf's squared elements."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


class ContrastiveOptimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), tx)`` over the parameter
    tree, where ``tx`` is

    - ``adam``: ``optax.adam(learning_rate, b1, b2)``, eps 1e-8, bias
      correction; the state is ``{"count", "mu", "nu"}``;
    - ``sgd``: ``add_decayed_weights(sgd_weight_decay)``, then a
      ``sgd_momentum`` trace, then the step ``-cosine_decay(learning_rate,
      total_steps)`` at the schedule's own count, which starts at 0; the
      state is ``{"count", "trace"}``.

    The clip scales by ``grad_clip / norm`` only where ``norm >= grad_clip``,
    as ``(g / norm) * grad_clip``; ``torch.nn.utils.clip_grad_norm_``
    (``max_norm / (norm + 1e-6)`` always) is another function. ``update``
    changes nothing it is given and reads nothing back from the device."""

    eps = 1e-8

    def __init__(self, config: TrainConfig):
        if config.optimizer not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer: {config.optimizer}")
        self.config = config

    def learning_rate(self, count: int) -> float:
        """The step size at ``count``: constant for Adam, cosine-decayed to 0
        over ``total_steps`` for SGD."""
        cfg = self.config
        if cfg.optimizer == "adam":
            return cfg.learning_rate
        c = min(count, cfg.total_steps)
        return cfg.learning_rate * 0.5 * (1.0 + math.cos(math.pi * c / cfg.total_steps))

    def init(self, params) -> Dict[str, Any]:
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        if self.config.optimizer == "adam":
            return {"count": 0, "mu": zeros(), "nu": zeros()}
        return {"count": 0, "trace": zeros()}

    def update(self, params, grads, opt_state, grad_norm=None):
        """(new params, new state) from the summed gradients; ``grad_norm``,
        their global norm, is computed when not given."""
        cfg = self.config
        p, g = tree_leaves(params), tree_leaves_like(params, grads)
        norm = global_norm(g) if grad_norm is None else grad_norm
        one = torch.ones_like(norm)
        keep = norm < cfg.grad_clip
        g = torch._foreach_div(g, torch.where(keep, one, norm))
        torch._foreach_mul_(g, torch.where(keep, one, one * cfg.grad_clip))
        count = opt_state["count"]
        lr = self.learning_rate(count)
        if cfg.optimizer == "adam":
            b1, b2 = cfg.adam_betas
            mu = torch._foreach_mul(tree_leaves_like(params, opt_state["mu"]), b1)
            torch._foreach_add_(mu, g, alpha=1.0 - b1)
            nu = torch._foreach_mul(tree_leaves_like(params, opt_state["nu"]), b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
            denom = torch._foreach_div(nu, 1.0 - b2 ** (count + 1))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            step = torch._foreach_div(mu, 1.0 - b1 ** (count + 1))
            torch._foreach_div_(step, denom)
            new_state = {"count": count + 1, "mu": tree_unflatten(params, mu),
                         "nu": tree_unflatten(params, nu)}
        else:
            torch._foreach_add_(g, p, alpha=cfg.sgd_weight_decay)
            step = torch._foreach_mul(tree_leaves_like(params, opt_state["trace"]),
                                      cfg.sgd_momentum)
            torch._foreach_add_(step, g)
            new_state = {"count": count + 1, "trace": tree_unflatten(params, step)}
        return tree_unflatten(params, torch._foreach_add(p, step, alpha=-lr)), new_state


def make_optimizer(config: TrainConfig) -> ContrastiveOptimizer:
    """Adam or SGD with cosine decay, after global-norm clipping; see
    ``ContrastiveOptimizer``."""
    return ContrastiveOptimizer(config)


def init_train_state(gen_or_seed, config: TrainConfig, device=None) -> TrainState:
    """A fresh state on ``device`` (by default the card): encoder parameters,
    then the ``[output_size, queue_size]`` queue of normal draws normalized
    per column, all drawn on the CPU from one ``torch.Generator`` (given,
    or seeded with the given int), so one seed gives the same state on
    every device; ``params_k`` a copy of ``params_q``."""
    device = resolve_device(device)
    gen = (gen_or_seed if isinstance(gen_or_seed, torch.Generator)
           else torch.Generator().manual_seed(int(gen_or_seed)))
    params_q = init_encoder_params(gen, config.encoder, device=device)
    queue = torch.randn((config.encoder.output_size, config.queue_size), generator=gen)
    queue = queue / torch.linalg.vector_norm(queue, dim=0, keepdim=True)
    return TrainState(
        params_q=params_q,
        params_k=tree_map(torch.clone, params_q),
        opt_state=make_optimizer(config).init(params_q),
        queue=queue.to(device),
        queue_ptr=0,
        step=0,
    )
