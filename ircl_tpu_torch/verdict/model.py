"""Verdict classifier: transformer encoder + roberta-style head, on tensors.

Counterpart of ``ircl_tpu/verdict/model.py``, the reference's
``RoBertaClassifier`` (``src/QA/model.py:10-37``): sequence classification
over (claim, evidence) pairs, SUPPORTS=1 / REFUTES=0, with a two-layer tanh
head over the [CLS] position. Parameters are the JAX package's tree
(``body``, ``head_dense``, ``head_out``; dense weights ``[in, out]``), so
``utils/convert.py::verdict_params_from_numpy`` carries trained weights
across unchanged.

Ported: the forward that serving runs (``verdict_apply``, without
autograd) and the training half in float32: ``verdict_apply_with_aux``
under autograd, ``make_verdict_optimizer`` (AdamW with linear warmup and
linear decay, optax's arithmetic written out over the parameter tree) and
``make_verdict_train_step``. The reference freezes the transformer body
until ``warmup_steps`` (``model.py:24-28``) with a 0/1 multiplier on the
body's gradients and on its updates; the step here does the same, so a
frozen body stays bit for bit what it was. With ``attention="flash"`` the
gradient of every layer's attention comes from the backward kernels of
``ops/flash_attention_cuda.py``. Left of ROADMAP.md queue 1 item 11: bf16
training. The MoE aux loss waits for item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ircl_tpu_torch.models.transformer import (
    TransformerConfig,
    _dense_init,
    init_transformer_params,
    transformer_apply_with_aux,
)
from ircl_tpu_torch.utils.convert import to_device
from ircl_tpu_torch.utils.device import resolve_device
from ircl_tpu_torch.utils.precision import float32_precision
from ircl_tpu_torch.utils.tree import tree_leaves, tree_map, value_and_grad


@dataclasses.dataclass(frozen=True)
class VerdictConfig:
    encoder: TransformerConfig = TransformerConfig()
    num_labels: int = 2
    learning_rate: float = 1e-5
    warmup_steps: int = 5000
    total_steps: int = 50_000
    freeze_body_until_warmup: bool = True
    max_length: int = 512
    # weight on the MoE load-balance aux loss (only if encoder.moe is set)
    moe_aux_weight: float = 0.01


def init_verdict_params(
    gen: torch.Generator, cfg: VerdictConfig, device=None
) -> Dict[str, Any]:
    """N(0, 0.02) weights and zero biases for the body and both head
    layers, drawn from ``gen`` on the CPU and moved to ``device`` (by default
    the card)."""
    device = resolve_device(device)
    h = cfg.encoder.hidden
    params = {
        "body": init_transformer_params(gen, cfg.encoder, "cpu"),
        "head_dense": {"w": _dense_init(gen, (h, h)), "b": torch.zeros(h)},
        "head_out": {
            "w": _dense_init(gen, (h, cfg.num_labels)),
            "b": torch.zeros(cfg.num_labels),
        },
    }
    return to_device(params, device)


def verdict_head(params: Dict[str, Any], cls: torch.Tensor) -> torch.Tensor:
    """roberta-style two-layer tanh head: [B, hidden] -> [B, num_labels]."""
    x = torch.tanh(cls @ params["head_dense"]["w"] + params["head_dense"]["b"])
    return x @ params["head_out"]["w"] + params["head_out"]["b"]


def verdict_apply_with_aux(
    params: Dict[str, Any],
    cfg: VerdictConfig,
    ids: torch.Tensor,  # [B, L] int
    mask: torch.Tensor,  # [B, L] f32 (1 = real token)
    type_ids: Optional[torch.Tensor] = None,
    constrain=None,
    ep_constrain=None,
):
    """(logits [B, num_labels], MoE load-balance aux: 0 for dense), in full
    fp32 and under the caller's autograd mode: the training forward."""
    with float32_precision():
        hidden, aux = transformer_apply_with_aux(
            params["body"], cfg.encoder, ids, mask, type_ids,
            constrain=constrain, ep_constrain=ep_constrain,
        )
        return verdict_head(params, hidden[:, 0, :]), aux


def verdict_apply(
    params: Dict[str, Any],
    cfg: VerdictConfig,
    ids: torch.Tensor,  # [B, L] int
    mask: torch.Tensor,  # [B, L] f32 (1 = real token)
    type_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Logits [B, num_labels], without autograd and in full fp32 (the aux
    loss discarded): the serving forward."""
    with torch.no_grad():
        return verdict_apply_with_aux(params, cfg, ids, mask, type_ids)[0]


def verdict_predict(params, cfg: VerdictConfig, ids, mask, type_ids):
    """Predicted label ids [B]."""
    return torch.argmax(verdict_apply(params, cfg, ids, mask, type_ids), dim=-1)


def _linear_schedule(init_value, end_value, transition_steps, count):
    """``optax.linear_schedule``: a constant where there are no steps."""
    if transition_steps <= 0:
        return init_value
    frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
    return (init_value - end_value) * frac + end_value


class VerdictOptimizer:
    """``optax.adamw(schedule, weight_decay=1e-4)`` written out over the
    parameter tree: b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on
    every leaf, and the reference's schedule
    (``get_linear_schedule_with_warmup``, ``src/QA/train.py:38-43``): linear
    warmup from 0 to ``learning_rate`` over ``warmup_steps``, then linear
    decay to 0 over ``max(total_steps - warmup_steps, 1)``. Like optax it
    keeps one step count for all leaves, which bias correction and schedule
    share; the first step's learning rate is exactly 0.

    The state is ``{"count": int, "mu": tree, "nu": tree}``. ``update_``
    changes the parameters and the state in place, as the reference's step
    donates both."""

    b1, b2, eps, weight_decay = 0.9, 0.999, 1e-8, 1e-4

    def __init__(self, cfg: VerdictConfig):
        self.cfg = cfg

    def learning_rate(self, count: int) -> float:
        cfg = self.cfg
        if count < cfg.warmup_steps:
            return _linear_schedule(0.0, cfg.learning_rate, cfg.warmup_steps, count)
        return _linear_schedule(
            cfg.learning_rate, 0.0, max(cfg.total_steps - cfg.warmup_steps, 1),
            count - cfg.warmup_steps,
        )

    def init(self, params) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def update_(self, params, grads, opt_state, body_on: bool = True) -> None:
        """One AdamW step in place. With ``body_on`` false the body's
        gradients count as zero (its moments decay) and its update,
        weight decay included, is withheld: the body keeps its bits."""
        count_inc = opt_state["count"] + 1
        lr = self.learning_rate(opt_state["count"])
        bc1 = 1.0 - self.b1 ** count_inc
        bc2 = 1.0 - self.b2 ** count_inc
        for name in params:
            p, g, mu, nu = (
                tree_leaves(t[name])
                for t in (params, grads, opt_state["mu"], opt_state["nu"])
            )
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_mul_(nu, self.b2)
            if name == "body" and not body_on:
                continue
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            update = torch._foreach_div(mu, bc1)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(update, p, alpha=self.weight_decay)
            torch._foreach_add_(p, update, alpha=-lr)
        opt_state["count"] = count_inc


def make_verdict_optimizer(cfg: VerdictConfig) -> VerdictOptimizer:
    """AdamW with linear warmup then linear decay; see ``VerdictOptimizer``."""
    return VerdictOptimizer(cfg)


def make_verdict_train_step(cfg: VerdictConfig, constrain=None, ep_constrain=None,
                            *, device=None):
    """``(step, tx)``. ``step(params, opt_state, step_idx, ids, mask,
    type_ids, labels)`` takes one AdamW step on the mean softmax
    cross-entropy of a batch and returns ``(params, opt_state, loss,
    preds)``: the parameters and the state updated in place, the loss a
    0-dim tensor left on the device, ``preds`` the argmax labels. The batch
    may be numpy arrays or tensors; it is moved to ``device`` (by default
    the card), where ``params`` and ``opt_state`` must lie. While
    ``cfg.freeze_body_until_warmup`` and ``step_idx < cfg.warmup_steps`` the
    body's gradients are computed and then count as zero, and its update is
    withheld. ``constrain``/``ep_constrain`` (sharded training) wait for
    ROADMAP.md queue 1 item 12."""
    device = resolve_device(device)
    tx = make_verdict_optimizer(cfg)

    def loss_fn(params, ids, mask, type_ids, labels):
        logits, aux = verdict_apply_with_aux(
            params, cfg, ids, mask, type_ids, constrain, ep_constrain
        )
        loss = F.cross_entropy(logits, labels)
        if cfg.encoder.moe is not None:
            loss = loss + cfg.moe_aux_weight * aux
        return loss, torch.argmax(logits, dim=-1)

    def step(params, opt_state, step_idx, ids, mask, type_ids, labels):
        ids, type_ids, labels = (
            torch.as_tensor(x, device=device).long() for x in (ids, type_ids, labels)
        )
        mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
        loss, preds, grads = value_and_grad(
            loss_fn, params, ids, mask, type_ids, labels
        )
        body_on = (
            not cfg.freeze_body_until_warmup or int(step_idx) >= cfg.warmup_steps
        )
        tx.update_(params, grads, opt_state, body_on)
        return params, opt_state, loss, preds

    return step, tx
