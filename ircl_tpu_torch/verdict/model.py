"""Verdict classifier: transformer encoder + roberta-style head, on tensors.

Counterpart of ``ircl_tpu/verdict/model.py``, the reference's
``RoBertaClassifier`` (``src/QA/model.py:10-37``): sequence classification
over (claim, evidence) pairs, SUPPORTS=1 / REFUTES=0, with a two-layer tanh
head over the [CLS] position. Parameters are the JAX package's tree
(``body``, ``head_dense``, ``head_out``; dense weights ``[in, out]``), so
``utils/convert.py::verdict_params_from_numpy`` carries trained weights
across unchanged.

Ported: the forward half that serving runs. The training half
(``make_verdict_optimizer``, ``make_verdict_train_step``,
``verdict_apply_with_aux``) waits for verdict training (ROADMAP.md queue 1
item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ircl_tpu_torch.models.transformer import (
    TransformerConfig,
    _dense_init,
    init_transformer_params,
    transformer_apply,
)
from ircl_tpu_torch.utils.convert import to_device
from ircl_tpu_torch.utils.precision import float32_precision


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
    gen: torch.Generator, cfg: VerdictConfig, device="cpu"
) -> Dict[str, Any]:
    """N(0, 0.02) weights and zero biases for the body and both head
    layers, drawn from ``gen`` on the CPU and moved to ``device``."""
    h = cfg.encoder.hidden
    params = {
        "body": init_transformer_params(gen, cfg.encoder),
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


def verdict_apply(
    params: Dict[str, Any],
    cfg: VerdictConfig,
    ids: torch.Tensor,  # [B, L] int
    mask: torch.Tensor,  # [B, L] f32 (1 = real token)
    type_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Logits [B, num_labels], without autograd and in full fp32."""
    with torch.no_grad(), float32_precision():
        hidden = transformer_apply(params["body"], cfg.encoder, ids, mask, type_ids)
        return verdict_head(params, hidden[:, 0, :])


def verdict_predict(params, cfg: VerdictConfig, ids, mask, type_ids):
    """Predicted label ids [B]."""
    return torch.argmax(verdict_apply(params, cfg, ids, mask, type_ids), dim=-1)
