"""Contrastive encoder head: BiLSTM stack + projection + mean-pool + L2 norm.

Counterpart of ``ircl_tpu/models/encoder.py`` (the reference's ``LSTM``
module + ``seq2vec``, ``src/model.py:7-41``,
``src/contrastor/contrastive_module.py:102-112``): frozen features
[B, L, 768] -> BiLSTM(3x256, bi) -> Linear(512 -> 128) -> mean over the
sequence -> L2 normalize. Like the reference, the mean runs over the padded
length (no mask) unless ``masked_mean=True``. Parameters are a plain dict
of tensors with the JAX package's layout (``utils/convert.py`` carries
them across).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ircl_tpu_torch.ops.bilstm import _xavier_uniform, bilstm_apply, init_bilstm_params
from ircl_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class EncoderConfig:
    input_size: int = 768
    hidden_size: int = 256
    output_size: int = 128
    num_layers: int = 3
    bidirectional: bool = True
    # 'identity' | 'tanh' | 'relu' | 'gelu' (reference default Identity via
    # config.yaml:8)
    activation: str = "identity"
    masked_mean: bool = False


_ACTIVATIONS = {
    "identity": lambda x: x,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
}


def init_encoder_params(
    gen: torch.Generator, config: EncoderConfig, device=None
) -> Dict[str, Any]:
    """BiLSTM layers, then the projection, drawn from ``gen`` on the CPU and
    moved to ``device`` (by default the card)."""
    device = resolve_device(device)
    dirs = 2 if config.bidirectional else 1
    lstm = init_bilstm_params(
        gen, config.input_size, config.hidden_size, config.num_layers,
        config.bidirectional, device=device,
    )
    proj_w = _xavier_uniform(gen, (config.output_size, dirs * config.hidden_size))
    return {
        "lstm": lstm,
        "proj_w": proj_w.to(device),
        "proj_b": torch.zeros(config.output_size, device=device),
    }


def encoder_apply(
    params: Dict[str, Any], config: EncoderConfig, features: torch.Tensor
) -> torch.Tensor:
    """[B, L, I] -> [B, L, output_size] (pre-pooling), in float32 for
    float32 or bfloat16 features."""
    h = bilstm_apply(params["lstm"], features)
    # bf16 operands multiplied in f32 (exact) for an f32 result, as the
    # reference's preferred_element_type=f32; the identity in float32
    out = h.float() @ params["proj_w"].to(h.dtype).float().T + params["proj_b"]
    return _ACTIVATIONS[config.activation](out)


def seq2vec(
    params: Dict[str, Any],
    config: EncoderConfig,
    features: torch.Tensor,
    mask: torch.Tensor = None,
) -> torch.Tensor:
    """[B, L, I] -> L2-normalized [B, output_size] embeddings."""
    out = encoder_apply(params, config, features)
    if config.masked_mean and mask is not None:
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
        emb = (out * mask[:, :, None]).sum(dim=1) / denom
    else:
        emb = out.mean(dim=1)
    norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb / torch.clamp(norm, min=1e-12)
