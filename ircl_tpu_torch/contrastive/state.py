"""Contrastive training configuration.

Counterpart of ``ircl_tpu/contrastive/state.py``, as far as
``TrainConfig``: the frozen dataclass with the same fields and defaults,
whose ``encoder`` sizes the BiLSTM head. The optimizer, ``TrainState`` and
``init_train_state`` wait for ROADMAP.md queue 1 item 10.
"""

from __future__ import annotations

from dataclasses import dataclass

from ircl_tpu_torch.models.encoder import EncoderConfig


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
