"""Featurizers and the contrastive encoder head.

Counterpart of ``ircl_tpu/models/``: the BiLSTM head (``encoder``), the
transformer (``transformer``, both attention paths, float32 and bfloat16),
the Mixture-of-Experts FFN (``moe``), the Moonlight MLA + MoE decoder body
(``mla_moe``, its dropless router and grouped experts in ``moe_dropless``),
WordPiece and the featurizers. The verdict model lives in
``ircl_tpu_torch/verdict/``.
"""

from ircl_tpu_torch.models.encoder import EncoderConfig, init_encoder_params, seq2vec
from ircl_tpu_torch.models.featurizer import (
    FeaturizerConfig,
    HashEmbedFeaturizer,
    TransformerFeaturizer,
    make_featurizer,
)
from ircl_tpu_torch.models.moe import (
    MoEConfig,
    init_moe_ffn_params,
    moe_aux_from_stats,
    moe_capacity,
    moe_ffn,
    moe_route,
)

__all__ = [
    "EncoderConfig",
    "init_encoder_params",
    "seq2vec",
    "HashEmbedFeaturizer",
    "TransformerFeaturizer",
    "make_featurizer",
    "FeaturizerConfig",
    "MoEConfig",
    "init_moe_ffn_params",
    "moe_aux_from_stats",
    "moe_capacity",
    "moe_ffn",
    "moe_route",
]
