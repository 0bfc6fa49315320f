"""Featurizers and the contrastive encoder head.

Counterpart of ``ircl_tpu/models/``: the BiLSTM head (``encoder``), the
transformer (``transformer``, both attention paths), WordPiece and the
featurizers. The MoE FFN is not ported yet (ROADMAP.md queue 1 item 9); the
verdict model lives in ``ircl_tpu_torch/verdict/``.
"""

from ircl_tpu_torch.models.encoder import EncoderConfig, init_encoder_params, seq2vec
from ircl_tpu_torch.models.featurizer import (
    FeaturizerConfig,
    HashEmbedFeaturizer,
    TransformerFeaturizer,
    make_featurizer,
)

__all__ = [
    "EncoderConfig",
    "init_encoder_params",
    "seq2vec",
    "HashEmbedFeaturizer",
    "TransformerFeaturizer",
    "make_featurizer",
    "FeaturizerConfig",
]
