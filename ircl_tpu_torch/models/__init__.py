"""Featurizers and the contrastive encoder head.

Counterpart of ``ircl_tpu/models/``: the BiLSTM head (``encoder``), the
transformer (``transformer``), WordPiece and the featurizers. The MoE FFN
and the verdict model are not ported yet (ROADMAP.md queue 1 items 9, 11).
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
