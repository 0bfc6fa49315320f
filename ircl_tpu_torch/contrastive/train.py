"""The contrastive encoder's inference path.

Counterpart of ``ircl_tpu/contrastive/train.py``, as far as
``make_embed_fn`` (the reference's ``ctx2vec``,
``contrastive_module.py:96-100``). The train step waits for ROADMAP.md
queue 1 item 10.
"""

from __future__ import annotations

import torch

from ircl_tpu_torch.contrastive.state import TrainConfig
from ircl_tpu_torch.models.encoder import seq2vec
from ircl_tpu_torch.utils.precision import float32_precision


def make_embed_fn(config: TrainConfig, featurizer):
    """Text features -> normalized embeddings: ``call(params_q, ids, mask)``
    takes host ``(ids, mask)`` arrays (``featurizer.encode_host``), runs the
    frozen featurizer and ``seq2vec`` on the featurizer's device without
    autograd and in full fp32, and returns a ``[B, output_size]`` tensor
    there. ``params_q`` are the encoder's parameters on that device."""

    def call(params_q, ids, mask):
        with torch.no_grad(), float32_precision():
            feats = featurizer.features(ids, mask)
            mask_t = torch.as_tensor(mask, dtype=torch.float32, device=feats.device)
            return seq2vec(params_q, config.encoder, feats, mask_t)

    return call
