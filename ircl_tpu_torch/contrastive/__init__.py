"""Contrastive encoder: configuration and the inference path.

Counterpart of ``ircl_tpu/contrastive/``. Ported so far: ``TrainConfig``
and ``make_embed_fn``. The losses, the optimizer, ``TrainState`` and the
train step wait for ROADMAP.md queue 1 item 10.
"""
