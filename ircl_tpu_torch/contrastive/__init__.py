"""Contrastive training of the sentence encoder.

Counterpart of ``ircl_tpu/contrastive/``: ``TrainConfig``, ``TrainState``
and the optimizer (``state.py``), the losses (``losses.py``), the train step
and the inference path (``train.py``), k-means and Ward clustering for
ProtoNCE (``cluster.py``) and the host training loop ``ContrastiveTrainer``
(``trainer.py``).
"""

from ircl_tpu_torch.contrastive.losses import nt_xent_loss, moco_infonce_loss, proto_loss

__all__ = ["nt_xent_loss", "moco_infonce_loss", "proto_loss"]
