"""Contrastive pair sampling and sentence-pair similarity: host numpy.

Counterpart of ``ircl_tpu/data/``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package.
"""

from ircl_tpu_torch.data.pairs import DocPairSampler
from ircl_tpu_torch.data.similarity import sentence_pair_similarity

__all__ = ["DocPairSampler", "sentence_pair_similarity"]
