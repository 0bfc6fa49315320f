"""Dense retrieval: corpus embedding sweeps and exact cosine top-k.

Counterpart of ``ircl_tpu/dense/``.
"""

from ircl_tpu_torch.dense.embed import embed_corpus
from ircl_tpu_torch.dense.scorer import cosine_topk

__all__ = ["cosine_topk", "embed_corpus"]
