"""Hashed-ngram sparse index: host-side build and device-side ranking.

Counterpart of ``ircl_tpu/index/``; the chunked engine is not ported yet.
"""

from ircl_tpu_torch.index.build import CountIndex, build_count_index
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.split import load_split, save_split, split_index
from ircl_tpu_torch.index.tfidf import doc_freqs_from_postings, tfidf_transform

__all__ = [
    "build_count_index",
    "CountIndex",
    "tfidf_transform",
    "doc_freqs_from_postings",
    "TfidfRanker",
    "split_index",
    "save_split",
    "load_split",
]
