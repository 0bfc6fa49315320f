"""Host-side text layer: tokenization, hashing, filtering, FEVER corpus parsing.

Counterpart of ``ircl_tpu/corpus/``, carried over line for line apart from
imports; ``fetch.py`` and ``prepare.py`` come with the CLI (ROADMAP.md queue 1
item 7). The copies load the same ``native/libircl_native.so`` as the
reference.
"""

from ircl_tpu_torch.corpus.tokenizer import SimpleTokenizer, Tokens
from ircl_tpu_torch.corpus.hashing import murmurhash3_32, hash_token, hash_tokens
from ircl_tpu_torch.corpus.filters import (
    STOPWORDS,
    normalize,
    filter_word,
    filter_ngram,
)
from ircl_tpu_torch.corpus.store import MemoryDocStore, FlatDocStore

__all__ = [
    "SimpleTokenizer",
    "Tokens",
    "murmurhash3_32",
    "hash_token",
    "hash_tokens",
    "STOPWORDS",
    "normalize",
    "filter_word",
    "filter_ngram",
    "MemoryDocStore",
    "FlatDocStore",
]
