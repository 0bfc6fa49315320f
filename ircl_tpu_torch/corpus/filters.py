"""Text normalization and ngram filtering.

Counterpart of ``ircl_tpu/corpus/filters.py``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package.

Behavior matches the reference's recall-critical filters
(``preprocessing/drqa/retriever/utils.py:54-108``): NFD normalization, a
119-entry stopword list, punctuation-only rejection, and the any/all/ends
ngram filter modes. Bit-exact agreement here is required for hash/recall
parity between index build and query time.
"""

from __future__ import annotations

import unicodedata
from functools import lru_cache
from typing import Sequence

import regex

STOPWORDS = frozenset({
    'i', 'me', 'my', 'myself', 'we', 'our', 'ours', 'ourselves', 'you', 'your',
    'yours', 'yourself', 'yourselves', 'he', 'him', 'his', 'himself', 'she',
    'her', 'hers', 'herself', 'it', 'its', 'itself', 'they', 'them', 'their',
    'theirs', 'themselves', 'what', 'which', 'who', 'whom', 'this', 'that',
    'these', 'those', 'am', 'is', 'are', 'was', 'were', 'be', 'been', 'being',
    'have', 'has', 'had', 'having', 'do', 'does', 'did', 'doing', 'a', 'an',
    'the', 'and', 'but', 'if', 'or', 'because', 'as', 'until', 'while', 'of',
    'at', 'by', 'for', 'with', 'about', 'against', 'between', 'into', 'through',
    'during', 'before', 'after', 'above', 'below', 'to', 'from', 'up', 'down',
    'in', 'out', 'on', 'off', 'over', 'under', 'again', 'further', 'then',
    'once', 'here', 'there', 'when', 'where', 'why', 'how', 'all', 'any',
    'both', 'each', 'few', 'more', 'most', 'other', 'some', 'such', 'no', 'nor',
    'not', 'only', 'own', 'same', 'so', 'than', 'too', 'very', 's', 't', 'can',
    'will', 'just', 'don', 'should', 'now', 'd', 'll', 'm', 'o', 're', 've',
    'y', 'ain', 'aren', 'couldn', 'didn', 'doesn', 'hadn', 'hasn', 'haven',
    'isn', 'ma', 'mightn', 'mustn', 'needn', 'shan', 'shouldn', 'wasn', 'weren',
    'won', 'wouldn', "'ll", "'re", "'ve", "n't", "'s", "'d", "'m", "''", "``",
})

_PUNCT_RE = regex.compile(r'^\p{P}+$')


def normalize(text: str) -> str:
    """NFD unicode normalization (reference ``utils.normalize``)."""
    return unicodedata.normalize('NFD', text)


@lru_cache(maxsize=1 << 18)
def filter_word(text: str) -> bool:
    """True if the token should be filtered (punctuation or stopword)."""
    text = normalize(text)
    if _PUNCT_RE.match(text):
        return True
    if text.lower() in STOPWORDS:
        return True
    return False


def filter_ngram(gram: Sequence[str], mode: str = 'any') -> bool:
    """Decide whether to discard an n-gram (reference ``utils.filter_ngram``).

    mode='any': discard if any token is filterable;
    mode='all': discard only if all are;
    mode='ends': discard if book-ended by filterable tokens.
    """
    filtered = [filter_word(w) for w in gram]
    if mode == 'any':
        return any(filtered)
    if mode == 'all':
        return all(filtered)
    if mode == 'ends':
        return filtered[0] or filtered[-1]
    raise ValueError(f'Invalid mode: {mode}')
