"""Per-document sentence-pair tf-idf similarity for the ``tf_idf`` sampler.

Counterpart of ``ircl_tpu/data/similarity.py``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package.

The reference precomputes, for every document, all intra-document sentence
pairs ranked by tf-idf cosine similarity, with the vectorizer fitted over the
*full* sentence corpus (``preprocessing/build_docs_sentence_similarity.py:
41-68``: sklearn ``TfidfVectorizer(tokenizer=LemmaTokenizer(),
ngram_range=(1, 2))``, NLTK lemmas, stopword/punctuation drop).

This implementation keeps the contract — per-doc ``[((i, j), score), ...]``
sorted by descending similarity, single-sentence docs yielding the ``(0, 0)``
self-pair — but computes it in the framework's own feature space: murmur3-
hashed 1..2-grams over the parity tokenizer (the same text -> bucket map the
sparse index uses), smooth-idf tf-idf, L2-normalised cosine via one sparse
matmul. No NLTK dependency; fits this zero-egress environment.

``stem=True`` enables a light suffix-stripping normalisation (a lemma-ish
approximation of the reference's WordNet lemmatizer) so the deviation from
the reference's lemma feature space can be A/B-measured (RESULTS.md).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from ircl_tpu_torch.corpus.filters import filter_word, normalize
from ircl_tpu_torch.corpus.hashing import hash_token
from ircl_tpu_torch.corpus.tokenizer import default_tokenizer

PairScores = List[Tuple[Tuple[int, int], float]]

# Longest-match-first suffix table: a cheap stand-in for WordNet lemmas that
# collapses plural/verbal inflections ("claims"->"claim", "running"->"runn").
_SUFFIXES = ("ational", "iveness", "fulness", "ing", "edly", "ied", "ies",
             "ed", "es", "ly", "s")


def _strip_suffix(word: str) -> str:
    for suf in _SUFFIXES:
        if word.endswith(suf) and len(word) - len(suf) >= 3:
            return word[: -len(suf)]
    return word


def _sentence_tokens(text: str, stem: bool) -> List[str]:
    words = default_tokenizer().tokenize(normalize(text)).words(uncased=True)
    words = [w for w in words if not filter_word(w)]
    if stem:
        words = [_strip_suffix(w) for w in words]
    return words


def _hashed_rows(
    sentences: Sequence[str], hash_size: int, ngram: int, stem: bool
) -> sp.csr_matrix:
    """Sentences -> [S, hash_size] CSR of raw 1..ngram counts."""
    indptr = [0]
    indices: List[int] = []
    data: List[int] = []
    for text in sentences:
        words = _sentence_tokens(text, stem)
        counts: dict = {}
        for s in range(len(words)):
            for e in range(s, min(s + ngram, len(words))):
                b = hash_token(" ".join(words[s : e + 1]), hash_size)
                counts[b] = counts.get(b, 0) + 1
        indices.extend(counts.keys())
        data.extend(counts.values())
        indptr.append(len(indices))
    return sp.csr_matrix(
        (
            np.asarray(data, np.float64),
            np.asarray(indices, np.int64),
            np.asarray(indptr, np.int64),
        ),
        shape=(len(sentences), hash_size),
    )


def sentence_pair_similarity(
    docs: Sequence[Sequence[str]],
    hash_size: int = 1 << 18,
    ngram: int = 2,
    stem: bool = False,
) -> List[PairScores]:
    """All intra-doc sentence pairs ranked by tf-idf cosine, per document.

    Returns one list per doc of ``((i, j), score)`` with ``i < j``, sorted by
    descending score; a single-sentence doc gets ``[((0, 0), 1.0)]`` (the
    reference's self-pair case). idf is fitted over every sentence of every
    doc, matching the reference's full-corpus ``vectorizer.fit``.
    """
    flat = [s for doc in docs for s in doc]
    if not flat:
        return [[] for _ in docs]
    X = _hashed_rows(flat, hash_size, ngram, stem)

    # smooth idf (sklearn default): ln((1 + N) / (1 + df)) + 1
    n = X.shape[0]
    df = np.bincount(X.indices, minlength=hash_size)[X.indices]
    X.data *= np.log((1.0 + n) / (1.0 + df)) + 1.0
    # L2 row norm so cosine(a, b) = <a, b>
    norms = np.sqrt(X.multiply(X).sum(axis=1)).A.ravel()
    norms[norms == 0] = 1.0
    X.data /= np.repeat(norms, np.diff(X.indptr))

    out: List[PairScores] = []
    row = 0
    for doc in docs:
        m = len(doc)
        rows = X[row : row + m]
        row += m
        if m == 0:
            out.append([])
            continue
        if m == 1:
            out.append([((0, 0), float(rows.dot(rows.T).toarray()[0, 0]))])
            continue
        sim = rows.dot(rows.T).toarray()
        iu, ju = np.triu_indices(m, k=1)
        scores = sim[iu, ju]
        order = np.argsort(-scores, kind="stable")
        out.append(
            [((int(iu[o]), int(ju[o])), float(scores[o])) for o in order]
        )
    return out
