"""The benchmark's synthetic FEVER-like corpus, claims and verdict pairs.

Draws the model of the repository's synthetic wiki generator (``generate``
in the port's ``corpus/synthetic.py``) with NumPy in a few large draws, so
that 50,000 documents take seconds instead of the per-sentence Python loop's
~40 s: a 400-word common vocabulary of 2-3 consonant-vowel syllables drawn
with Zipf weights 1/rank; per document 4-8 sentences of 8-15 common words,
two entity tokens (three syllables and the document number, the second with
an ``x`` before it) of which one is woven into each sentence with
probability 0.8, the title ``Entity0_Entity1``; a claim keeps each word of
one gold sentence with probability 0.6 (entity tokens always) and appends
three common words. The output is not bit-equal to that generator's for any
seed; the statistics are the model's.

Verdict pairs pair a claim with evidence assembled as the service's
``verify_claims`` assembles it: for each document, its title's words, then
its sentences; the gold document first, then 0-4 other documents drawn from
the seed, so that real lengths spread to the 512-token cut.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

_CONSONANTS = np.array(list("bcdfghjklmnpqrstvwz"))
_VOWELS = np.array(list("aeiou"))


def _words(rng: np.random.Generator, syllables: np.ndarray) -> List[str]:
    """One word of ``syllables[i]`` consonant-vowel syllables per entry."""
    most = int(syllables.max())
    c = _CONSONANTS[rng.integers(len(_CONSONANTS), size=(len(syllables), most))]
    v = _VOWELS[rng.integers(len(_VOWELS), size=(len(syllables), most))]
    pairs = np.char.add(c, v)
    return ["".join(row[:n]) for row, n in zip(pairs.tolist(), syllables.tolist())]


@dataclass
class Corpus:
    titles: List[str]
    texts: List[str]  # a document's sentences joined by spaces
    sentences: List[str]  # every sentence, document by document
    sent_start: np.ndarray  # [docs + 1] a document's first sentence
    common: List[str]
    common_p: np.ndarray
    words: np.ndarray  # [tokens] every sentence's tokens (object array)
    word_start: np.ndarray  # [sentences + 1] a sentence's first token
    is_entity: np.ndarray  # [tokens] bool

    @property
    def num_docs(self) -> int:
        return len(self.titles)

    def doc_sentences(self, d: int) -> List[str]:
        return self.sentences[self.sent_start[d]:self.sent_start[d + 1]]


def generate(num_docs: int, seed: int, sents=(4, 9), words_per_sent=(8, 16),
             vocab_common: int = 400, entity_prob: float = 0.8) -> Corpus:
    rng = np.random.default_rng(seed)
    common = _words(rng, rng.integers(2, 4, size=vocab_common))
    ranks = np.arange(1, vocab_common + 1)
    common_p = (1.0 / ranks) / np.sum(1.0 / ranks)

    syl3 = np.full(num_docs, 3)
    numbers = [str(d) for d in range(num_docs)]
    ent0 = [w + n for w, n in zip(_words(rng, syl3), numbers)]
    ent1 = [w + "x" + n for w, n in zip(_words(rng, syl3), numbers)]
    titles = [a.capitalize() + "_" + b.capitalize() for a, b in zip(ent0, ent1)]

    n_sents = rng.integers(*sents, size=num_docs)
    sent_start = np.zeros(num_docs + 1, np.int64)
    np.cumsum(n_sents, out=sent_start[1:])
    n_sent = int(sent_start[-1])
    doc_of_sent = np.repeat(np.arange(num_docs), n_sents)
    n_words = rng.integers(*words_per_sent, size=n_sent)
    has_ent = rng.random(n_sent) < entity_prob
    ent_pos = (rng.random(n_sent) * (n_words + 1)).astype(np.int64)  # 0..n_words
    ent_which = rng.integers(2, size=n_sent)
    common_idx = rng.choice(vocab_common, size=int(n_words.sum()), p=common_p)

    # every sentence's tokens, the entity inserted at its position
    lens = n_words + has_ent
    word_start = np.zeros(n_sent + 1, np.int64)
    np.cumsum(lens, out=word_start[1:])
    total = int(word_start[-1])
    is_entity = np.zeros(total, bool)
    ent_slot = (word_start[:-1] + ent_pos)[has_ent]
    is_entity[ent_slot] = True
    words = np.empty(total, object)
    words[~is_entity] = np.asarray(common, object)[common_idx]
    ents = np.where(ent_which == 0, np.asarray(ent0, object)[doc_of_sent],
                    np.asarray(ent1, object)[doc_of_sent])
    words[ent_slot] = ents[has_ent]

    flat = words.tolist()
    bounds = word_start.tolist()
    sentences = [" ".join(flat[a:b]) + " ." for a, b in zip(bounds[:-1], bounds[1:])]
    sb = sent_start.tolist()
    texts = [" ".join(sentences[a:b]) for a, b in zip(sb[:-1], sb[1:])]
    return Corpus(titles, texts, sentences, sent_start, common, common_p, words,
                  word_start, is_entity)


@dataclass
class Claims:
    texts: List[str]
    gold: np.ndarray  # [claims] gold document
    labels: np.ndarray  # [claims] 0/1, drawn from the seed


def draw_claims(corpus: Corpus, num: int, seed: int, keep_prob: float = 0.6,
                noise: int = 3) -> Claims:
    """Claims as the generator draws them: a gold sentence's words, each
    kept with ``keep_prob`` (entity tokens always), and ``noise`` common
    words after them."""
    rng = np.random.default_rng(seed)
    gold = rng.integers(corpus.num_docs, size=num)
    n_s = corpus.sent_start[gold + 1] - corpus.sent_start[gold]
    sent = corpus.sent_start[gold] + (rng.random(num) * n_s).astype(np.int64)
    a, b = corpus.word_start[sent], corpus.word_start[sent + 1]
    lens = b - a
    pos = np.repeat(a - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens) + np.arange(lens.sum())
    keep = (rng.random(len(pos)) < keep_prob) | corpus.is_entity[pos]
    kept = corpus.words[pos].tolist()
    keep = keep.tolist()
    noise_idx = rng.choice(len(corpus.common), size=(num, noise), p=corpus.common_p)
    common = corpus.common
    texts, o = [], 0
    for c, n in enumerate(lens.tolist()):
        ws = [w for w, k in zip(kept[o:o + n], keep[o:o + n]) if k]
        ws += [common[j] for j in noise_idx[c]]
        texts.append(" ".join(ws) + " .")
        o += n
    return Claims(texts, gold, rng.integers(2, size=num))


def evidence_texts(corpus: Corpus, gold: np.ndarray, seed: int, max_other: int = 4) -> List[str]:
    """Each claim's evidence: its gold document, then 0..``max_other`` other
    documents, each as its title's words followed by its sentences."""
    rng = np.random.default_rng(seed)
    n_other = rng.integers(0, max_other + 1, size=len(gold))
    other = rng.integers(corpus.num_docs, size=(len(gold), max_other))
    out = []
    for g, n, row in zip(gold.tolist(), n_other.tolist(), other.tolist()):
        parts: List[str] = []
        for d in [g] + row[:n]:
            parts.extend(corpus.titles[d].split("_"))
            parts.extend(corpus.doc_sentences(d))
        out.append(" ".join(parts))
    return out
