"""Deterministic synthetic FEVER-like corpus generator.

Counterpart of ``ircl_tpu/corpus/synthetic.py``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package.

The environment has no network egress, so the real FEVER downloads
(reference ``preprocessing/fetch_data.py``) are unavailable; benchmarks and
end-to-end tests run on synthetic wikis generated here. Structure mirrors the
real data: every document has a title (doc id), a FEVER-format ``lines``
string ("<sent_id>\\t<sentence>" rows), and claims are noisy paraphrases of a
gold sentence so sparse TF-IDF retrieval has real signal (rare entity tokens
shared between claim and evidence).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ircl_tpu_torch.corpus.fever import Claim

_CONSONANTS = "bcdfghjklmnpqrstvwz"
_VOWELS = "aeiou"


def _word(rng: np.random.Generator, syllables: int) -> str:
    return "".join(
        _CONSONANTS[rng.integers(len(_CONSONANTS))]
        + _VOWELS[rng.integers(len(_VOWELS))]
        for _ in range(syllables)
    )


@dataclass
class SyntheticWiki:
    """A generated corpus: doc_id -> {"text", "lines"} plus claims."""

    docs: Dict[str, Dict[str, str]]
    sentences: Dict[str, List[str]]  # doc_id -> sentence list
    claims: List[Claim]


def generate(
    num_docs: int = 200,
    sents_per_doc: Tuple[int, int] = (4, 9),
    words_per_sent: Tuple[int, int] = (8, 16),
    vocab_common: int = 400,
    num_claims: int = 100,
    claim_keep_prob: float = 0.6,
    refute_fraction: float = 0.0,
    inflect_prob: float = 0.0,
    refute_marker: bool = True,
    refute_corrupt: float = 0.5,
    value_tokens: bool = False,
    val_range: int = 50,  # fact-slot cardinality; real FEVER slots (dates,
    #   numbers) are high-cardinality — small ranges make corrupted values
    #   collide with distractor sentences' values far more than real data
    seed: int = 0,
) -> SyntheticWiki:
    """Build a synthetic wiki + claims with gold evidence.

    Each doc gets 2 unique "entity" tokens woven through its sentences (the
    retrieval signal) over a Zipf-ish common vocabulary. Claims subsample a
    gold sentence's words (keeping entity tokens) and append noise words.

    ``inflect_prob`` > 0 appends English-like inflection suffixes
    (s/es/ed/ing) to common words with that probability — morphological
    surface variation for experiments on lemma-vs-surface feature spaces
    (``scripts/similarity_ab.py``). The default 0.0 leaves the token stream
    (and ``corpus_digest``) bit-identical to prior rounds.
    """
    rng = np.random.default_rng(seed)
    common = [_word(rng, rng.integers(2, 4)) for _ in range(vocab_common)]
    # Zipf-ish sampling weights for common words.
    ranks = np.arange(1, vocab_common + 1)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    docs: Dict[str, Dict[str, str]] = {}
    sentences: Dict[str, List[str]] = {}

    for d in range(num_docs):
        entities = [f"{_word(rng, 3)}{d}", f"{_word(rng, 3)}x{d}"]
        title = f"{entities[0].capitalize()}_{entities[1].capitalize()}"
        n_sents = int(rng.integers(*sents_per_doc))
        sents = []
        for s in range(n_sents):
            n_words = int(rng.integers(*words_per_sent))
            words = list(rng.choice(common, size=n_words, p=probs))
            if inflect_prob > 0.0:
                suffixes = ("s", "es", "ed", "ing")
                words = [
                    w + suffixes[int(rng.integers(4))]
                    if rng.random() < inflect_prob
                    else w
                    for w in words
                ]
            # weave entities into most sentences
            if rng.random() < 0.8:
                pos = rng.integers(0, len(words) + 1)
                words.insert(pos, entities[int(rng.integers(2))])
            if value_tokens:
                # One "fact slot" per sentence: a valNN token a claim either
                # agrees with (SUPPORTS) or contradicts (REFUTES). Digit
                # suffix => the claim-keep and refute-corrupt rules always
                # preserve it, like entity tokens.
                v = int(rng.integers(val_range))
                words.insert(int(rng.integers(0, len(words) + 1)), f"val{v}")
            sents.append(" ".join(words) + " .")
        sentences[title] = sents
        lines = "\n".join(f"{i}\t{s}" for i, s in enumerate(sents))
        docs[title] = {"text": " ".join(sents), "lines": lines}

    doc_ids = list(docs.keys())
    claims: List[Claim] = []
    for c in range(num_claims):
        di = int(rng.integers(num_docs))
        doc_id = doc_ids[di]
        si = int(rng.integers(len(sentences[doc_id])))
        gold_words = sentences[doc_id][si].rstrip(" .").split()
        kept = [
            w
            for w in gold_words
            if rng.random() < claim_keep_prob or w[-1].isdigit()
        ]
        noise = list(rng.choice(common, size=3, p=probs))
        # Refuted claims keep the evidence-sharing entity tokens (retrieval
        # recall is unaffected) but carry a contradiction marker + corrupted
        # content words — a learnable 2-class verdict signal.
        label = "SUPPORTS"
        if rng.random() < refute_fraction:
            label = "REFUTES"
            kept = [
                w if w[-1].isdigit() or rng.random() >= refute_corrupt
                else str(rng.choice(common, p=probs))
                for w in kept
            ]
            # With the marker the label is claim-separable (easy smoke
            # tests); without it (refute_marker=False) REFUTES is only
            # detectable by comparing claim words against the evidence —
            # the regime where evidence quality matters (Table 2 analogue,
            # scripts/verdict_table2.py).
            if refute_marker:
                kept.append("kontradikto")
            if value_tokens:
                # contradict the evidence's fact slot: swap the claim's
                # valNN for a different value
                gold_v = next(
                    (w for w in gold_words if w.startswith("val")
                     and w[3:].isdigit()),
                    None,
                )
                if gold_v is not None:
                    w_new = f"val{int(rng.integers(val_range))}"
                    while w_new == gold_v:
                        w_new = f"val{int(rng.integers(val_range))}"
                    kept = [w_new if w == gold_v else w for w in kept]
        claim_text = " ".join(kept + noise) + " ."
        claims.append(
            Claim(id=c, claim=claim_text, label=label, evidences={doc_id: [si]})
        )

    return SyntheticWiki(docs=docs, sentences=sentences, claims=claims)


def corpus_digest(wiki: SyntheticWiki) -> str:
    """Stable digest of the generated corpus (regression guard)."""
    h = hashlib.sha256()
    for k in sorted(wiki.docs):
        h.update(k.encode())
        h.update(wiki.docs[k]["lines"].encode())
    for c in wiki.claims:
        h.update(c.claim.encode())
    return h.hexdigest()[:16]
