"""The port's ``pipeline/recall.py`` against ``ircl_tpu.pipeline.recall``.

Mirrors the recall cases of ``tests/test_pipeline.py`` and
``tests/test_end_to_end.py``: hand-made claims in "any" and "full" mode,
with and without annotation structure, and the doc and sentence recall of
both packages' retrieval over one seeded synthetic corpus. Recalls are
fractions of claims: they must be equal, not close.
"""

import numpy as np
import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.corpus.fever import Claim as JClaim
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.index.build import build_count_index
from ircl_tpu.index.ranker import TfidfRanker as JRanker
from ircl_tpu.index.tfidf import tfidf_transform
from ircl_tpu.pipeline import recall as j_recall
from ircl_tpu.pipeline import retrieve as j_rt
from ircl_tpu_torch.corpus.fever import Claim
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.pipeline import recall as t_recall
from ircl_tpu_torch.pipeline import retrieve as t_rt

CLAIMS = [  # (id, claim, label, evidences, evidence_sets)
    (1, "c1", "SUPPORTS", {"DocA": [0, 2]}, None),
    (2, "c2", "SUPPORTS", {"DocB": [1], "DocC": [0]}, None),
    (3, "c3", "NOT ENOUGH INFO", {}, None),
    (4, "c4", "SUPPORTS", {"D1": [0], "D2": [0]}, [[("D1", 0)], [("D2", 0)]]),
    (5, "c5", "SUPPORTS", {"D1": [0], "D2": [0]}, [[("D1", 0), ("D2", 0)]]),
    (6, "c6", "SUPPORTS", {"D1": [0], "D2": [0]}, None),
    (7, "c7", "REFUTES", {"Café": [1]}, None),  # NFKD-normalized ids
]
DOCS = [["DocX", "DocA"], ["DocC"], ["DocA"], ["D1"], ["D1", "D2"], ["D2", "D1"],
        ["Café"]]
SENTS = [[("DocA", 2)], [("DocB", 0)], [], [("D1", 0)], [("D1", 0), ("D2", 0)],
         [("D1", 0)], [("Café", 1)]]


def _claims(cls):
    return [cls(i, c, lab, ev, evidence_sets=sets) if sets else cls(i, c, lab, ev)
            for i, c, lab, ev, sets in CLAIMS]


@pytest.mark.parametrize("mode", ["any", "full"])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_recall_at_k_matches_reference(mode, k):
    got = (t_recall.doc_recall_at_k(_claims(Claim), DOCS, k=k, mode=mode),
           t_recall.sentence_recall_at_k(_claims(Claim), SENTS, k=k, mode=mode))
    want = (j_recall.doc_recall_at_k(_claims(JClaim), DOCS, k=k, mode=mode),
            j_recall.sentence_recall_at_k(_claims(JClaim), SENTS, k=k, mode=mode))
    assert got == want


def test_recall_unit_values():
    """``tests/test_pipeline.py``'s hand-computed values."""
    claims = _claims(Claim)[:3]
    assert t_recall.doc_recall_at_k(claims, DOCS[:3], k=2) == 1.0
    assert t_recall.doc_recall_at_k(claims, DOCS[:3], k=1) == 0.5
    assert t_recall.doc_recall_at_k(claims, DOCS[:3], k=2, mode="full") == 0.5
    assert t_recall.sentence_recall_at_k(claims, SENTS[:3], k=5) == 0.5
    c4, c5, c6 = _claims(Claim)[3:6]
    assert t_recall.doc_recall_at_k([c4], [["D1"]], k=1, mode="full") == 1.0
    assert t_recall.doc_recall_at_k([c5], [["D1"]], k=1, mode="full") == 0.0
    assert t_recall.sentence_recall_at_k([c6], [[("D1", 0)]], k=5, mode="full") == 0.0
    assert t_recall.doc_recall_at_k([], [], k=5) == 0.0


@pytest.mark.parametrize("fn", ["doc_recall_at_k", "sentence_recall_at_k"])
def test_invalid_mode_raises_like_the_reference(fn):
    with pytest.raises(ValueError) as want:
        getattr(j_recall, fn)(_claims(JClaim)[:1], DOCS[:1], mode="most")
    with pytest.raises(ValueError) as got:
        getattr(t_recall, fn)(_claims(Claim)[:1], DOCS[:1], mode="most")
    assert str(got.value) == str(want.value)


def test_recall_of_retrieval_matches_reference():
    """Both packages' two-stage retrieval over one synthetic corpus, scored
    by each package's recall: equal doc and sentence recall@5."""
    wiki = generate(num_docs=120, num_claims=60, seed=7)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=2**20))
    claims = [c.claim for c in wiki.claims]

    def scorer(mod, ranker_cls, *device):
        def factory(sents):
            idx = tfidf_transform(build_count_index(MemoryDocStore(list(sents)), ngram=2,
                                                    hash_size=2**16))
            return ranker_cls(idx, *device)
        return mod.sparse_sentence_scorer(factory)

    kw = dict(k_docs=5, k_sents=5)
    want = j_rt.retrieve(claims, JRanker(index), wiki.sentences,
                         scorer(j_rt, JRanker), **kw)
    got = t_rt.retrieve(claims, TfidfRanker(index, "cpu"), wiki.sentences,
                        scorer(t_rt, TfidfRanker, "cpu"), **kw)
    t_claims = [Claim(c.id, c.claim, c.label, c.evidences) for c in wiki.claims]
    recalls = (t_recall.doc_recall_at_k(t_claims, got.doc_ids, k=5),
               t_recall.sentence_recall_at_k(t_claims, got.sentences, k=5))
    assert recalls == (j_recall.doc_recall_at_k(wiki.claims, want.doc_ids, k=5),
                       j_recall.sentence_recall_at_k(wiki.claims, want.sentences, k=5))
    assert recalls[0] >= 0.9 and recalls[1] >= 0.75
    assert np.isfinite(np.concatenate(got.doc_scores)).all()
