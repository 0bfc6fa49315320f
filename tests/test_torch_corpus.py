"""The port's ``corpus`` copies against the originals in ``ircl_tpu.corpus``.

``ircl_tpu_torch/corpus/`` is ``ircl_tpu/corpus/`` carried over line for line
apart from imports, so the port imports nothing of the JAX package. The same
seeded inputs go through both: tokens, hashes, filters, ``batch_vectorize``
output, generated documents and claims, the FEVER parsers and both doc
stores must be equal, not close. Both load the same
``native/libircl_native.so``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ircl_tpu.corpus import fastpath as j_fast
from ircl_tpu.corpus import fever as j_fever
from ircl_tpu.corpus import filters as j_filters
from ircl_tpu.corpus import hashing as j_hash
from ircl_tpu.corpus import store as j_store
from ircl_tpu.corpus import synthetic as j_syn
from ircl_tpu.corpus import tokenizer as j_tok
from ircl_tpu.utils import native_build as j_build
from ircl_tpu_torch import corpus as t_corpus
from ircl_tpu_torch.corpus import fastpath as t_fast
from ircl_tpu_torch.corpus import fever as t_fever
from ircl_tpu_torch.corpus import filters as t_filters
from ircl_tpu_torch.corpus import hashing as t_hash
from ircl_tpu_torch.corpus import store as t_store
from ircl_tpu_torch.corpus import synthetic as t_syn
from ircl_tpu_torch.corpus import tokenizer as t_tok
from ircl_tpu_torch.utils import native_build as t_build

TEXTS = [
    "Nikolaj Coster-Waldau worked with the Fox Broadcasting Company.",
    "The Ten Commandments is an epic film, isn't it? (1956)",
    "Café Zoë — naïve résumés cost 12.50 € in Köln",
    "",
    "a the of and",
    "Tokyo is the capital of Japan and its most populous city.",
]


@pytest.fixture(scope="module")
def wikis():
    kw = dict(num_docs=40, num_claims=12, refute_fraction=0.3, seed=11)
    return j_syn.generate(**kw), t_syn.generate(**kw)


@pytest.mark.parametrize("text", TEXTS)
def test_tokens_and_ngrams_are_equal(text):
    j, t = j_tok.default_tokenizer().tokenize(text), t_tok.default_tokenizer().tokenize(text)
    assert t.words() == j.words() and t.words(uncased=True) == j.words(uncased=True)
    assert t.offsets() == j.offsets()
    assert (t.ngrams(2, uncased=True, filter_fn=t_filters.filter_ngram)
            == j.ngrams(2, uncased=True, filter_fn=j_filters.filter_ngram))
    rj, rt = j_tok.get_tokenizer("regexp"), t_tok.get_tokenizer("regexp")
    assert rt.tokenize(text).words() == rj.tokenize(text).words()


def test_filters_are_equal():
    assert t_filters.STOPWORDS == j_filters.STOPWORDS
    for text in TEXTS:
        assert t_filters.normalize(text) == j_filters.normalize(text)
        for w in text.split():
            assert t_filters.filter_word(w) == j_filters.filter_word(w)
    for gram in (["the", "film"], ["of", "and"], ["epic"], ["'s", "."]):
        for mode in ("any", "all", "ends"):
            assert t_filters.filter_ngram(gram, mode) == j_filters.filter_ngram(gram, mode)


# Both loaders, in a fresh process, on the library at argv[1]: a loader
# remembers its first load for the rest of its process, so this process's
# own answers depend on what the test run's other workers were building.
_LOADERS = """
import sys
from ircl_tpu.corpus import hashing as j_hash
from ircl_tpu_torch.corpus import hashing as t_hash
for m in (j_hash, t_hash):
    m._native_lib_path = lambda: sys.argv[1]
print(t_hash.native_available(), j_hash.native_available())
"""


def _loaders_on_a_complete_library(tmp_path, monkeypatch):
    """The two packages' ``native_available()`` on one complete library.

    The reference's ``build_native`` writes ``native/libircl_native.so`` in
    place, so on a fresh checkout another worker may be halfway through
    writing it while this one loads it. Here the port's ``build_native``,
    which renames a finished file into place, builds the library from the
    repository's source into ``tmp_path``, and a fresh process points both
    loaders at it.
    """
    root = t_build.repo_root()
    os.makedirs(tmp_path / "native")
    os.symlink(os.path.join(root, "native", "src"), tmp_path / "native" / "src")
    with monkeypatch.context() as m:
        m.setattr(t_build, "repo_root", lambda: str(tmp_path))
        lib = t_build.build_native()
    assert lib is None or os.path.exists(lib)
    proc = subprocess.run(
        [sys.executable, "-c", _LOADERS, str(lib or tmp_path / "missing.so")],
        cwd=root, capture_output=True, text=True, check=True, timeout=120,
    )
    return proc.stdout.strip()


def test_hashes_are_equal(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    words = ["".join(chr(int(c)) for c in rng.integers(97, 123, size=int(n)))
             for n in rng.integers(1, 12, size=200)] + ["café", "東京", ""]
    for w in words[:40] + words[-3:]:
        for seed in (0, 7):
            assert t_hash.murmurhash3_32(w, seed) == j_hash.murmurhash3_32(w, seed)
        assert t_hash.hash_token(w, 1 << 18) == j_hash.hash_token(w, 1 << 18)
    got, want = t_hash.hash_tokens(words, 1 << 20), j_hash.hash_tokens(words, 1 << 20)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert _loaders_on_a_complete_library(tmp_path, monkeypatch) in ("True True", "False False")
    assert t_hash._native_lib_path() == j_hash._native_lib_path()
    assert t_build.repo_root() == j_build.repo_root() and t_build._LIBS == j_build._LIBS


@pytest.mark.parametrize("ngram", [1, 2])
def test_batch_vectorize_is_equal(wikis, ngram):
    wiki = wikis[0]
    texts = TEXTS + [r["text"] for r in list(wiki.docs.values())[:10]]
    got = t_fast.batch_vectorize(texts, 1 << 18, ngram=ngram)
    want = j_fast.batch_vectorize(texts, 1 << 18, ngram=ngram)
    assert len(got) == len(want) == len(texts)
    for (gb, gc), (wb, wc) in zip(got, want):
        assert gb.dtype == wb.dtype and gc.dtype == wc.dtype
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gc, wc)
    # the native path and the Python path of the copy agree, as the original's
    one = t_fast._python_vectorize_one(t_filters.normalize(TEXTS[0]), 1 << 18, ngram)
    np.testing.assert_array_equal(one[0], got[0][0])
    np.testing.assert_array_equal(one[1], got[0][1])


def test_generated_docs_and_claims_are_equal(wikis):
    j, t = wikis
    assert t.docs == j.docs and t.sentences == j.sentences
    assert [dataclasses.asdict(c) for c in t.claims] == [
        dataclasses.asdict(c) for c in j.claims]
    assert t_syn.corpus_digest(t) == j_syn.corpus_digest(j)
    assert {c.label for c in t.claims} == {"SUPPORTS", "REFUTES"}


def test_fever_parsers_are_equal(wikis, tmp_path):
    j, _ = wikis
    assert t_fever.LABEL_MAP == j_fever.LABEL_MAP
    for s in ("Café_Ａ", "Köln_(city)"):
        assert t_fever.nfkd(s) == j_fever.nfkd(s) and t_fever.nfd(s) == j_fever.nfd(s)
    for rec in list(j.docs.values())[:5]:
        assert t_fever.parse_lines_tab(rec["lines"]) == j_fever.parse_lines_tab(rec["lines"])
        assert t_fever.extract_sentences(rec["lines"]) == j_fever.extract_sentences(rec["lines"])
    path = tmp_path / "claims.jsonl"
    with open(path, "w", encoding="utf-8") as f:
        for i, label in enumerate(["SUPPORTS", "REFUTES", "NOT ENOUGH INFO"]):
            ev = [[[0, 0, None, None]]] if i == 2 else [
                [[0, 0, "Doc_é", 1], [0, 0, "Other", 0]], [[1, 1, "Doc_é", 2]]]
            f.write(json.dumps({"id": i, "claim": f"claim {i}", "label": label,
                                "evidence": ev}) + "\n")
    for drop in (False, True):
        got = t_fever.parse_claims_jsonl(str(path), drop_nei=drop)
        want = j_fever.parse_claims_jsonl(str(path), drop_nei=drop)
        assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]
        assert t_fever.evidence_doc_ids(got) == j_fever.evidence_doc_ids(want)
    assert (t_fever.build_sentence_corpus(j.docs) == j_fever.build_sentence_corpus(j.docs))


def test_doc_stores_are_equal(wikis, tmp_path):
    j, _ = wikis
    texts = {d: r["text"] for d, r in j.docs.items()}
    ms, mj = t_store.MemoryDocStore(texts), j_store.MemoryDocStore(texts)
    assert ms.get_doc_ids() == mj.get_doc_ids() and len(ms) == len(mj)
    some = ms.get_doc_ids()[3]
    assert ms.get_doc_text(some) == mj.get_doc_text(some)
    assert ms.get_doc_text("no such doc") is None
    t_store.FlatDocStore.write(str(tmp_path / "t.json"), j.docs)
    j_store.FlatDocStore.write(str(tmp_path / "j.json"), j.docs)
    assert open(tmp_path / "t.json").read() == open(tmp_path / "j.json").read()
    with t_store.FlatDocStore(str(tmp_path / "j.json")) as fs, \
            j_store.FlatDocStore(str(tmp_path / "t.json")) as fj:
        assert fs.get_doc_ids() == fj.get_doc_ids()
        assert fs.get_doc_text(some) == fj.get_doc_text(some)
        assert fs.get_doc_lines(some) == fj.get_doc_lines(some)


def test_package_exports_and_sources_match():
    """The copy exports what the original exports, and differs from it in
    the import lines and the note in the module docstring only."""
    import ircl_tpu.corpus as j_corpus

    assert t_corpus.__all__ == j_corpus.__all__
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("tokenizer", "hashing", "filters", "fastpath", "store", "synthetic",
                 "fever"):
        want = open(os.path.join(root, "ircl_tpu", "corpus", name + ".py")).read()
        got = open(os.path.join(root, "ircl_tpu_torch", "corpus", name + ".py")).read()
        want_lines = [ln.replace("ircl_tpu.", "ircl_tpu_torch.") for ln in want.splitlines()]
        extra = [ln for ln in got.splitlines() if ln not in set(want_lines)]
        assert len(extra) <= 3 and all("arried over" in ln or "imports" in ln
                                        or "JAX package" in ln for ln in extra), (name, extra)
        assert [ln for ln in want_lines if ln not in set(got.splitlines())] == [], name
