"""The native WordPiece pair encoder of ``WordPieceTokenizer.encode_batch``
(``ircl_tpu_torch/csrc/wordpiece.cpp::ircl_wordpiece_encode_pairs``) against
the Python path, ``encode_pair`` row by row: equal ids, mask and types, bit
for bit, on generated pairs and on the edge cases of the word split, the
greedy match and the truncation; the rows each path took; the fallbacks."""

import copy
import pickle
import threading

import numpy as np
import pytest

from ircl_tpu_torch.models import wordpiece as wp
from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer


@pytest.fixture(scope="module")
def native():
    """The library with the encoder, built from its source if need be."""
    if wp._native_encoder() is None:
        pytest.fail("g++ is needed to build the native WordPiece encoder")


_SYLLABLES = ["an", "ber", "cor", "del", "en", "fa", "gro", "han", "is", "jo", "ka",
              "lu", "mer", "no", "ost", "pra", "qui", "ro", "sta", "ter", "ul", "vin",
              "wes", "xa", "yor", "zen"]
_GLUE = ["the", "of", "and", "in", "is", "a", "was", "by", "to", "for"]


def _sentences(rng, n_words):
    """ASCII prose in the shape of encyclopedia sentences: capitalised words,
    numbers, hyphens, apostrophes, brackets and sentence punctuation."""
    out = []
    for i in range(n_words):
        r = rng.random()
        if r < 0.3:
            w = _GLUE[rng.integers(len(_GLUE))]
        elif r < 0.38:
            w = str(int(rng.integers(1, 3000)))
        else:
            w = "".join(rng.choice(_SYLLABLES, size=int(rng.integers(1, 5))))
            if rng.random() < 0.3:
                w = w.capitalize()
            if rng.random() < 0.05:
                w += "-" + "".join(rng.choice(_SYLLABLES, size=2))
            if rng.random() < 0.03:
                w = f"({w})"
            if rng.random() < 0.03:
                w += "'s"
        if rng.random() < 0.08:
            w += rng.choice([",", ".", ";", ":"])
        out.append(w)
    return " ".join(out)


def _generated(seed, n_pairs=64):
    """A corpus to train a vocabulary on, and claim-evidence pairs: short
    claims, evidence of 10-700 words (past 512 pieces for some)."""
    rng = np.random.default_rng([2**31 + 5, seed])
    texts = [_sentences(rng, int(rng.integers(20, 200))) for _ in range(200)]
    pairs = [(_sentences(rng, int(rng.integers(4, 20))),
              _sentences(rng, int(rng.integers(10, 700)))) for _ in range(n_pairs)]
    return texts, pairs


@pytest.fixture(scope="module")
def generated():
    return _generated(0)


def _python(tok, pairs, max_length):
    """``encode_pair`` of each pair, stacked as ``encode_batch`` types them."""
    rows = [tok.encode_pair(a, b, max_length) for a, b in pairs]
    return tuple(np.asarray([r[j] for r in rows], dt)
                 for j, dt in enumerate((np.int32, np.float32, np.int32)))


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _encode(tok, pairs, max_length):
    """``encode_batch`` against the Python path; the rows each path took."""
    before = tok.native_rows, tok.python_rows
    _same(tok.encode_batch(pairs, max_length), _python(tok, pairs, max_length))
    return tok.native_rows - before[0], tok.python_rows - before[1]


def _toy(words, max_input_chars=100):
    """A vocabulary of the specials, every character alone and as a
    continuation, and ``words`` (a leading ``##`` marks a suffix)."""
    vocab = {s: i for i, s in enumerate(wp.SPECIALS)}
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789.,!?-'()":
        for tok in (ch, "##" + ch):
            vocab.setdefault(tok, len(vocab))
    for w in words:
        vocab.setdefault(w, len(vocab))
    return WordPieceTokenizer(vocab, max_input_chars)


TOY_WORDS = ["the", "claim", "evidence", "##ing", "##s", "run", "runn", "fact", "##ual",
             "check", "##er", "un", "##believ", "##able"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_length", [512, 128, 64])
def test_generated_pairs(native, seed, max_length):
    texts, pairs = _generated(seed)
    tok = WordPieceTokenizer.train(texts, vocab_size=600)
    assert _encode(tok, pairs, max_length) == (len(pairs), 0)


@pytest.mark.parametrize("max_length", [2, 3, 4, 5, 7, 12, 33])
def test_truncation_on_each_side(native, max_length):
    tok = _toy(TOY_WORDS)
    long = " ".join(["the unbelievable factual checker runs"] * 6)
    short = "claim"
    pairs = [(long, short), (short, long), (long, long), (long, ""), (long, None),
             (short, short), ("", long), (long + " " + long, long)]
    assert _encode(tok, pairs, max_length) == (len(pairs), 0)


def test_empty_texts_and_padding_pairs(native):
    tok = _toy(TOY_WORDS)
    pairs = [("", ""), ("the claim", ""), ("the claim", None), ("", "the evidence"),
             ("", None), (" \t\n", "\x7f"), ("", ""), ("", "")]
    assert _encode(tok, pairs, 16) == (len(pairs), 0)
    ids, mask, types_ = tok.encode_batch(pairs, 16)
    # an empty second text gets no second [SEP]: [CLS] the claim [SEP] [PAD]...
    assert mask[1].sum() == mask[2].sum() == 4 and types_[1].sum() == 0


def test_words_over_the_character_limit(native):
    tok = _toy(TOY_WORDS)
    pairs = [("a" * 100 + " the", "b" * 101 + " claim"), ("x" * 250, "the " + "9" * 99)]
    assert _encode(tok, pairs, 64) == (2, 0)
    small = _toy(TOY_WORDS, max_input_chars=5)
    assert _encode(small, [("check checker claims", "runs unbelievable")], 32) == (1, 0)
    ids, *_ = small.encode_batch([("checker", None)], 8)
    assert ids[0, 1] == small.vocab[wp.UNK]  # seven characters > 5


def test_characters_no_piece_matches(native):
    vocab = {s: i for i, s in enumerate(wp.SPECIALS)}
    for tok in ("a", "b", "##a", "##b", "ab", "##ab", "c"):
        vocab[tok] = len(vocab)
    tok = WordPieceTokenizer(vocab)
    # "q" matches nothing; "abq" fails at its third character and is [UNK]
    # whole; "ca" needs "##a" after "c"; "$" is a word of its own
    pairs = [("q abq ab", "ca $ ba"), ("abab babc", "cq")]
    assert _encode(tok, pairs, 32) == (2, 0)
    ids, *_ = tok.encode_batch([("abq", None)], 4)
    assert ids[0].tolist() == [vocab[wp.CLS], vocab[wp.UNK], vocab[wp.SEP], vocab[wp.PAD]]


def test_case_punctuation_and_control_characters(native):
    tok = _toy(TOY_WORDS + ["!!", "..."])
    texts = ["The CLAIM, Checked!!! ... (really?)", "tab\there\nnew\rline\x7fdel\x00nul",
             "MiXeD-CaSe--words'n'quotes \"x\" #1 $2 %3 &4 *5 +6 /7 :8 ;9 <=> @[\\]^_`{|}~",
             "\x01\x02\x1f spaced    out\t\t\tTABS", "".join(chr(c) for c in range(128))]
    pairs = [(a, b) for a in texts for b in texts]
    assert _encode(tok, pairs, 48) == (len(pairs), 0)


def test_mixed_ascii_and_non_ascii_rows(native):
    tok = _toy(TOY_WORDS + ["caf", "##é", "é"])
    pairs = [("the claim", "the evidence"), ("café claim", "the evidence"),
             ("the claim", "naïve evidence"), ("unbelievable", None), ("東京", None),
             ("", ""), ("runs", "ﬁ ligature")]
    assert _encode(tok, pairs, 24) == (3, 4)


def test_python_fallback_without_the_library(generated, monkeypatch):
    texts, pairs = generated
    tok = WordPieceTokenizer.train(texts, vocab_size=600)
    monkeypatch.setattr(wp, "_native_encoder", lambda: None)
    assert _encode(tok, pairs[:8], 128) == (0, 8)
    assert tok._table is None


def test_pickled_tokenizer_encodes_the_same(native, generated):
    texts, pairs = generated
    tok = WordPieceTokenizer.train(texts, vocab_size=600)
    want = tok.encode_batch(pairs, 128)
    assert tok._table is not None
    back = pickle.loads(pickle.dumps(tok))
    assert back._table is None and back.vocab == tok.vocab
    _same(back.encode_batch(pairs, 128), want)
    assert back._table is not None and back._table != tok._table
    _same(copy.deepcopy(tok).encode_batch(pairs, 128), want)


def test_threads_share_one_table(native, generated):
    """Concurrent callers of one tokenizer read its one table and each get
    the Python path's rows."""
    texts, pairs = generated
    tok = WordPieceTokenizer.train(texts, vocab_size=600)
    want = _python(tok, pairs, 512)
    got = [None] * 4
    start = threading.Barrier(4)

    def run(i):
        start.wait()
        got[i] = tok.encode_batch(pairs, 512)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g in got:
        _same(g, want)
