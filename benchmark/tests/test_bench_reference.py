"""The frozen copies and plain references, held to the published algorithms
and, at small sizes on the CPU, to what the program derives from the same
inputs (the program is read here only to check the copies)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import corpus, roberta, scale, sparse, text
from benchmark.reference import wordpiece as ref_wp


def _murmur3_scalar(key: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86_32 as published, one key at a time."""
    m = 0xFFFFFFFF
    rotl = lambda x, r: ((x << r) | (x >> (32 - r))) & m  # noqa: E731
    h, n = seed, len(key)
    for i in range(n // 4):
        k = int.from_bytes(key[4 * i:4 * i + 4], "little")
        k = rotl(k * 0xCC9E2D51 & m, 15) * 0x1B873593 & m
        h = (rotl(h ^ k, 13) * 5 + 0xE6546B64) & m
    tail, k = key[n // 4 * 4:], 0
    for j in reversed(range(len(tail))):
        k ^= tail[j] << (8 * j)
    if tail:
        h ^= rotl(k * 0xCC9E2D51 & m, 15) * 0x1B873593 & m
    h ^= n
    for s, c in ((16, 0x85EBCA6B), (13, 0xC2B2AE35)):
        h = (h ^ (h >> s)) * c & m
    return h ^ (h >> 16)


def test_murmur3_matches_the_published_algorithm():
    rng = np.random.default_rng(0)
    keys = [b"", b"a", b"ab", b"abc", b"abcd", b"hello world"] + [
        bytes(rng.integers(32, 127, size=n).astype(np.uint8)) for n in rng.integers(0, 40, 300)]
    assert text.murmur3_32(keys).tolist() == [_murmur3_scalar(k) for k in keys]
    assert _murmur3_scalar(b"hello") == 0x248BFA47  # the algorithm's known value


def test_hashed_counts_equal_the_programs_vectorizer():
    from ircl_tpu_torch.corpus.fastpath import batch_vectorize

    c = corpus.generate(200, seed=3)
    texts = c.texts + corpus.draw_claims(c, 100, seed=4).texts + ["The cat's 3 toys, (again)!"]
    row, bucket, count = text.hashed_counts(texts, 1 << 20)
    for i, (u, n) in enumerate(batch_vectorize(texts, 1 << 20, 2)):
        assert np.array_equal(bucket[row == i], u) and np.array_equal(count[row == i], n)


def test_hashed_counts_refuse_non_ascii():
    with pytest.raises(ValueError):
        text.hashed_counts(["café"], 1 << 10)


def test_corpus_follows_its_model():
    c = corpus.generate(500, seed=5)
    n_sents = np.diff(c.sent_start)
    assert n_sents.min() >= 4 and n_sents.max() <= 8
    words = np.diff(c.word_start) - np.add.reduceat(c.is_entity, c.word_start[:-1])
    assert words.min() >= 8 and words.max() <= 15
    assert 0.75 < c.is_entity.sum() / n_sents.sum() < 0.85  # an entity in 80% of sentences
    assert len(set(c.titles)) == 500
    claims = corpus.draw_claims(c, 50, seed=6)
    for t, g in zip(claims.texts, claims.gold):
        sentences = " ".join(c.doc_sentences(g)).split()
        assert set(t.split()[:-4]) <= set(sentences)  # kept words, then 3 noise words and "."
    assert corpus.generate(50, seed=9).texts == corpus.generate(50, seed=9).texts


def test_zipf_ranks_follow_one_over_rank():
    x = scale.zipf_ranks(np.random.default_rng(1), 40, 400_000)
    p = 1.0 / np.arange(1, 41)
    p /= p.sum()
    f = np.bincount(x, minlength=40) / len(x)
    assert np.all(np.abs(f - p) < 5 * np.sqrt(p * (1 - p) / len(x)))


def test_synthetic_queries_hold_each_term_once():
    post = scale.synth_postings(2000, 20, 3000, 1 << 16, seed=2)
    qb, qw = scale.synth_queries(post.doc_freqs(), 2000, 500, 24, seed=3)
    assert all(len(set(r)) == 24 for r in qb.tolist())
    assert np.all(qw >= 0)


def test_sparse_reference_scores_as_a_dense_product():
    post = scale.synth_postings(300, 15, 500, 1 << 12, seed=4)
    ref = sparse.SparseReference(post.doc, post.bucket, post.count, 300, 1 << 12)
    qb, qw = scale.synth_queries(post.doc_freqs(), 300, 20, 6, seed=5)
    dense_d = np.zeros((300, 1 << 12))
    dense_d[post.doc, post.bucket] = ref.weight
    dense_q = np.zeros((20, 1 << 12))
    np.add.at(dense_q, (np.repeat(np.arange(20), 6), qb.ravel()), qw.ravel())
    full = dense_q @ dense_d.T
    asked = np.argsort(-full, axis=1)[:, :5]
    top = ref.topk(np.repeat(np.arange(20), 6), qb.ravel().astype(np.int64),
                   qw.ravel().astype(np.float64), 20, 5, asked)
    assert np.allclose(top.scores, -np.sort(-full, axis=1)[:, :5])
    assert np.allclose(top.lookup, np.take_along_axis(full, asked, 1))
    ok = sparse.score_gap(asked, top.lookup, top)
    assert ok.max() < 1e-12
    wrong = asked.copy()
    wrong[:, 0] = asked[:, -1]
    assert sparse.score_gap(wrong, np.take_along_axis(full, asked, 1), top).max() > 0


def test_wordpiece_copy_equals_the_programs():
    from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer

    c = corpus.generate(300, seed=7)
    vocab = ref_wp.train(c.texts, 700, 2)
    assert vocab == WordPieceTokenizer.train(c.texts, vocab_size=700, min_count=2).vocab
    cl = corpus.draw_claims(c, 16, seed=8)
    pairs = list(zip(cl.texts, corpus.evidence_texts(c, cl.gold, seed=9)))
    ids, mask, types = WordPieceTokenizer(vocab).encode_batch(pairs, 96)
    rids, rmask, rtypes = ref_wp.encode_pairs(pairs, vocab, 96)
    assert np.array_equal(ids, rids) and np.array_equal(mask, rmask)
    assert np.array_equal(types, rtypes) and rtypes.max() == 1


def _tiny_roberta():
    return {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
            "intermediate_size": 128, "vocab_size": 300, "max_position_embeddings": 130,
            "type_vocab_size": 1, "layer_norm_eps": 1e-05, "num_labels": 2}


def _verdict_config(c):
    from ircl_tpu_torch.models.transformer import TransformerConfig
    from ircl_tpu_torch.verdict.model import VerdictConfig

    enc = TransformerConfig(vocab_size=300, hidden=64, layers=2, heads=4, intermediate=128,
                            max_positions=128, type_vocab=1, layernorm_eps=1e-5,
                            position_offset=2, attention="flash")
    return VerdictConfig(encoder=enc, learning_rate=1e-3, warmup_steps=0, total_steps=100,
                         freeze_body_until_warmup=False, max_length=128)


def _batch(rng, b=4, L=128):
    """ids, mask and the pair encoder's types: 1 on the second segment,
    past roberta's one row."""
    ids = rng.integers(5, 300, size=(b, L))
    mask = np.zeros((b, L), np.float32)
    types = np.zeros((b, L), np.int64)
    for i, n in enumerate(rng.integers(10, L, size=b)):
        mask[i, :n] = 1
        types[i, n // 2:n] = 1
    return ids * mask.astype(np.int64), mask, types


def test_roberta_reference_equals_the_programs_forward():
    from ircl_tpu_torch.verdict.model import verdict_apply

    c = _tiny_roberta()
    params = roberta.init_params(c, 5, "cpu")
    ids, mask, types = (torch.as_tensor(x) for x in _batch(np.random.default_rng(0)))
    got = torch.softmax(verdict_apply(params, _verdict_config(c), ids, mask, types), -1)
    want = roberta.probabilities(c, params, ids, mask, types, 2)
    assert torch.allclose(got, want, atol=1e-6)
    tf32 = roberta.probabilities(c, params, ids, mask, types, 2, tf32=True)
    assert (tf32 - want).abs().max() > 1e-7


@pytest.fixture
def deterministic():
    """The program's embedding backward sums rows in parallel on the CPU, in
    an order that differs from run to run by more than the comparison's
    tolerance; its deterministic path sums them in one order."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_roberta_steps_equal_the_programs(deterministic):
    from ircl_tpu_torch.verdict.model import make_verdict_train_step

    c = _tiny_roberta()
    t = {"learning_rate": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8, "weight_decay": 1e-4,
         "warmup_steps": 0, "total_steps": 100}
    params = roberta.init_params(c, 6, "cpu")
    ref = roberta.Trainer(c, t, params, 2)
    step, tx = make_verdict_train_step(_verdict_config(c), device="cpu")
    state = tx.init(params)
    rng = np.random.default_rng(1)
    for i in range(3):
        ids, mask, types = _batch(rng)
        labels = rng.integers(0, 2, size=4)
        _, _, loss, _ = step(params, state, i, ids, mask, types, labels)
        want = ref.step(*(torch.as_tensor(x) for x in (ids, mask, types, labels)))
        assert abs(float(loss) - want) < 1e-5 * abs(want)
    # leaves with no gradient in exact arithmetic (a key bias under softmax)
    # move under Adam by rounding alone: the benchmark's rule leaves them out
    g = ref.first_grad_norms
    for p, q, gn in zip(roberta.leaves(params), ref.flat, g):
        if gn >= 1e-3 * g.median():
            assert torch.allclose(p, q, atol=2e-7)


def test_roberta_step_from_a_state_equals_the_programs(deterministic):
    """The reference goes on from the program's parameters and AdamW state,
    as the fine-tune cell's check of a window step does."""
    from ircl_tpu_torch.verdict.model import make_verdict_train_step

    c = _tiny_roberta()
    t = {"learning_rate": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8, "weight_decay": 1e-4,
         "warmup_steps": 0, "total_steps": 100}
    params = roberta.init_params(c, 7, "cpu")
    step, tx = make_verdict_train_step(_verdict_config(c), device="cpu")
    state = tx.init(params)
    rng = np.random.default_rng(2)
    batches = [_batch(rng) + (rng.integers(0, 2, size=4),) for _ in range(3)]
    for i, b in enumerate(batches[:2]):
        step(params, state, i, *b)
    ref = roberta.Trainer(c, t, params, 2, state=(
        [m.clone() for m in roberta.leaves(state["mu"])],
        [v.clone() for v in roberta.leaves(state["nu"])], state["count"]))
    _, _, loss, _ = step(params, state, 2, *batches[2])
    want = ref.step(*(torch.as_tensor(x) for x in batches[2]))
    assert abs(float(loss) - want) < 1e-5 * abs(want)
    g = ref.first_grad_norms
    moved = [(p, q) for p, q, gn in zip(roberta.leaves(params), ref.flat, g) if gn >= 1e-3 * g.median()]
    assert len(moved) > len(g) // 2
    assert all(torch.allclose(p, q, atol=2e-7) for p, q in moved)


def test_init_params_are_the_seeds():
    c = _tiny_roberta()
    a, b = roberta.init_params(c, 3, "cpu"), roberta.init_params(c, 3, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(roberta.leaves(a), roberta.leaves(b)))
    other = roberta.init_params(c, 4, "cpu")
    assert not torch.equal(roberta.leaves(a)[0], roberta.leaves(other)[0])
    w = roberta.leaves(a)[0]
    assert abs(float(w.std()) - 0.02) < 2e-3
