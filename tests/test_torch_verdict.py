"""The port's verdict classifier against ``ircl_tpu.verdict`` on the same
weights.

The JAX parameters are carried across with
``utils/convert.py::verdict_params_from_numpy`` and the same seeded inputs
go through both packages. The model is the roberta-base shape cut to size:
2 layers, hidden 64, 2 heads, one token type (``type_vocab=1``), positions
offset by 2, L=128 (the library flash kernel's smallest length), on the
"xla" path and on the "flash" path (the library kernel in the TPU interpret
mode). The pair encoder writes type id 1 after the first ``[SEP]``, out of
range for one token type: JAX's gather clamps it to row 0, and so must the
port. Tolerance: 1e-5 absolute on logits and confidences (fp32, sums in
another order); labels, host arrays and checkpoint files exactly.

The JAX forward runs under ``jax.jit``, as the reference's classifier runs
it: dispatched op by op, the interpret mode's callbacks can wait behind the
ops queued after the kernel, and the process hangs.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.tpu import force_tpu_interpret_mode

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.models import moe as j_moe
from ircl_tpu.models import transformer as j_tf
from ircl_tpu.models.wordpiece import WordPieceTokenizer as JWordPiece
from ircl_tpu.verdict import infer as j_infer
from ircl_tpu.verdict import model as j_model
from ircl_tpu_torch.models import moe as t_moe
from ircl_tpu_torch.models import transformer as t_tf
from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
from ircl_tpu_torch.ops import flash_attention_cuda as fa
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.verdict import infer as t_infer
from ircl_tpu_torch.verdict import model as t_model

ATOL = 1e-5
L = 128
j_verdict_apply = jax.jit(j_model.verdict_apply, static_argnums=1)
j_transformer_apply = jax.jit(j_tf.transformer_apply, static_argnums=1)
TF_KW = dict(hidden=64, layers=2, heads=2, intermediate=128, max_positions=L,
             type_vocab=1, position_offset=2, layernorm_eps=1e-5)
TEXTS = [
    "Nikolaj Coster-Waldau worked with the Fox Broadcasting Company.",
    "Roman Atwood is a content creator.",
    "The Ten Commandments is an epic film.",
    "History of art includes architecture, dance, sculpture, music, painting, "
    "poetry literature, theatre, narrative, film, photography and graphic arts.",
    "Tokyo is the capital of Japan and its most populous city.",
]
PAIRS = [
    (TEXTS[0], TEXTS[1] + " " + TEXTS[3]),
    (TEXTS[2], ""),
    ("", ""),
    (TEXTS[4], TEXTS[3] * 3),  # truncated at L
    (TEXTS[1], TEXTS[0]),
]


@pytest.fixture(scope="module")
def tok():
    return JWordPiece.train(TEXTS * 2, vocab_size=200, min_count=1)


def _configs(vocab_size, attention):
    kw = dict(TF_KW, vocab_size=vocab_size, attention=attention)
    return (j_model.VerdictConfig(encoder=j_tf.TransformerConfig(**kw), max_length=L),
            t_model.VerdictConfig(encoder=t_tf.TransformerConfig(**kw), max_length=L))


def _pair(tok, attention, seed=0):
    j_cfg, t_cfg = _configs(tok.vocab_size, attention)
    j_params = j_model.init_verdict_params(jax.random.PRNGKey(seed), j_cfg)
    t_params = convert.verdict_params_from_numpy(
        jax.tree.map(np.asarray, j_params), device="cpu")
    return j_cfg, t_cfg, j_params, t_params


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_pairs_carry_type_ids_out_of_range(tok):
    _, _, types = tok.encode_batch(PAIRS, L)
    assert types.max() == 1 and TF_KW["type_vocab"] == 1


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_verdict_apply_matches_jax(tok, attention):
    j_cfg, t_cfg, j_params, t_params = _pair(tok, attention)
    ids, mask, types = tok.encode_batch(PAIRS, L)
    with force_tpu_interpret_mode():
        want = np.asarray(j_verdict_apply(
            j_params, j_cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types)))
    before = fa.flash_attention.launches
    got = t_model.verdict_apply(t_params, t_cfg, _t(ids).long(), _t(mask),
                                _t(types).long()).numpy()
    assert fa.flash_attention.launches == before  # the CPU runs the plain version
    assert got.shape == want.shape == (len(PAIRS), 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    pred = t_model.verdict_predict(t_params, t_cfg, _t(ids).long(), _t(mask),
                                   _t(types).long()).numpy()
    np.testing.assert_array_equal(pred, got.argmax(-1))


def test_flash_hidden_states_match_jax_pad_rows_included(tok):
    """Whole hidden states of the flash path, pad rows too: there the
    library's pad rows attend to the pads, and the port's do the same."""
    j_cfg, t_cfg, j_params, t_params = _pair(tok, "flash", seed=1)
    ids, mask, types = tok.encode_batch(PAIRS[:3], L)
    with force_tpu_interpret_mode():
        want = np.asarray(j_transformer_apply(
            j_params["body"], j_cfg.encoder, jnp.asarray(ids), jnp.asarray(mask),
            jnp.asarray(types)))
    got = t_tf.transformer_apply(t_params["body"], t_cfg.encoder, _t(ids).long(),
                                 _t(mask), _t(types).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["type_ids", "token_ids", "positions"])
def test_embedding_gathers_clamp_like_jax(case):
    """Indices past a table's end read its last row, as JAX's gather does."""
    kw = dict(TF_KW, vocab_size=50, max_positions=8, position_offset=2)
    j_cfg, t_cfg = j_tf.TransformerConfig(**kw), t_tf.TransformerConfig(**kw)
    j_params = j_tf.init_transformer_params(jax.random.PRNGKey(2), j_cfg)
    t_params = convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, j_params), device="cpu")
    rng = np.random.default_rng(0)
    n = 12 if case == "positions" else 8  # 12 positions > max_positions + offset
    ids = rng.integers(0, 50, size=(2, n)).astype(np.int32)
    types = np.zeros((2, n), np.int32)
    if case == "token_ids":
        ids[0, 3], ids[1, 0] = 50, 777
    if case == "type_ids":
        types[:, n // 2:] = 1
    want = np.asarray(j_tf.transformer_embed(j_params, j_cfg, jnp.asarray(ids),
                                             jnp.asarray(types)))
    got = t_tf.transformer_embed(t_params, t_cfg, _t(ids).long(), _t(types).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_init_matches_the_reference_layout(tok):
    j_cfg, t_cfg = _configs(tok.vocab_size, "flash")
    j_params = j_model.init_verdict_params(jax.random.PRNGKey(0), j_cfg)
    t_params = t_model.init_verdict_params(torch.Generator().manual_seed(0), t_cfg,
                                         device="cpu")
    shapes = lambda tree: jax.tree.map(lambda a: tuple(np.shape(a)), tree)  # noqa: E731
    assert shapes(jax.tree.map(lambda t: t.numpy(), t_params)) == shapes(j_params)
    w = t_params["head_dense"]["w"]
    assert abs(float(w.std()) - 0.02) < 0.002 and not t_params["head_out"]["b"].any()
    again = t_model.init_verdict_params(torch.Generator().manual_seed(0), t_cfg,
                                         device="cpu")
    assert torch.equal(again["head_out"]["w"], t_params["head_out"]["w"])


def test_converter_checks_the_keys(tok):
    _, _, j_params, _ = _pair(tok, "xla")
    tree = jax.tree.map(np.asarray, j_params)
    with pytest.raises(KeyError, match="head_out"):
        convert.verdict_params_from_numpy({k: v for k, v in tree.items()
                                           if k != "head_out"})
    with pytest.raises(KeyError, match="layer"):
        convert.verdict_params_from_numpy(
            dict(tree, body=dict(tree["body"], layers=[{"q": 0}])))


def _port_tok(tok, tmp_path):
    path = str(tmp_path / "vocab.txt")
    tok.save_vocab(path)
    return WordPieceTokenizer.from_vocab_file(path)


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_checkpoint_round_trip_classifies_like_jax(tok, tmp_path, attention):
    """JAX params -> converter -> ``save_verdict_checkpoint`` ->
    ``VerdictClassifier.from_checkpoint``: the same verdicts as the JAX
    classifier on the same weights, over more pairs than one batch."""
    j_cfg, t_cfg, j_params, t_params = _pair(tok, attention, seed=3)
    ckpt = str(tmp_path / "ckpt")
    t_infer.save_verdict_checkpoint(ckpt, t_cfg, t_params, _port_tok(tok, tmp_path))
    clf = t_infer.VerdictClassifier.from_checkpoint(ckpt, batch_size=4, device="cpu")
    assert clf.cfg == t_cfg and clf.device == torch.device("cpu")
    j_clf = j_infer.VerdictClassifier(j_cfg, j_params, tok, batch_size=4)
    claims = [c for c, _ in PAIRS] + [TEXTS[2]]
    evidence = [e for _, e in PAIRS] + [TEXTS[4]]
    with force_tpu_interpret_mode():
        want = j_clf.classify(claims, evidence)
    got = clf.classify(claims, evidence)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert (g["label"], g["label_id"]) == (w["label"], w["label_id"])
        assert abs(g["confidence"] - w["confidence"]) <= ATOL
    assert clf.classify([], []) == []
    with pytest.raises(ValueError, match="evidence texts"):
        clf.classify(["a"], [])


def test_checkpoint_files_are_the_references(tok, tmp_path):
    """``verdict_config.json`` as ``cli train-verdict`` writes it, the
    vocabulary line for line, and the params back bit for bit."""
    j_cfg, t_cfg, _, t_params = _pair(tok, "flash")
    ckpt = str(tmp_path / "ckpt")
    t_infer.save_verdict_checkpoint(ckpt, t_cfg, t_params, _port_tok(tok, tmp_path))
    with open(os.path.join(ckpt, "verdict_config.json")) as f:
        meta = json.load(f)
    assert meta == {  # cli.py's cmd_train_verdict
        "encoder": dataclasses.asdict(j_cfg.encoder) | {"dtype": None},
        "num_labels": j_cfg.num_labels,
        "max_length": j_cfg.max_length,
    }
    tok.save_vocab(str(tmp_path / "want_vocab.txt"))
    assert (open(os.path.join(ckpt, "verdict_vocab.txt")).read()
            == open(tmp_path / "want_vocab.txt").read())
    cfg, params, port_tok = t_infer.load_verdict_checkpoint(ckpt, "cpu")
    assert cfg == t_cfg and port_tok.vocab == tok.vocab
    leaves = lambda tree: jax.tree.leaves(jax.tree.map(np.asarray, tree))  # noqa: E731
    assert len(leaves(params)) == len(leaves(t_params))
    for a, b in zip(leaves(params), leaves(t_params)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_with_moe_is_refused(tok, tmp_path):
    """A MoE checkpoint, once refused, now loads: the reference's MoE
    weights saved by the port come back with the same ``MoEConfig`` the
    reference rebuilds from the JSON, and classify as the reference does on
    the same weights."""
    kw = dict(TF_KW, vocab_size=tok.vocab_size, attention="xla")
    moe = dict(num_experts=4, top_k=2, capacity_factor=2.0)
    j_cfg = j_model.VerdictConfig(
        encoder=j_tf.TransformerConfig(**kw, moe=j_moe.MoEConfig(**moe)), max_length=L)
    t_cfg = t_model.VerdictConfig(
        encoder=t_tf.TransformerConfig(**kw, moe=t_moe.MoEConfig(**moe)), max_length=L)
    j_params = j_model.init_verdict_params(jax.random.PRNGKey(4), j_cfg)
    ckpt = str(tmp_path / "ckpt")
    t_infer.save_verdict_checkpoint(
        ckpt, t_cfg,
        convert.verdict_params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu"),
        _port_tok(tok, tmp_path))
    meta = json.load(open(os.path.join(ckpt, "verdict_config.json")))
    assert meta["encoder"]["moe"] == dataclasses.asdict(j_cfg.encoder.moe)
    cfg, params, port_tok = t_infer.load_verdict_checkpoint(ckpt, "cpu")
    assert cfg == t_cfg and isinstance(cfg.encoder.moe, t_moe.MoEConfig)
    ids, mask, types = tok.encode_batch(PAIRS, L)
    want = np.asarray(j_verdict_apply(
        j_params, j_cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types)))
    got = t_model.verdict_apply(params, cfg, _t(ids).long(), _t(mask),
                                _t(types).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_padding_is_invisible(tok, tmp_path, attention):
    """``tests/test_verdict.py:34-48`` on the port: scrambled pad ids leave
    the real positions alone, and a row alone classifies as it does inside
    its batch."""
    _, t_cfg, _, t_params = _pair(tok, attention)
    ids, mask, types = tok.encode_batch(PAIRS, L)
    body = lambda i: t_tf.transformer_apply(  # noqa: E731
        t_params["body"], t_cfg.encoder, _t(i).long(), _t(mask), _t(types).long())
    scrambled = ids.copy()
    pads = mask == 0
    scrambled[pads] = np.random.default_rng(0).integers(1, tok.vocab_size, pads.sum())
    real = mask.astype(bool)
    np.testing.assert_allclose(body(scrambled).numpy()[real], body(ids).numpy()[real],
                               rtol=0, atol=2e-5)
    clf = t_infer.VerdictClassifier(t_cfg, t_params, _port_tok(tok, tmp_path),
                                    batch_size=4)
    claims, evidence = [c for c, _ in PAIRS], [e for _, e in PAIRS]
    many = clf.classify(claims, evidence)
    for i in (0, 3):
        (one,) = clf.classify([claims[i]], [evidence[i]])
        assert one["label_id"] == many[i]["label_id"]
        assert abs(one["confidence"] - many[i]["confidence"]) <= 1e-6


def test_classifier_validation(tok):
    _, t_cfg, _, t_params = _pair(tok, "xla")
    with pytest.raises(ValueError, match="batch_size"):
        t_infer.VerdictClassifier(t_cfg, t_params, tok, batch_size=0)
    assert t_infer.LABEL_NAMES == j_infer.LABEL_NAMES
