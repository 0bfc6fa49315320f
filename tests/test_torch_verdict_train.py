"""The port's verdict training against ``ircl_tpu.verdict`` on the same
weights, batches and seeds.

The model is the roberta-base shape cut to size (2 layers, hidden 64, 2
heads, L=128, positions offset by 2), on the "xla" path and on the "flash"
path, where ``jax.value_and_grad`` runs through the library's flash kernels
and their ``custom_vjp`` in the TPU interpret mode under ``jax.jit``.
Weights cross through ``utils/convert.py``.

Tolerances. Loss and every gradient leaf of one batch: 1e-5 absolute (fp32
on both sides, sums in another order), and each leaf within 1e-4 of its own
largest element, since the leaves' sizes span four orders of magnitude.
Losses over six steps: 1e-5.
Parameters after N unfrozen steps: Adam divides each gradient element by its
own running magnitude, so an element whose gradient is zero in exact
arithmetic (the key-projection bias: softmax is shift-invariant) or below
the rounding noise moves by up to the learning rate in either direction in
each package. Hence two bounds: no element differs by more than 2 * N * lr,
and at most one element in a thousand of any leaf by more than 1e-5. The
trainer's history: ``train_loss`` within 1e-4, ``val_macro_f1`` equal.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas.tpu import force_tpu_interpret_mode

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.corpus.fever import Claim as JClaim
from ircl_tpu.models import transformer as j_tf
from ircl_tpu.models.wordpiece import WordPieceTokenizer as JWordPiece
from ircl_tpu.verdict import data as j_data
from ircl_tpu.verdict import evaluate as j_eval
from ircl_tpu.verdict import model as j_model
from ircl_tpu.verdict import train as j_train
from ircl_tpu_torch.corpus.fever import Claim
from ircl_tpu_torch.models import transformer as t_tf
from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
from ircl_tpu_torch.ops import flash_attention_cuda as fa
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.utils.tree import tree_leaves, tree_map
from ircl_tpu_torch.verdict import data as t_data
from ircl_tpu_torch.verdict import evaluate as t_eval
from ircl_tpu_torch.verdict import infer as t_infer
from ircl_tpu_torch.verdict import model as t_model
from ircl_tpu_torch.verdict import train as t_train
from test_verdict import TINY, _toy_dataset

ATOL = 1e-5
L = 128
LR = 1e-3
WARMUP = 3
TF_KW = dict(vocab_size=100, hidden=64, layers=2, heads=2, intermediate=128,
             max_positions=L, position_offset=2, layernorm_eps=1e-5)
TRAIN_KW = dict(max_length=L, learning_rate=LR, warmup_steps=WARMUP, total_steps=10)


def _configs(attention, type_vocab=1, **train_kw):
    kw = dict(TF_KW, attention=attention, type_vocab=type_vocab)
    tr = dict(TRAIN_KW, **train_kw)
    return (j_model.VerdictConfig(encoder=j_tf.TransformerConfig(**kw), **tr),
            t_model.VerdictConfig(encoder=t_tf.TransformerConfig(**kw), **tr))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(attention, type_vocab=1, seed=0, **train_kw):
    j_cfg, t_cfg = _configs(attention, type_vocab, **train_kw)
    j_params = j_model.init_verdict_params(jax.random.PRNGKey(seed), j_cfg)
    for lp in j_params["body"]["layers"]:
        # N(0, 0.02) projections give near-uniform attention, whose q and k
        # gradients vanish: sharpen it, so that they are worth comparing
        lp["q"]["w"], lp["k"]["w"] = lp["q"]["w"] * 6.0, lp["k"]["w"] * 6.0
    t_params = convert.verdict_params_from_numpy(_np_tree(j_params), device="cpu")
    return j_cfg, t_cfg, j_params, t_params


def _batch(rng, B=4):
    """Token ids with pads at the end (one row of a single real token), the
    pair encoder's type ids (1 after the first segment, also where the model
    has one token type) and labels."""
    ids = rng.integers(5, 100, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    for b, n in enumerate([L, 60, 1, 90][:B]):
        mask[b, n:] = 0
        ids[b, n:] = 0
    types = np.zeros((B, L), np.int32)
    types[:, 20:] = 1
    types *= mask.astype(np.int32)
    return ids, mask, types, rng.integers(0, 2, size=B).astype(np.int32)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _t_loss_fn(t_cfg):
    def loss_fn(params, ids, mask, types, labels):
        logits, _ = t_model.verdict_apply_with_aux(params, t_cfg, ids, mask, types)
        return F.cross_entropy(logits, labels), logits

    return loss_fn


@pytest.mark.parametrize("type_vocab", [1, 2])
@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_loss_and_every_gradient_leaf_match_jax(attention, type_vocab):
    """With ``type_vocab=1`` the pair's type id 1 is out of range: both
    packages read row 0 and drop that read's gradient."""
    j_cfg, t_cfg, j_params, t_params = _pair(attention, type_vocab)
    ids, mask, types, labels = _batch(np.random.default_rng(0))

    def j_loss(params):
        logits, _ = j_model.verdict_apply_with_aux(
            params, j_cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    with force_tpu_interpret_mode():
        want_loss, want = jax.jit(jax.value_and_grad(j_loss))(j_params)
    before = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches)
    loss, logits, grads = t_model.value_and_grad(
        _t_loss_fn(t_cfg), t_params, torch.from_numpy(ids).long(),
        torch.from_numpy(mask), torch.from_numpy(types).long(),
        torch.from_numpy(labels).long())
    assert before == (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches)
    assert abs(float(loss) - float(want_loss)) <= ATOL
    assert not any(t.requires_grad for t in tree_leaves(t_params))
    want, got = dict(_named_leaves(want)), dict(_named_leaves(grads))
    assert want.keys() == got.keys() and len(want) == 5 + 16 * 2 + 4
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=ATOL,
                                   err_msg=name)
        size = np.abs(want[name]).max()
        if name.endswith("/k/b"):
            # zero in exact arithmetic (softmax is shift-invariant): both
            # packages hold rounding noise there
            assert size < 1e-9 and np.abs(got[name]).max() < 1e-9, name
        else:
            # the leaves differ in size by four orders of magnitude, so
            # each is also held to 1e-4 of its own largest element
            assert size > 1e-6, name
            assert np.abs(got[name] - want[name]).max() <= 1e-4 * size, name
    assert (types >= type_vocab).any() == (type_vocab == 1)


def test_gradient_of_a_clamped_gather_is_dropped_like_jax():
    kw = dict(TF_KW, type_vocab=1, max_positions=8)
    j_cfg, t_cfg = j_tf.TransformerConfig(**kw), t_tf.TransformerConfig(**kw)
    j_params = j_tf.init_transformer_params(jax.random.PRNGKey(2), j_cfg)
    t_params = convert.transformer_params_from_numpy(_np_tree(j_params), device="cpu")
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 100, size=(2, 12)).astype(np.int32)
    ids[0, 3] = 100  # past the vocabulary; 12 positions > 8 + 2
    types = np.zeros((2, 12), np.int32)
    types[:, 6:] = 1
    w = (0.01 * rng.normal(size=(2, 12, 64))).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(j_tf.transformer_embed(
        p, j_cfg, jnp.asarray(ids), jnp.asarray(types)) * w))(j_params)
    leaves = tree_map(lambda t: t.clone().requires_grad_(), t_params)
    (t_tf.transformer_embed(leaves, t_cfg, torch.from_numpy(ids).long(),
                            torch.from_numpy(types).long())
     * torch.from_numpy(w)).sum().backward()
    for name in ("tok_emb", "pos_emb", "type_emb"):
        np.testing.assert_allclose(leaves[name].grad.numpy(), np.asarray(want[name]),
                                   rtol=0, atol=ATOL, err_msg=name)
        assert np.abs(np.asarray(want[name])).max() > 0.05, name


def _assert_params_close(j_params, t_params, n_unfrozen):
    for (name, a), (_, b) in zip(_named_leaves(_np_tree(j_params)),
                                 _named_leaves(t_params)):
        diff = np.abs(a - b)
        assert diff.max() <= 2 * n_unfrozen * LR, name
        assert (diff > ATOL).mean() <= 1e-3, name


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_six_steps_across_the_warmup_boundary_match_the_reference(attention):
    j_cfg, t_cfg, j_params, t_params = _pair(attention)
    start = dict(_named_leaves(_np_tree(j_params)))
    j_step, j_tx = j_model.make_verdict_train_step(j_cfg)
    t_step, t_tx = t_model.make_verdict_train_step(t_cfg, device="cpu")
    j_state, t_state = j_tx.init(j_params), t_tx.init(t_params)
    assert t_state["count"] == 0 and not t_state["mu"]["head_out"]["w"].any()
    rng = np.random.default_rng(0)
    for s in range(6):
        ids, mask, types, labels = _batch(rng)
        with force_tpu_interpret_mode():
            j_params, j_state, j_loss, j_preds = j_step(
                j_params, j_state, jnp.asarray(s), *map(jnp.asarray,
                                                        (ids, mask, types, labels)))
        out = t_step(t_params, t_state, s, ids, mask, types, labels)
        assert out[0] is t_params and out[1] is t_state  # updated in place
        assert abs(float(out[2]) - float(j_loss)) <= ATOL, s
        np.testing.assert_array_equal(out[3].numpy(), np.asarray(j_preds))
        for tree in (_np_tree(j_params), t_params):
            now = dict(_named_leaves(tree))
            moved = {k for k in now if not np.array_equal(now[k], start[k])}
            if s < WARMUP:  # frozen: the body keeps its bits in both packages
                assert not any(k.startswith("/body") for k in moved), (s, moved)
                assert (s == 0) == (not moved)  # the first learning rate is 0
            else:
                assert all(k in moved for k in now if k.startswith("/body/layers")), s
        _assert_params_close(j_params, t_params, max(0, s + 1 - WARMUP) + 1)
    assert t_state["count"] == int(j_state[0].count) == 6
    for a, b in zip(jax.tree.leaves(_np_tree(j_state[0].mu)),
                    tree_leaves(t_state["mu"])):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=ATOL)


def test_unfrozen_config_moves_the_body_at_once():
    _, t_cfg, _, t_params = _pair("xla", freeze_body_until_warmup=False)
    start = tree_map(torch.clone, t_params)
    t_step, t_tx = t_model.make_verdict_train_step(t_cfg, device="cpu")
    state = t_tx.init(t_params)
    rng = np.random.default_rng(0)
    for s in range(2):
        t_step(t_params, state, s, *_batch(rng))
    assert not torch.equal(t_params["body"]["layers"][0]["q"]["w"],
                           start["body"]["layers"][0]["q"]["w"])


def test_resume_from_the_reference_optimizer_state():
    """Four reference steps, then params and optax state cross through
    ``utils/convert.py`` and both packages take two more."""
    j_cfg, t_cfg, j_params, _ = _pair("xla", warmup_steps=2)
    j_step, j_tx = j_model.make_verdict_train_step(j_cfg)
    t_step, _ = t_model.make_verdict_train_step(t_cfg, device="cpu")
    j_state = j_tx.init(j_params)
    rng = np.random.default_rng(3)
    for s in range(4):
        j_params, j_state, _, _ = j_step(j_params, j_state, jnp.asarray(s),
                                         *map(jnp.asarray, _batch(rng)))
    adam, schedule = j_state[0], j_state[2]
    assert int(adam.count) == int(schedule.count) == 4  # optax keeps one count
    t_params = convert.verdict_params_from_numpy(_np_tree(j_params), device="cpu")
    t_state = convert.verdict_opt_state_from_numpy(
        int(adam.count), _np_tree(adam.mu), _np_tree(adam.nu), device="cpu")
    assert t_state["count"] == 4 and t_state["nu"]["head_out"]["w"].any()
    for s in range(4, 6):
        batch = _batch(rng)
        j_params, j_state, j_loss, _ = j_step(j_params, j_state, jnp.asarray(s),
                                              *map(jnp.asarray, batch))
        _, _, loss, _ = t_step(t_params, t_state, s, *batch)
        assert abs(float(loss) - float(j_loss)) <= ATOL
    _assert_params_close(j_params, t_params, 2)


@pytest.mark.parametrize("count", [0, 1, WARMUP, 7, 10, 25])
def test_schedule_and_update_match_optax_at_a_count(count):
    """One update from a state whose count is set: learning rate, bias
    correction and decoupled decay together, on unit gradients."""
    j_cfg, t_cfg = _configs("xla")
    p = {"body": {"w": np.full((3,), 2.0, np.float32)},
         "head": {"w": np.full((2,), -1.0, np.float32)}}
    g = jax.tree.map(np.ones_like, p)
    j_tx = j_model.make_verdict_optimizer(j_cfg)
    state = j_tx.init(jax.tree.map(jnp.asarray, p))
    state = (state[0]._replace(count=jnp.asarray(count, jnp.int32)), state[1],
             state[2]._replace(count=jnp.asarray(count, jnp.int32)))
    updates, _ = j_tx.update(jax.tree.map(jnp.asarray, g), state,
                             jax.tree.map(jnp.asarray, p))
    want = optax.apply_updates(jax.tree.map(jnp.asarray, p), updates)
    t_tx = t_model.make_verdict_optimizer(t_cfg)
    t_p = tree_map(torch.tensor, p)
    t_state = dict(t_tx.init(t_p), count=count)
    t_tx.update_(t_p, tree_map(torch.tensor, g), t_state)
    assert t_state["count"] == count + 1
    for name in p:
        np.testing.assert_allclose(t_p[name]["w"].numpy(), np.asarray(want[name]["w"]),
                                   rtol=1e-6, atol=0)
    lr = t_tx.learning_rate(count)
    assert lr == pytest.approx({0: 0.0, 1: LR / 3, WARMUP: LR, 7: LR * 3 / 7,
                                10: 0.0, 25: 0.0}[count], abs=1e-12)


def test_frozen_update_withholds_the_decay_too():
    _, t_cfg = _configs("xla")
    tx = t_model.make_verdict_optimizer(t_cfg)
    p = {"body": {"w": torch.full((3,), 2.0)}, "head": {"w": torch.full((2,), -1.0)}}
    g = tree_map(torch.ones_like, p)
    state = dict(tx.init(p), count=2)
    tx.update_(p, g, state, body_on=False)
    assert torch.equal(p["body"]["w"], torch.full((3,), 2.0))
    assert not state["mu"]["body"]["w"].any() and state["mu"]["head"]["w"].all()
    assert not torch.equal(p["head"]["w"], torch.full((2,), -1.0))


# -- the trainer -----------------------------------------------------------

TOY_CORPUS = ["claim number topic evidence text affirmative positive contrary "
              "negative detail"]


@pytest.fixture(scope="module")
def toy():
    tok = JWordPiece.train(TOY_CORPUS * 2, vocab_size=256, min_count=1)
    enc = dataclasses.asdict(dataclasses.replace(TINY, vocab_size=tok.vocab_size))
    enc.pop("dtype"), enc.pop("moe")
    kw = dict(learning_rate=1e-3, warmup_steps=5, total_steps=1000, max_length=24)
    return (tok,
            j_model.VerdictConfig(encoder=j_tf.TransformerConfig(**enc), **kw),
            t_model.VerdictConfig(encoder=t_tf.TransformerConfig(**enc), **kw))


def test_train_verdict_history_matches_the_reference(toy):
    """Same ``init_params``, same seed: the same split, the same batches,
    the same history, with a tail that the epoch drops (57 train rows)."""
    tok, j_cfg, t_cfg = toy
    ids, mask, types, labels = _toy_dataset(tok, n=64)
    j_init = j_model.init_verdict_params(jax.random.PRNGKey(1), j_cfg)
    t_init = convert.verdict_params_from_numpy(_np_tree(j_init), device="cpu")
    keep = tree_map(torch.clone, t_init)
    kw = dict(epochs=3, batch_size=8, val_fraction=0.1, seed=5)
    _, want = j_train.train_verdict(j_cfg, ids, mask, types, labels,
                                    init_params=j_init, **kw)
    params, got = t_train.train_verdict(t_cfg, ids, mask, types, labels,
                                        init_params=t_init, device="cpu", **kw)
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert abs(g["train_loss"] - w["train_loss"]) <= 1e-4
        assert g["val_macro_f1"] == w["val_macro_f1"]
    for a, b in zip(tree_leaves(t_init), tree_leaves(keep)):
        assert torch.equal(a, b)  # the warm start is copied, not trained in place
    assert not torch.equal(params["head_out"]["w"], keep["head_out"]["w"])


def test_verdict_learns_separable_task(toy):
    """``tests/test_verdict.py::test_verdict_learns_separable_task`` on the
    port, from the port's own seeded init."""
    tok, _, t_cfg = toy
    ids, mask, types, labels = _toy_dataset(tok, n=128)
    params, history = t_train.train_verdict(
        t_cfg, ids, mask, types, labels, epochs=25, batch_size=16,
        val_fraction=0.1, seed=0, device="cpu")
    logits = t_model.verdict_apply(params, t_cfg, torch.from_numpy(ids).long(),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(types).long())
    acc = float(np.mean(logits.argmax(-1).numpy() == labels))
    assert acc >= 0.9, f"verdict classifier failed to learn: acc={acc}"
    assert len(history) == 25 and all(np.isfinite(h["train_loss"]) for h in history)


def test_trainer_options(toy, tmp_path):
    """``val_fraction=0``, ``stop_at_val_f1``, ``keep_best``, ``logdir`` and
    ``save_path``."""
    tok, _, t_cfg = toy
    ids, mask, types, labels = _toy_dataset(tok, n=48)
    run = lambda **kw: t_train.train_verdict(  # noqa: E731
        t_cfg, ids, mask, types, labels, batch_size=8, device="cpu", **kw)
    _, history = run(epochs=2, val_fraction=0, seed=1)
    assert [h["val_macro_f1"] for h in history] == [None, None]
    _, history = run(epochs=5, val_fraction=0.25, seed=1, stop_at_val_f1=0.0)
    assert len(history) == 1 and history[0]["val_macro_f1"] >= 0.0

    logdir, ckpt = str(tmp_path / "logs"), str(tmp_path / "ckpt")
    port_tok = WordPieceTokenizer(dict(tok.vocab))
    params, history = run(epochs=6, val_fraction=0.25, seed=2, split_seed=7,
                          keep_best=True, logdir=logdir, save_path=ckpt,
                          tokenizer=port_tok)
    val_idx = np.random.default_rng(7).permutation(48)[:12]
    preds = t_train.predict_in_batches(params, t_cfg, ids[val_idx], mask[val_idx],
                                       types[val_idx], device="cpu")
    best = max(h["val_macro_f1"] for h in history)
    assert t_eval.classification_report(labels[val_idx], preds)["macro_f1"] == best
    rows = [json.loads(line) for line in open(os.path.join(logdir, "verdict.jsonl"))]
    assert sum("qa_train_loss" in r for r in rows) == 6
    assert sum("qa_val_macro_f1" in r for r in rows) == 6
    cfg, loaded, loaded_tok = t_infer.load_verdict_checkpoint(ckpt, "cpu")
    assert cfg.encoder == t_cfg.encoder and loaded_tok.vocab == tok.vocab
    for a, b in zip(tree_leaves(loaded), tree_leaves(params)):
        assert torch.equal(a, b)
    clf = t_infer.VerdictClassifier.from_checkpoint(ckpt, batch_size=4, device="cpu")
    assert clf.classify(["claim number 1 about topic 2"],
                        ["evidence text affirmative positive detail 1"])
    with pytest.raises(ValueError, match="tokenizer"):
        run(epochs=1, save_path=ckpt)


def test_what_is_not_ported_raises(toy, tmp_path):
    """Once three raises naming ROADMAP.md queue 1 item 12, now none.
    ``mesh=`` that is not a mesh is refused with ``TypeError``; a
    ``"stage"`` mesh trains: on a one-rank group in this process, one
    stage in 2 microbatches, the history and the returned (standard
    layout) parameters meet the single-device run's; a ``("stage",
    "model")`` mesh is refused with ``ValueError``, as the reference
    refuses it; an activation hook (``constrain``) and a hook on the expert
    slabs (``ep_constrain``) run, and the identity leaves the forward and
    the step as they are."""
    from unittest import mock

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ircl_tpu_torch.parallel.pp import make_pp_mesh

    tok, _, t_cfg = toy
    ids, mask, types, labels = _toy_dataset(tok, n=8)
    with pytest.raises(TypeError, match="DeviceMesh"):
        t_train.train_verdict(t_cfg, ids, mask, types, labels, mesh=object(),
                              device="cpu")
    bad = mock.Mock(spec=DeviceMesh)  # a mesh object, without a process group
    bad.mesh_dim_names = ("stage", "model")
    with pytest.raises(ValueError, match="'data', 'stage'"):
        t_train.train_verdict(t_cfg, ids, mask, types, labels, mesh=bad, device="cpu")
    data = _toy_dataset(tok, n=24)
    init = t_model.init_verdict_params(torch.Generator().manual_seed(3), t_cfg, "cpu")
    kw = dict(epochs=2, batch_size=4, val_fraction=0.2, seed=2)
    p_one, want = t_train.train_verdict(t_cfg, *data, init_params=init, device="cpu", **kw)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        p_pp, got = t_train.train_verdict(t_cfg, *data, init_params=init, pp_micro=2,
                                          mesh=make_pp_mesh(1, device="cpu"), **kw)
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=2e-5)
        assert g["val_macro_f1"] == w["val_macro_f1"]
    assert tree_map(lambda t: t.shape, p_pp) == tree_map(lambda t: t.shape, p_one)
    for a, b in zip(tree_leaves(p_pp), tree_leaves(p_one)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4, atol=5e-6)
    params = t_model.init_verdict_params(torch.Generator().manual_seed(0), t_cfg, "cpu")
    args = (params, t_cfg, torch.from_numpy(ids).long(), torch.from_numpy(mask))
    seen = []
    hooked, _ = t_model.verdict_apply_with_aux(
        *args, constrain=lambda x: seen.append(x.shape) or x)
    logits, aux = t_model.verdict_apply_with_aux(*args)
    assert torch.equal(hooked, logits) and logits.shape == (8, 2) and float(aux) == 0.0
    assert len(seen) == 1 + t_cfg.encoder.layers  # after the embedding, each block
    runs = []
    for hook in (None, lambda x: x):
        p = tree_map(torch.clone, params)
        step, tx = t_model.make_verdict_train_step(t_cfg, ep_constrain=hook, device="cpu")
        _, _, loss, _ = step(p, tx.init(p), 0, ids, mask, types, labels)
        runs.append((float(loss), tree_leaves(p)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.parametrize("n,batch_size", [(11, 4), (8, 4), (3, 32), (0, 4)])
def test_predict_in_batches_matches_the_reference(toy, n, batch_size):
    """A ragged tail, an exact multiple, fewer rows than one batch, none."""
    tok, j_cfg, t_cfg = toy
    ids, mask, types, _ = _toy_dataset(tok, n=max(n, 1), seed=4)
    ids, mask, types = ids[:n], mask[:n], types[:n]
    j_params = j_model.init_verdict_params(jax.random.PRNGKey(8), j_cfg)
    t_params = convert.verdict_params_from_numpy(_np_tree(j_params), device="cpu")
    want = j_train.predict_in_batches(j_params, j_cfg, ids, mask, types, batch_size)
    got = t_train.predict_in_batches(t_params, t_cfg, ids, mask, types, batch_size,
                                     device="cpu")
    assert got.shape == want.shape == (n,)
    np.testing.assert_array_equal(got, want)


# -- the framework-free modules, carried over --------------------------------

@pytest.mark.parametrize("seed,classes", [(0, 2), (1, 2), (2, 3)])
def test_classification_report_equals_the_reference(seed, classes):
    rng = np.random.default_rng(seed)
    y_true, y_pred = rng.integers(0, classes, 100), rng.integers(0, classes, 100)
    got = t_eval.classification_report(y_true, y_pred)
    assert got == j_eval.classification_report(y_true, y_pred)
    assert t_eval.format_report(got) == j_eval.format_report(got)
    one_class = t_eval.classification_report(np.zeros(5, int), np.zeros(5, int))
    assert one_class == j_eval.classification_report(np.zeros(5, int), np.zeros(5, int))


def test_examples_equal_the_reference(toy):
    tok = toy[0]
    fields = [(1, "c one", "SUPPORTS", {"Doc_A": [0]}),
              (2, "c two", "REFUTES", {"Doc_B": [1], "Doc_é": [0, 5]}),
              (3, "c three", "NOT ENOUGH INFO", {})]
    sents = {"Doc_A": ["a0 text", "a1 text"], "Doc_B": ["b0", "b1 gold"],
             "Doc_é": ["accented"]}
    override = [[("Doc_B", 0)], [("Doc_A", 1)], []]
    for ev in (None, override):
        got = t_data.build_examples([Claim(*f) for f in fields], sents, ev)
        want = j_data.build_examples([JClaim(*f) for f in fields], sents, ev)
        assert [dataclasses.asdict(e) for e in got] == [dataclasses.asdict(e) for e in want]
        assert len(got) == 2  # NEI dropped
    port_tok = WordPieceTokenizer(dict(tok.vocab))
    for g, w in zip(t_data.encode_examples(got, port_tok, 24),
                    j_data.encode_examples(want, tok, 24)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
