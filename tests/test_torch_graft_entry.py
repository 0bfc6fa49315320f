"""``ircl_tpu_torch/graft_entry.py`` against ``__graft_entry__.py``.

``entry()``: the reference's train state (``init_train_state(PRNGKey(0))``)
and hash table carried across (``utils/convert.py``), the port's forward
equals ``jax.jit`` of the reference's at rtol 1e-5 on the same ids, its
gradient in ``params_q`` equals ``jax.grad``'s (rtol 1e-4), and a backward
reaches ``params_q`` only.

``dryrun_multichip(8)``: the reference's dry run runs once in this process
on the 8 virtual CPU devices, with recorders wrapped around the functions it
imports inside its body (``make_dp_train_step``, ``sharded_cosine_topk``,
the sharded ELL and hybrid ``topk``, ``make_verdict_train_step``,
``make_pp_verdict_train_step``, ``make_cp_verdict_forward`` and
``make_cp_verdict_train_step``), which keep each section's initial
parameters, batches and outputs. Meanwhile the port's own seeded dry run
runs on 8 gloo CPU ranks in a thread; then the port's dry run runs again
from the reference's parameters. Section by section: the port drew the
reference's batches (one numpy generator consumed in the same order);
losses and the gradient norm at rtol 1e-5, the MoE sections' (``pp_moe``,
``pp_ep_tp``, ``ep``) too (they came within 1e-7: no route sits on a
near-tie at these seeds), CP's logits at rtol 2e-5 / atol 2e-6
(``tests/test_cp.py``'s forward tolerance); top-k scores at rtol 1e-4 with ids equal up to exact
ties (tf-idf scores of the sparse sections tie exactly). The port's own run
gives finite numbers of the reference's shapes in every section.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ref
from _torch_parity import assert_topk_match, one_torch_thread  # noqa: F401
from ircl_tpu.dense import scorer as j_scorer
from ircl_tpu.parallel import cp as j_cp
from ircl_tpu.parallel import dp as j_dp
from ircl_tpu.parallel import pp as j_pp
from ircl_tpu.parallel import sharded_hybrid as j_sharded_hybrid
from ircl_tpu.parallel import sharded_index as j_sharded_index
from ircl_tpu.verdict import model as j_model
from ircl_tpu_torch import graft_entry
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.utils.tree import tree_leaves

RANKS = 8
LOSS_RTOL = 1e-5
TOPK_RTOL = 1e-4
LOGITS_TOL = dict(rtol=2e-5, atol=2e-6)
LOSS_SECTIONS = ("tp", "sp", "pp", "pp_moe", "pp_ep_tp", "ep", "checkpoint")
TOPK_SECTIONS = ("dense", "ell", "hybrid")


def _np(tree):
    return jax.tree.map(np.array, tree)  # copies: the steps donate their inputs


def _carry_np(st):
    adam = st.opt_state[1][0]
    return dict(params_q=_np(st.params_q), params_k=_np(st.params_k),
                queue=np.array(st.queue), queue_ptr=int(st.queue_ptr), step=int(st.step),
                count=int(adam.count), mu=_np(adam.mu), nu=_np(adam.nu))


def _recorders(mp, rec):
    """Wrappers around the functions the reference's dry run imports in its
    body; each keeps its section's inputs and outputs in ``rec``."""
    make_dp, cosine = j_dp.make_dp_train_step, j_scorer.sharded_cosine_topk
    ell_topk = j_sharded_index.ShardedEllIndex.topk
    hyb_topk = j_sharded_hybrid.ShardedHybridIndex.topk
    make_v, make_p = j_model.make_verdict_train_step, j_pp.make_pp_verdict_train_step
    make_cf, make_cs = j_cp.make_cp_verdict_forward, j_cp.make_cp_verdict_train_step

    def dp(cfg, feat, mesh, *a, **kw):
        step, place_state, place_batch, place_proto = make_dp(cfg, feat, mesh, *a, **kw)

        def recorded(state, *batch):
            inp = dict(state=_carry_np(state), feat=_np(feat.params), batch=_np(batch))
            state, loss, norm = step(state, *batch)
            rec["dp"] = dict(inp, loss=float(loss), grad_norm=float(norm))
            return state, loss, norm

        return recorded, place_state, place_batch, place_proto

    def dense(q, c, *a, **kw):
        s, i = cosine(q, c, *a, **kw)
        rec["dense"] = dict(q=np.array(q), c=np.array(c), scores=np.array(s), ids=np.array(i))
        return s, i

    def topk(name, fn):
        def recorded(self, *a, **kw):
            s, i = fn(self, *a, **kw)
            rec[name] = dict(scores=np.array(s), ids=np.array(i))
            return s, i

        return recorded

    def verdict_maker(make, names):
        """Each step of the maker's makers, in call order: its params,
        batch, step index and loss under the next of ``names``."""
        order = iter(names)

        def maker(*a, **kw):
            step, tx = make(*a, **kw)

            def recorded(params, opt, idx, *batch):
                inp = dict(params=_np(params), batch=_np(batch), idx=int(idx))
                params, opt, loss, preds = step(params, opt, idx, *batch)
                rec[next(order)] = dict(inp, loss=float(loss))
                return params, opt, loss, preds

            return recorded, tx

        return maker

    def cp_forward(cfg, mesh):
        fwd = make_cf(cfg, mesh)

        def recorded(params, *arrays):
            logits = fwd(params, *arrays)
            rec["cp"] = dict(params=_np(params), batch=_np(arrays), logits=np.array(logits))
            return logits

        return recorded

    def cp_step(cfg, mesh, *a, **kw):
        step, tx = make_cs(cfg, mesh, *a, **kw)

        def recorded(params, opt, *batch):
            params, opt, loss = step(params, opt, *batch)
            rec["cp"].update(loss=float(loss), labels=np.array(batch[-1]))
            return params, opt, loss

        return recorded, tx

    # vstep runs TP's step 0 and the restored step 2; sp_step, then estep, come
    # between them
    mp.setattr(j_dp, "make_dp_train_step", dp)
    mp.setattr(j_scorer, "sharded_cosine_topk", dense)
    mp.setattr(j_sharded_index.ShardedEllIndex, "topk", topk("ell", ell_topk))
    mp.setattr(j_sharded_hybrid.ShardedHybridIndex, "topk", topk("hybrid", hyb_topk))
    mp.setattr(j_model, "make_verdict_train_step",
               verdict_maker(make_v, ["tp", "sp", "ep", "checkpoint"]))
    mp.setattr(j_pp, "make_pp_verdict_train_step",
               verdict_maker(make_p, ["pp", "pp_moe", "pp_ep_tp"]))
    mp.setattr(j_cp, "make_cp_verdict_forward", cp_forward)
    mp.setattr(j_cp, "make_cp_verdict_train_step", cp_step)


def _fed_inputs(rec):
    """The port's inputs with the reference's parameters and state."""
    inputs = graft_entry.dryrun_inputs(RANKS)
    inputs["dp"].update(state=rec["dp"]["state"], feat=rec["dp"]["feat"])
    for name in ("tp", "pp", "pp_moe", "pp_ep_tp", "ep", "cp"):
        inputs[name]["params"] = rec[name]["params"]
    return inputs


@pytest.fixture(scope="module")
def runs():
    """The reference's dry run with the port's own seeded one on a thread
    beside it, then the port's from the reference's parameters."""
    assert len(jax.devices()) == RANKS, "conftest must force 8 CPU devices"
    rec = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        own = pool.submit(graft_entry.dryrun_multichip, RANKS, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            _recorders(mp, rec)
            ref.dryrun_multichip(RANKS)
        seeded = own.result()
    inputs = _fed_inputs(rec)
    fed = graft_entry.dryrun_multichip(RANKS, device="cpu", inputs=inputs)
    return dict(rec=rec, seeded=seeded, fed=fed, inputs=inputs)


# ---- entry() -------------------------------------------------------------------


@pytest.fixture(scope="module")
def entries():
    j_fn, j_args = ref.entry()
    table = _np(ref._featurizer().params)
    featurizer = graft_entry._featurizer
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graft_entry, "_featurizer", lambda device=None, **kw: featurizer(
            device=device, params=convert.hash_featurizer_params_from_numpy(table, device),
            **kw))
        t_fn, t_args = graft_entry.entry(device="cpu")
    return j_fn, j_args, t_fn, t_args


def _carried(j_args):
    return [convert.encoder_params_from_numpy(_np(p), "cpu") for p in j_args[:2]]


def test_entry_matches_reference(entries):
    j_fn, j_args, t_fn, t_args = entries
    for got, want in zip(t_args[2:], j_args[2:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tuple(t_args[2].shape) == (16, 16)
    want = float(jax.jit(j_fn)(*j_args))
    got = float(t_fn(*_carried(j_args), *t_args[2:]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got > 0


def test_entry_backward_reaches_params_q_only(entries):
    """A backward of the port's loss reaches ``params_q`` only, and its
    gradient is ``jax.grad``'s in ``params_q``."""
    j_fn, j_args, t_fn, t_args = entries
    params_q, params_k = _carried(j_args)
    for leaf in tree_leaves(params_q) + tree_leaves(params_k):
        leaf.requires_grad_()
    t_fn(params_q, params_k, *t_args[2:]).backward()
    assert all(leaf.grad is None for leaf in tree_leaves(params_k))
    want = jax.tree.leaves(jax.jit(jax.grad(j_fn))(*j_args))
    got = tree_leaves(params_q)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    assert any(np.abs(g.grad.numpy()).max() > 0 for g in got)


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)


# ---- dryrun_multichip(8) -------------------------------------------------------


def test_dryrun_draws_the_reference_batches(runs):
    """One numpy generator, consumed in the reference's order: the dense
    queries and corpus, then the TP, PP and CP batches; the DP batch is the
    featurizer's hashing of the same texts."""
    rec, inp = runs["rec"], runs["inputs"]
    np.testing.assert_array_equal(inp["dense"]["q"], rec["dense"]["q"])
    np.testing.assert_array_equal(inp["dense"]["c"], rec["dense"]["c"])
    for name in ("tp", "pp", "pp_moe", "pp_ep_tp", "ep"):
        for got, want in zip(inp[name]["batch"], rec[name]["batch"]):
            np.testing.assert_array_equal(got, want, err_msg=name)
    ids, mask, types = rec["cp"]["batch"]
    for got, want in zip(inp["cp"]["batch"], (ids, mask, types, rec["cp"]["labels"])):
        np.testing.assert_array_equal(got, want)
    cfg = graft_entry._dp_config(RANKS)
    feat = graft_entry._featurizer(device="cpu")
    for got, want in zip(graft_entry._example_batch(cfg, feat), rec["dp"]["batch"]):
        np.testing.assert_array_equal(got.numpy(), want)
    assert [rec[n]["idx"] for n in ("tp", "sp", "ep", "checkpoint")] == [0, 1, 0, 2]


def test_dryrun_dp_step_matches_reference(runs):
    got, want = runs["fed"]["dp"], runs["rec"]["dp"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, err_msg=key)


@pytest.mark.parametrize("section", TOPK_SECTIONS)
def test_dryrun_topk_matches_reference(runs, section):
    got, want = runs["fed"][section], runs["rec"][section]
    assert_topk_match(got["scores"], got["ids"], want["scores"], want["ids"],
                      rtol=TOPK_RTOL)
    assert (got["ids"] >= 0).any()


@pytest.mark.parametrize("section", LOSS_SECTIONS)
def test_dryrun_step_loss_matches_reference(runs, section):
    np.testing.assert_allclose(runs["fed"][section]["loss"], runs["rec"][section]["loss"],
                               rtol=LOSS_RTOL)


def test_dryrun_cp_matches_reference(runs):
    got, want = runs["fed"]["cp"], runs["rec"]["cp"]
    np.testing.assert_allclose(got["logits"], want["logits"], **LOGITS_TOL)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)


def test_dryrun_seeded_run_is_finite_in_the_reference_shapes(runs):
    """The port's own draws: every section ran, its numbers finite, each of
    the reference's shape."""
    seeded, rec = runs["seeded"], runs["rec"]
    assert seeded["backend"] == runs["fed"]["backend"] == "gloo"
    assert set(seeded) - {"backend"} == set(graft_entry.SECTIONS) == set(rec)
    for name in graft_entry.SECTIONS:
        for key, value in seeded[name].items():
            want = rec[name][key]
            assert np.shape(value) == np.shape(want), (name, key)
            assert np.isfinite(value).all(), (name, key)
    assert 0.0 < float(seeded["tp"]["loss"]) < 2.0
