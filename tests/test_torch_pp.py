"""The port's pipeline parallelism on an 8-rank gloo group against
``ircl_tpu.parallel.pp`` and the reference's single device.

Mirrors ``tests/test_pp.py``'s twelve tests on its config (4 layers, hidden
16, 4 heads, L=16 with two pads a row, B=8 for training and 16 for the
forward), its seeds and batches: the stacking round trip; the forward at
(stages, microbatches) = (4, 4), (2, 8) and (8, 2), where 4 layers do not
divide into 8 stages and both packages refuse; three AdamW steps with and
without recomputation, PP x DP, the stage shards' shapes; the MoE forward
and its aux, PP x DP over MoE blocks, PP x TP x DP, PP x EP x DP and PP x
EP x TP (training and forward); and the mesh's divisibility checks. The
parameters are drawn from the reference tests' seeds by the port's
initializer and handed to both packages as numpy arrays; the port's cases
run in one launch of 8 CPU ranks
(``parallel/launch.py``, targets in ``tests/_torch_ranks.py``), where a
mesh of 4 or 2 ranks runs as replicas over the group.

Tolerances are ``tests/test_pp.py``'s: losses rtol 2e-5 (atol 2e-6),
parameters rtol 5e-4 (atol 5e-6), the aux rtol 1e-5. The forward is held
to the reference's single device. Each training case holds its first
batch's loss and the gradient of every leaf (embeddings, head, every
stage's blocks), summed over the ranks by the hand-written reverse
pipeline, to ``jax.grad`` of the reference's single-device loss
(``test_torch_tp.py``'s GRAD_TOL; Adam would hide a gradient's scale),
and its three steps' losses and final parameters to the port's single
device, which ``tests/test_torch_verdict_train.py`` holds to the
reference's steps (compiling the reference's step for each config as well
cost a third of this file's time). Every rank at the same coordinates
holds the same shards, every rank the same replicated leaves.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_ranks
from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.models import transformer as j_tf
from ircl_tpu.parallel import pp as j_pp
from ircl_tpu.verdict import model as j_model
from ircl_tpu_torch.models import transformer as t_tf
from ircl_tpu_torch.parallel import pp as t_pp
from ircl_tpu_torch.parallel.launch import launch
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.utils.tree import tree_leaves
from ircl_tpu_torch.verdict import model as t_model
from test_torch_tp import (
    GRAD_TOL,
    LOSS_TOL,
    PARAM_TOL,
    RANKS,
    TIMEOUT,
    assert_layout,
    assert_trees_close,
    configs,
    np_tree,
    t_single,
)

LAYERS = 4  # tests/test_pp.py's TCFG
MOE = dict(num_experts=4, top_k=2)  # the default capacity factor keeps drops in play
AUX_RTOL = 1e-5


def _batch(seed, B=8, L=16):
    """``tests/test_pp.py``'s batch: two pads at the end of every row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 64, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    mask[:, L - 2:] = 0.0
    types = np.zeros((B, L), np.int32)
    labels = rng.integers(0, 2, size=(B,)).astype(np.int32)
    return ids, mask, types, labels


@functools.lru_cache(maxsize=None)
def _j_grad(cfg):
    """``jax.grad`` of the reference's single-device verdict loss (its
    train step's), compiled once a config."""

    def loss(params, ids, mask, types, labels):
        logits, aux = j_model.verdict_apply_with_aux(params, cfg, ids, mask, types)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
        return ce + cfg.moe_aux_weight * aux if cfg.encoder.moe is not None else ce

    return jax.jit(jax.value_and_grad(loss))


@functools.lru_cache(maxsize=None)
def _j_forward(enc):
    return jax.jit(lambda p, i, m, t: j_tf.transformer_apply_with_aux(p, enc, i, m, t))


def _tf_params(cfg, seed):
    """The transformer's initial parameters of the port's config ``cfg``,
    drawn from ``seed`` by the port's initializer, as numpy arrays for both
    packages (the reference's, drawn op by op, took a third of this file's
    time)."""
    return _torch_ranks._np(t_tf.init_transformer_params(
        torch.Generator().manual_seed(seed), cfg.encoder, "cpu"))


def _verdict_params(cfg, seed):
    return _torch_ranks._np(t_model.init_verdict_params(
        torch.Generator().manual_seed(seed), cfg, "cpu"))


@pytest.fixture(scope="module")
def runs():
    """Every case's inputs, then the ranks' launch in a thread while the
    reference's results are computed here (the two took about equal
    time, one after the other)."""
    assert len(jax.devices()) == RANKS, "conftest must force 8 CPU devices"
    j_cfg, t_cfg = configs(layers=LAYERS)
    jm_cfg, tm_cfg = configs(layers=LAYERS, moe=MOE)
    bad_j, bad_t = configs(layers=LAYERS, hidden=18, heads=3)
    cases, inputs = {}, {}
    # the forward
    p, arrays = _tf_params(t_cfg, 1), _batch(7, B=16)[:3]
    for stages, n_micro in ((4, 4), (2, 8), (8, 2)):
        cases[f"forward_{stages}_{n_micro}"] = ("pp_forward", dict(
            cfg=t_cfg.encoder, params=p, arrays=arrays, shape=dict(stage=stages),
            n_micro=n_micro))
    for name, seed, bseed, shape in (("moe_forward", 11, 17, dict(stage=4)),
                                     ("ep_tp_moe_forward", 23, 27,
                                      dict(stage=2, expert=2, model=2))):
        cases[name] = ("pp_forward", dict(cfg=tm_cfg.encoder, params=_tf_params(tm_cfg, seed),
                                          arrays=_batch(bseed, B=16)[:3], shape=shape,
                                          n_micro=4))
    # training: 3 AdamW steps; the first gradient against jax.grad
    train = {  # name: (MoE, seed, batch seed offset, mesh shape, remat)
        "train": (False, 2, 0, dict(stage=4), False),
        "train_remat": (False, 2, 0, dict(stage=4), True),
        "pp_dp": (False, 6, 40, dict(stage=4, data=2), False),
        "pp_dp_moe": (True, 12, 60, dict(stage=2, data=2), False),
        "pp_tp_dp": (False, 21, 80, dict(stage=2, data=2, model=2), False),
        "pp_ep_dp_moe": (True, 22, 90, dict(stage=2, data=2, expert=2), False),
        "pp_ep_tp_moe": (True, 29, 150, dict(stage=2, expert=2, model=2), False),
    }
    for name, (moe, seed, off, shape, remat) in train.items():
        tc = tm_cfg if moe else t_cfg
        p0, batches = _verdict_params(tc, seed), [_batch(s + off) for s in range(3)]
        cases[name] = ("pp_steps", dict(cfg=tc, params0=p0, batches=batches, shape=shape,
                                        n_micro=4, remat=remat))
        inputs[name] = (jm_cfg if moe else j_cfg, tc, p0, batches)
    # the mesh's divisibility checks
    refusals = (("heads", dict(stage=2, model=2), bad_j, bad_t),
                ("expert", dict(stage=2, expert=2), j_cfg, t_cfg))
    for name, shape, _, tc in refusals:
        cases[name] = ("pp_refusal", dict(cfg=tc.encoder, shape=shape))

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, _torch_ranks.parallel_runs, RANKS, cases, device="cpu",
                            timeout=TIMEOUT)
        refs = {}
        single = np.asarray(_j_forward(j_cfg.encoder)(p, *arrays)[0])
        for stages, n_micro in ((4, 4), (2, 8), (8, 2)):
            name = f"forward_{stages}_{n_micro}"
            if LAYERS % stages:  # the reference refuses to stack them
                with pytest.raises(ValueError) as e:
                    j_pp.stack_layer_params(p["layers"], stages)
                refs[name] = dict(raised=str(e.value))
            else:
                refs[name] = dict(single=single)
        for name in ("moe_forward", "ep_tp_moe_forward"):
            h, aux = _j_forward(jm_cfg.encoder)(cases[name][1]["params"],
                                                *cases[name][1]["arrays"])
            refs[name] = dict(single=np.asarray(h), aux=float(aux))
        for name, (jc, tc, p0, batches) in inputs.items():
            loss0, grads = _j_grad(jc)(p0, *map(jnp.asarray, batches[0]))
            refs[name] = dict(single=t_single(tc, p0, batches)[1:], grads=np_tree(grads),
                              grad_loss=float(loss0))
        for name, shape, jc, _ in refusals:
            with pytest.raises(ValueError) as e:
                j_pp.make_pp_transformer_apply(jc.encoder, j_pp.make_pp_mesh(
                    shape["stage"], model=shape.get("model", 1),
                    expert=shape.get("expert", 1)), n_micro=2)
            refs[name] = str(e.value)
        got = ranks.result()
    return dict(got=got, refs=refs, cfgs=(j_cfg, t_cfg))


def test_stack_roundtrip():
    """``tests/test_pp.py::test_stack_roundtrip``; the port's stacking of
    the reference's layers equals the reference's, bit for bit, and the
    reference's pipeline layout carried across (``utils/convert.py``)
    equals the port's own."""
    _, t_cfg = configs(layers=LAYERS)
    params = _tf_params(t_cfg, 0)
    layers = convert.transformer_params_from_numpy(params, "cpu")["layers"]
    stacked = t_pp.stack_layer_params(layers, 2)
    assert tuple(stacked["q"]["w"].shape) == (2, 2, 16, 16)
    for a, b in zip(tree_leaves(t_pp.unstack_layer_params(stacked)), tree_leaves(layers)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert_trees_close(_torch_ranks._np(stacked),
                       np_tree(j_pp.stack_layer_params(params["layers"], 2)), rtol=0, atol=0)
    with pytest.raises(ValueError, match="4 layers not divisible into 3 stages"):
        t_pp.stack_layer_params(layers, 3)
    vp = _verdict_params(t_cfg, 1)
    mine = t_pp.pp_verdict_params(convert.verdict_params_from_numpy(vp, "cpu"), 2)
    theirs = convert.pp_verdict_params_from_numpy(np_tree(j_pp.pp_verdict_params(vp, 2)),
                                                  "cpu")
    assert_trees_close(_torch_ranks._np(mine), _torch_ranks._np(theirs), rtol=0, atol=0)
    back = t_pp.verdict_params_from_pp(t_pp.restack_pp_params(theirs, 4))
    assert_trees_close(_torch_ranks._np(back), vp, rtol=0, atol=0)


@pytest.mark.parametrize("stages,n_micro", [(4, 4), (2, 8), (8, 2)])
def test_pp_forward_matches_single_device(runs, stages, n_micro):
    """The pipelined forward equals the reference's single device; 4 layers
    in 8 stages are refused as the reference's stacking refuses them."""
    name = f"forward_{stages}_{n_micro}"
    got, ref = runs["got"][name], runs["refs"][name]
    if "raised" in ref:
        assert got == ("raised", "ValueError", ref["raised"])
        return
    np.testing.assert_allclose(got["hidden"], ref["single"], **LOSS_TOL)
    assert got["aux"] is None


def _check_training(runs, name):
    got, ref = runs["got"][name], runs["refs"][name]
    losses, params = ref["single"]
    np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL)
    assert_trees_close(got["params"], params, **PARAM_TOL)
    np.testing.assert_allclose(got["grad_loss"], ref["grad_loss"], **LOSS_TOL)
    assert_trees_close(got["grads"], ref["grads"], **GRAD_TOL)
    assert_layout(got["layout"])
    return got


@pytest.mark.parametrize("remat", [False, True])
def test_pp_train_matches_single_device(runs, remat):
    """Three AdamW steps of PP(4): every leaf's first gradient meets
    ``jax.grad``, the losses and every final leaf the single device."""
    _check_training(runs, "train_remat" if remat else "train")


def test_pp_dp_train_matches_single_device(runs):
    """PP(4) x DP(2): a pipeline a data rank over its rows."""
    _check_training(runs, "pp_dp")


def test_pp_stage_params_actually_sharded(runs):
    """Each rank of PP(4) holds its stage's ``[1, 1, 16, 32]`` ff1 block,
    and Adam's moment takes its shape."""
    assert runs["got"]["train"]["local"] == ((1, 1, 16, 32), (1, 1, 16, 32))


def test_pp_moe_forward_matches_single_device(runs):
    """PP(4) over MoE blocks: the hidden state and the aux summed from the
    microbatches' routing statistics."""
    got, ref = runs["got"]["moe_forward"], runs["refs"]["moe_forward"]
    np.testing.assert_allclose(got["hidden"], ref["single"], **LOSS_TOL)
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=AUX_RTOL)


def test_pp_dp_moe_train_matches_single_device(runs):
    """PP(2) x DP(2) with MoE blocks: the routing sums added over the
    microbatches and ``data`` give the whole batch's aux."""
    _check_training(runs, "pp_dp_moe")


def test_pp_tp_dp_train_matches_single_device(runs):
    """PP(2) x TP(2) x DP(2): every stage Megatron-TP over ``model``."""
    got = _check_training(runs, "pp_tp_dp")
    assert got["local"][0] == (1, 2, 16, 16)


def test_pp_ep_dp_moe_train_matches_single_device(runs):
    """PP(2) x EP(2) x DP(2): two of the four experts a rank."""
    got = _check_training(runs, "pp_ep_dp_moe")
    assert got["local"][0] == (1, 2, 2, 16, 32)


def test_pp_ep_tp_moe_train_matches_single_device(runs):
    """PP(2) x EP(2) x TP(2) on the four-axis mesh (``data`` of 1)."""
    _check_training(runs, "pp_ep_tp_moe")


def test_pp_ep_tp_moe_forward_matches_single_device(runs):
    got, ref = runs["got"]["ep_tp_moe_forward"], runs["refs"]["ep_tp_moe_forward"]
    np.testing.assert_allclose(got["hidden"], ref["single"], **LOSS_TOL)
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=AUX_RTOL)


def test_pp_mesh_validates_divisibility(runs):
    """3 heads over a 2-rank ``model`` axis, and an ``expert`` axis under a
    dense model, are refused with the reference's messages."""
    for name in ("heads", "expert"):
        assert runs["got"][name] == ("raised", "ValueError", runs["refs"][name])
