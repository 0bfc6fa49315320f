"""The port's MoE FFN (``ircl_tpu_torch/models/moe.py``) against
``ircl_tpu.models.moe`` on the same numpy inputs and weights.

The single-device cases of ``tests/test_ep.py`` (``:67``, ``:97``, ``:119``,
``:127``, ``:199``, ``:260``, ``:286``, ``:317``, ``:341``) run in both
packages, and then the MoE transformer, the MoE verdict model's loss and
gradients, and six train steps, on the "xla" and the "flash" paths at the
verdict model's cut shape (2 layers, hidden 64, 2 heads, L=128).

Tolerances. ``moe_route`` on the reference's own logits: dispatch exactly
equal (a one-hot of the same routes), combine within rtol 1e-6 (the
softmax of another library), aux within rtol 1e-6. ``moe_ffn`` and the MoE
transformer: within 1e-5 of the reference's largest element (fp32 on both
sides, sums in another order). The verdict model: the tolerances of
``tests/test_torch_verdict_train.py``.

Routes are discontinuous: a top-k pick can flip where two router
probabilities tie to rounding, and a flipped pick moves a token to another
expert (and may push another out of capacity). Every comparison therefore
first asserts that in the reference's router probabilities the k-th and
(k+1)-th largest of every real token lie at least ``MARGIN`` of the k-th
apart (a softmax's rounding is relative to the probability), so that a
near-tie fails loudly as such and not as a parity error. The verdict
model's routers are drawn as the reference draws them and then scaled by
20, as the attention's q and k are sharpened by 6 in
``tests/test_torch_verdict_train.py``: N(0, 0.02) routers give every token
near-uniform probabilities, picks that a trained router would not make,
and tokens that no capacity limit ever drops.
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
from ircl_tpu.models import moe as j_moe
from ircl_tpu.models import transformer as j_tf
from ircl_tpu.verdict import model as j_model
from ircl_tpu_torch.models import moe as t_moe
from ircl_tpu_torch.models import transformer as t_tf
from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
from ircl_tpu_torch.ops import flash_attention_cuda as fa
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.utils.tree import tree_leaves
from ircl_tpu_torch.verdict import infer as t_infer
from ircl_tpu_torch.verdict import model as t_model
from test_torch_verdict_train import (
    ATOL,
    LR,
    TF_KW,
    TRAIN_KW,
    WARMUP,
    _assert_params_close,
    _batch,
    _named_leaves,
    _np_tree,
)

MARGIN = 1e-5
RTOL_ROUTE = 1e-6
RTOL_FFN = 1e-5
MOE = dict(num_experts=4, top_k=2, capacity_factor=2.0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _configs(**moe_kw):
    kw = dict(MOE, **moe_kw)
    return j_moe.MoEConfig(**kw), t_moe.MoEConfig(**kw)


def _assert_route_margin(probs, top_k, mask=None):
    """The reference's probabilities ``[..., E]`` keep every real token's
    k-th and (k+1)-th choice ``MARGIN`` of the k-th apart."""
    probs = np.asarray(probs, np.float64)
    if top_k >= probs.shape[-1]:
        return
    top = -np.sort(-probs, axis=-1)
    gap = (top[..., top_k - 1] - top[..., top_k]) / top[..., top_k - 1]
    if mask is not None:
        gap = gap[np.asarray(mask) > 0]
    assert gap.min() >= MARGIN, f"a near-tie in the routes: gap {gap.min()}"


def _rel_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_moe_config_validates_top_k():
    """``tests/test_ep.py:341``, and the capacity of both packages."""
    for kw in (dict(num_experts=2, top_k=3), dict(num_experts=4, top_k=0)):
        with pytest.raises(ValueError) as want:
            j_moe.MoEConfig(**kw)
        with pytest.raises(ValueError) as got:
            t_moe.MoEConfig(**kw)
        assert str(got.value) == str(want.value)
    for kw, S in ((MOE, 16), (dict(num_experts=8, top_k=2, capacity_factor=1.25), 512),
                  (dict(num_experts=4, top_k=2, capacity_factor=0.5), 16),
                  (dict(num_experts=3, top_k=1, capacity_factor=0.01), 7)):
        j_cfg, t_cfg = j_moe.MoEConfig(**kw), t_moe.MoEConfig(**kw)
        assert t_moe.moe_capacity(S, t_cfg) == j_moe.moe_capacity(S, j_cfg)
    assert t_moe.moe_capacity(512, t_moe.MoEConfig()) == 160


def _route_both(logits, j_cfg, t_cfg, C, mask=None, return_stats=False):
    jl = jnp.asarray(logits)
    _assert_route_margin(jax.nn.softmax(jl, axis=-1), j_cfg.top_k, mask)
    want = jax.jit(j_moe.moe_route, static_argnums=(1, 2, 4))(
        jl, j_cfg, C, None if mask is None else jnp.asarray(mask), return_stats)
    got = t_moe.moe_route(_t(logits), t_cfg, C, None if mask is None else _t(mask),
                          return_stats=return_stats)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL_ROUTE, atol=0)
    return got, want


@pytest.mark.parametrize("case", ["capacity", "collapse", "mask", "stats"])
def test_moe_route_matches_reference(case):
    """``tests/test_ep.py:97`` (capacity and slots), ``:119`` (collapse),
    and the masked and raw-statistics forms, in both packages."""
    rng = np.random.default_rng(0)
    mask = None
    if case == "collapse":
        kw = dict(num_experts=4, top_k=1, capacity_factor=4.0)
        logits = np.zeros((2, 16, 4), np.float32)
        logits[..., 0] = 10.0
    else:
        kw = dict(num_experts=4, top_k=2, capacity_factor=0.5)
        logits = rng.normal(size=(3, 16, 4)).astype(np.float32)
    if case in ("mask", "stats"):
        mask = np.ones((3, 16), np.float32)
        mask[0, 5:], mask[2, 12:] = 0.0, 0.0
    j_cfg, t_cfg = _configs(**kw)
    C = t_moe.moe_capacity(16, t_cfg)
    (d, c, aux), (_, _, want_aux) = _route_both(
        logits, j_cfg, t_cfg, C, mask, return_stats=case == "stats")
    if case == "stats":
        for key in ("f_sum", "p_sum", "n"):
            np.testing.assert_allclose(aux[key].numpy(), np.asarray(want_aux[key]),
                                       rtol=RTOL_ROUTE, atol=0)
        aux = t_moe.moe_aux_from_stats(aux)
        want_aux = j_moe.moe_aux_from_stats(want_aux)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=RTOL_ROUTE)
    d = d.numpy()
    assert (d.sum(axis=1) <= 1.0).all()  # a slot holds one token at most
    assert (d.sum(axis=(1, 3)) <= C).all()  # an expert takes C tokens at most
    assert (d.sum(axis=(2, 3)) <= t_cfg.top_k).all()
    assert ((c.numpy() > 0) <= (d > 0)).all()
    if case == "collapse":
        assert float(aux) > 0.9 * 4  # all mass on expert 0: aux ~ E
    else:
        assert float(aux) > 0.9
    if mask is not None:
        assert d[mask == 0].sum() == 0  # pads dispatched nowhere


def test_moe_route_fuzz_matches_reference():
    """``tests/test_ep.py:260``: 25 random (E, top_k, capacity_factor, S, B)
    configurations from its seed, every route equal and every invariant
    held in both packages."""
    rng = np.random.default_rng(42)
    for trial in range(25):
        E = int(rng.integers(1, 9))
        top_k = int(rng.integers(1, E + 1))
        cf = float(rng.uniform(0.2, 3.0))
        S = int(rng.integers(2, 33))
        B = int(rng.integers(1, 5))
        j_cfg, t_cfg = _configs(num_experts=E, top_k=top_k, capacity_factor=cf)
        C = t_moe.moe_capacity(S, t_cfg)
        logits = rng.normal(size=(B, S, E)).astype(np.float32)
        (d, c, aux), (_, _, want_aux) = _route_both(logits, j_cfg, t_cfg, C)
        msg = f"trial {trial}: E={E} k={top_k} cf={cf:.2f} S={S} B={B} C={C}"
        d, c = d.numpy(), c.numpy()
        assert (d.sum(axis=1) <= 1.0).all(), msg
        assert (d.sum(axis=(1, 3)) <= C).all(), msg
        assert (d.sum(axis=(2, 3)) <= top_k).all(), msg
        assert ((c > 0) <= (d > 0)).all(), msg
        assert (c.sum(axis=(2, 3)) <= 1.0 + 1e-4).all(), msg
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=RTOL_ROUTE,
                                   err_msg=msg)


def _ffn_both(x, j_cfg, t_cfg, seed=0, E=None, mask=None):
    E = E or j_cfg.num_experts
    j_p = j_moe.init_moe_ffn_params(jax.random.PRNGKey(seed), 16, 32, E)
    t_p = convert._from_numpy(_np_tree(j_p), "cpu")
    xj = jnp.asarray(x)
    logits = jnp.einsum("bsh,he->bse", xj, j_p["router"]["w"])
    _assert_route_margin(jax.nn.softmax(logits, axis=-1), j_cfg.top_k, mask)
    jm = None if mask is None else jnp.asarray(mask)
    want_y, want_aux = j_moe.moe_ffn(xj, j_p, j_cfg, mask=jm)
    got_y, got_aux = t_moe.moe_ffn(_t(x), t_p, t_cfg, mask=None if mask is None else _t(mask))
    assert _rel_max(got_y.numpy(), want_y) <= RTOL_FFN
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=RTOL_FFN)
    return got_y.numpy(), np.asarray(want_y)


@pytest.mark.parametrize("case", ["routed", "overflow", "mask", "grouped"])
def test_moe_ffn_matches_reference(case):
    """``tests/test_ep.py:127`` (overflow: dropped tokens pass through with
    a zero delta), ``:286`` (pads: zero delta, no capacity, out of the aux)
    and ``:317`` (routing groups, here against the reference's own grouped
    layer), in both packages."""
    x = np.random.default_rng(1).normal(size=(2, 16, 16)).astype(np.float32)
    mask = None
    if case == "overflow":
        j_cfg, t_cfg = _configs(num_experts=2, top_k=1, capacity_factor=0.25)
    elif case == "mask":
        j_cfg, t_cfg = _configs(num_experts=2, top_k=1, capacity_factor=1.0)
        mask = np.ones((2, 16), np.float32)
        mask[:, 10:] = 0.0
    elif case == "grouped":
        j_cfg, t_cfg = _configs(capacity_factor=4.0, group_size=4)
    else:
        j_cfg, t_cfg = _configs()
    got, _ = _ffn_both(x, j_cfg, t_cfg, mask=mask)
    kept = np.abs(got).max(axis=-1) > 0
    if case == "overflow":
        C = t_moe.moe_capacity(16, t_cfg)
        assert kept.sum(axis=1).max() <= 2 * C and (~kept).any()
    if case == "mask":
        assert not kept[:, 10:].any() and kept[:, :10].all()


def test_group_size_must_divide_the_sequence():
    x = torch.zeros(2, 16, 16)
    p = t_moe.init_moe_ffn_params(torch.Generator().manual_seed(0), 16, 32, 4, "cpu")
    with pytest.raises(ValueError, match="group_size=5 must divide"):
        t_moe.moe_ffn(x, p, t_moe.MoEConfig(num_experts=4, top_k=2, group_size=5))


def test_init_draws_expert_leading_weights():
    """The reference's tree and scales; other bits by design (a
    ``torch.Generator``)."""
    want = _np_tree(j_moe.init_moe_ffn_params(jax.random.PRNGKey(0), 64, 128, 8))
    got = t_moe.init_moe_ffn_params(torch.Generator().manual_seed(0), 64, 128, 8, "cpu")
    shapes = lambda tree: {n: a.shape for n, a in _named_leaves(tree)}  # noqa: E731
    assert shapes(got) == shapes(want)
    assert abs(float(got["ff1"]["w"].std()) - 0.02) < 0.002
    assert not got["ff1"]["b"].any() and not got["ff2"]["b"].any()


@pytest.fixture(scope="module")
def two_rank_moe():
    """``moe_ffn`` over 2 gloo ranks: the EP hook on a ``("data", "expert")``
    mesh and ``expert_axis`` (2 of 4 experts a rank), and ``model_axis``
    (every expert's ff1 columns and ff2 rows halved), in one launch; beside
    them the whole layer's output, aux and gradients."""
    from _torch_ranks import layer_parity
    from ircl_tpu_torch.parallel.launch import launch

    ecfg = t_moe.MoEConfig(num_experts=4, top_k=2, capacity_factor=1.0)
    rng = np.random.default_rng(4)
    p = _np_tree(j_moe.init_moe_ffn_params(jax.random.PRNGKey(3), 16, 32, 4))
    p = jax.tree.map(lambda a: a + np.float32(0.05) * rng.normal(size=a.shape).astype(
        np.float32), p)  # biases off zero: ff2.b is added on model rank 0 alone
    p["router"]["w"] = p["router"]["w"] * np.float32(20.0)  # routes far from ties
    x = rng.normal(size=(2, 16, 16)).astype(np.float32)
    w = rng.normal(size=(2, 16, 16)).astype(np.float32)
    mask = np.ones((2, 16), np.float32)
    mask[1, 11:] = 0.0
    views = jax.tree.map(lambda a: torch.tensor(a).requires_grad_(), p)
    xt = torch.tensor(x).requires_grad_()
    y, aux = t_moe.moe_ffn(xt, views, ecfg, mask=_t(mask))
    grads = torch.autograd.grad((y * _t(w)).sum() + aux, [xt] + jax.tree.leaves(views))
    want = dict(y=y.detach().numpy(), aux=float(aux.detach()), grad_x=grads[0].numpy(),
                grads=[g.numpy() for g in grads[1:]])
    base = dict(layer="moe", cfg=ecfg, params=p, x=x, mask=mask, w=w)
    cases = {
        "ep_constrain": dict(base, specs="ep", axes={"data": 1, "expert": 2},
                             kwargs={"ep_constrain": "hook"}),
        "expert_axis": dict(base, specs="ep", axes={"expert": 2},
                            kwargs={"expert_axis": "expert"}),
        "model_axis": dict(base, specs="tp_moe", axes={"model": 2},
                           kwargs={"model_axis": "model"}),
    }
    return launch(layer_parity, 2, cases, device="cpu", timeout=300.0), want


@pytest.mark.parametrize("what", ["ep_constrain", "model_axis", "expert_axis"])
def test_expert_parallel_hooks_wait_for_item_12(two_rank_moe, what):
    """Once a raise naming ROADMAP.md queue 1 item 12, now the hooks'
    parity on 2 ranks: ``make_ep_constrainer(mesh)`` and ``expert_axis``
    (each rank its 2 experts, the combine summed over ``expert``) and
    ``model_axis`` (each expert's FFN Megatron-sharded, ``ff2.b`` added on
    rank 0 alone) equal the whole layer: output, aux, the gradient of the
    input and of every parameter (f32 sums in another order)."""
    got, want = two_rank_moe
    got = got[what]
    assert got["local"] == ((2, 16, 32) if what != "model_axis" else (4, 16, 16))
    for key in ("y", "grad_x"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)
    assert got["aux"] == pytest.approx(want["aux"], rel=1e-6)
    for g, w in zip(jax.tree.leaves(got["grads"]), want["grads"]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# -- the MoE transformer and verdict model -----------------------------------

VERDICT_MOE = dict(num_experts=4, top_k=2, capacity_factor=1.25)


def _verdict_pair(attention, seed=0, **train_kw):
    """Reference and port MoE verdict configs and the reference's weights
    (q and k sharpened as ``tests/test_torch_verdict_train.py`` does)."""
    kw = dict(TF_KW, attention=attention, type_vocab=1)
    tr = dict(TRAIN_KW, **train_kw)
    j_cfg = j_model.VerdictConfig(
        encoder=j_tf.TransformerConfig(**kw, moe=j_moe.MoEConfig(**VERDICT_MOE)), **tr)
    t_cfg = t_model.VerdictConfig(
        encoder=t_tf.TransformerConfig(**kw, moe=t_moe.MoEConfig(**VERDICT_MOE)), **tr)
    j_params = j_model.init_verdict_params(jax.random.PRNGKey(seed), j_cfg)
    for lp in j_params["body"]["layers"]:
        lp["q"]["w"], lp["k"]["w"] = lp["q"]["w"] * 6.0, lp["k"]["w"] * 6.0
        lp["moe"]["router"]["w"] = lp["moe"]["router"]["w"] * 20.0  # decisive routes
    t_params = convert.verdict_params_from_numpy(_np_tree(j_params), device="cpu")
    return j_cfg, t_cfg, j_params, t_params


def _assert_reference_routes_clear(j_cfg, j_params, ids, mask, types):
    """The margin of every layer's routes, in the reference's own forward."""
    enc = j_cfg.encoder

    def router_probs(params, i, m, t):
        x = j_tf.transformer_embed(params["body"], enc, i, t)
        ctx = j_tf.attention_mask_inputs(enc, m)
        out = []
        for lp in params["body"]["layers"]:
            h = j_tf.attention_sublayer(x, lp, enc, ctx)
            out.append(jax.nn.softmax(h @ lp["moe"]["router"]["w"], axis=-1))
            x, _ = j_tf.transformer_block(x, lp, enc, ctx, moe_mask=m)
        return out

    with force_tpu_interpret_mode():
        probs = jax.jit(router_probs)(j_params, *map(jnp.asarray, (ids, mask, types)))
    for p in probs:
        _assert_route_margin(p, enc.moe.top_k, mask)


def test_moe_e1_matches_dense_ffn():
    """``tests/test_ep.py:67`` on the port: one expert, top-1, capacity
    factor 1 is the dense FFN (up to the gate's 1e-9 normalizer), with aux
    exactly 1; and the port's MoE transformer meets the reference's."""
    dense_kw = dict(TF_KW, type_vocab=1)
    e1 = dict(num_experts=1, top_k=1, capacity_factor=1.0)
    j_dense = j_tf.init_transformer_params(jax.random.PRNGKey(0),
                                           j_tf.TransformerConfig(**dense_kw))
    moe_tree = {k: v for k, v in j_dense.items() if k != "layers"}
    moe_tree["layers"] = []
    for dl in j_dense["layers"]:
        ml = {k: dl[k] for k in ("q", "k", "v", "o", "attn_ln", "ff_ln")}
        ml["moe"] = {
            "router": {"w": jnp.zeros((TF_KW["hidden"], 1))},
            "ff1": {"w": dl["ff1"]["w"][None], "b": dl["ff1"]["b"][None]},
            "ff2": {"w": dl["ff2"]["w"][None], "b": dl["ff2"]["b"][None]},
        }
        moe_tree["layers"].append(ml)
    ids, _, _, _ = _batch(np.random.default_rng(1))
    mask = np.ones(ids.shape, np.float32)  # the dense FFN also moves pads
    t_dense_cfg = t_tf.TransformerConfig(**dense_kw)
    t_moe_cfg = t_tf.TransformerConfig(**dense_kw, moe=t_moe.MoEConfig(**e1))
    j_moe_cfg = j_tf.TransformerConfig(**dense_kw, moe=j_moe.MoEConfig(**e1))
    t_dense = convert.transformer_params_from_numpy(_np_tree(j_dense), "cpu")
    t_moe_p = convert.transformer_params_from_numpy(_np_tree(moe_tree), "cpu")
    ref = t_tf.transformer_apply(t_dense, t_dense_cfg, _t(ids).long(), _t(mask))
    got, aux = t_tf.transformer_apply_with_aux(t_moe_p, t_moe_cfg, _t(ids).long(), _t(mask))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=1e-6)
    assert float(aux) == pytest.approx(1.0, rel=1e-6)
    want, want_aux = jax.jit(j_tf.transformer_apply_with_aux, static_argnums=1)(
        moe_tree, j_moe_cfg, jnp.asarray(ids), jnp.asarray(mask))
    assert _rel_max(got.numpy(), want) <= RTOL_FFN
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_moe_transformer_matches_reference(attention):
    j_cfg, t_cfg, j_params, t_params = _verdict_pair(attention)
    ids, mask, types, _ = _batch(np.random.default_rng(0))
    _assert_reference_routes_clear(j_cfg, j_params, ids, mask, types)
    with force_tpu_interpret_mode():
        want, want_aux = jax.jit(j_tf.transformer_apply_with_aux, static_argnums=1)(
            j_params["body"], j_cfg.encoder, *map(jnp.asarray, (ids, mask, types)))
    before = fa.flash_attention.launches
    got, aux = t_tf.transformer_apply_with_aux(
        t_params["body"], t_cfg.encoder, _t(ids).long(), _t(mask), _t(types).long())
    assert fa.flash_attention.launches == before  # CPU tensors: the plain version
    assert _rel_max(got.numpy(), want) <= RTOL_FFN
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=RTOL_FFN)
    assert 0.9 < float(aux) < 2.0  # near balanced on random weights


def _t_loss_fn(t_cfg):
    def loss_fn(params, ids, mask, types, labels):
        logits, aux = t_model.verdict_apply_with_aux(params, t_cfg, ids, mask, types)
        return F.cross_entropy(logits, labels) + t_cfg.moe_aux_weight * aux, logits

    return loss_fn


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_moe_loss_and_every_gradient_leaf_match_reference(attention):
    """The tolerances of ``tests/test_torch_verdict_train.py``: 1e-5
    absolute and 1e-4 of each leaf's largest element; the loss carries the
    aux at ``moe_aux_weight``, so the router's gradients are live."""
    j_cfg, t_cfg, j_params, t_params = _verdict_pair(attention)
    ids, mask, types, labels = _batch(np.random.default_rng(0))
    _assert_reference_routes_clear(j_cfg, j_params, ids, mask, types)

    def j_loss(params):
        logits, aux = j_model.verdict_apply_with_aux(
            params, j_cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types))
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels))
        return ce.mean() + j_cfg.moe_aux_weight * aux

    with force_tpu_interpret_mode():
        want_loss, want = jax.jit(jax.value_and_grad(j_loss))(j_params)
    loss, _, grads = t_model.value_and_grad(
        _t_loss_fn(t_cfg), t_params, _t(ids).long(), _t(mask), _t(types).long(),
        _t(labels).long())
    assert abs(float(loss) - float(want_loss)) <= ATOL
    want, got = dict(_named_leaves(want)), dict(_named_leaves(grads))
    assert want.keys() == got.keys() and len(want) == 5 + 17 * 2 + 4
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=ATOL,
                                   err_msg=name)
        size = np.abs(want[name]).max()
        if name.endswith("/k/b"):  # zero in exact arithmetic
            assert size < 1e-9 and np.abs(got[name]).max() < 1e-9, name
        else:
            assert size > 1e-7, name
            assert np.abs(got[name] - want[name]).max() <= 1e-4 * size, name


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_six_moe_steps_match_the_reference(attention):
    """Six steps across the freeze from the reference's parameters and
    optimizer state (``tests/test_ep.py``'s single-device training), each
    step's routes checked clear in the reference's own forward first."""
    j_cfg, t_cfg, j_params, t_params = _verdict_pair(attention)
    j_step, j_tx = j_model.make_verdict_train_step(j_cfg)
    t_step, _ = t_model.make_verdict_train_step(t_cfg, device="cpu")
    j_state = j_tx.init(j_params)
    t_state = convert.verdict_opt_state_from_numpy(
        int(j_state[0].count), _np_tree(j_state[0].mu), _np_tree(j_state[0].nu),
        device="cpu")
    rng = np.random.default_rng(0)
    for s in range(6):
        ids, mask, types, labels = _batch(rng)
        _assert_reference_routes_clear(j_cfg, j_params, ids, mask, types)
        with force_tpu_interpret_mode():
            j_params, j_state, j_loss, j_preds = j_step(
                j_params, j_state, jnp.asarray(s),
                *map(jnp.asarray, (ids, mask, types, labels)))
        _, _, loss, preds = t_step(t_params, t_state, s, ids, mask, types, labels)
        assert abs(float(loss) - float(j_loss)) <= ATOL, s
        np.testing.assert_array_equal(preds.numpy(), np.asarray(j_preds))
        _assert_params_close(j_params, t_params, max(0, s + 1 - WARMUP) + 1)
    assert t_state["count"] == int(j_state[0].count) == 6
    for a, b in zip(jax.tree.leaves(_np_tree(j_state[0].mu)), tree_leaves(t_state["mu"])):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=ATOL)


def test_moe_checkpoint_round_trip(tmp_path):
    """``tests/test_ep.py:199``: the MoE config crosses ``verdict_config.json``
    as the reference writes it, and the checkpoint serves."""
    _, t_cfg, _, t_params = _verdict_pair("xla")
    tok = WordPieceTokenizer({"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3,
                              "[MASK]": 4, "claim": 5, "text": 6})
    ckpt = str(tmp_path / "ckpt")
    t_infer.save_verdict_checkpoint(ckpt, t_cfg, t_params, tok)
    meta = json.load(open(os.path.join(ckpt, "verdict_config.json")))
    j_enc = j_tf.TransformerConfig(**dict(TF_KW, type_vocab=1),
                                   moe=j_moe.MoEConfig(**VERDICT_MOE))
    assert meta["encoder"] == dataclasses.asdict(j_enc) | {"dtype": None}
    cfg, params, _ = t_infer.load_verdict_checkpoint(ckpt, "cpu")
    assert cfg.encoder == t_cfg.encoder and cfg.encoder.moe == t_cfg.encoder.moe
    for a, b in zip(tree_leaves(params), tree_leaves(t_params)):
        assert torch.equal(a, b)
    clf = t_infer.VerdictClassifier(cfg, params, tok, batch_size=2)
    out = clf.classify(["claim"], ["text"])
    assert len(out) == 1 and 0.5 <= out[0]["confidence"] <= 1.0
