"""The port's bfloat16 transformer and verdict model against the reference's.

``TransformerConfig(dtype=bfloat16)`` in the JAX package rounds to bf16 at
six places only: the embedding sum; the embedding LayerNorm's normalize step
(its f32 scale makes every LayerNorm return f32, so q, k, v, the FFN and the
head all run in f32); the pad bias; the softmax's probabilities; the
attention context; and the o-projection. The same numpy weights and inputs go
through both packages, on the "xla" path and on the "flash" path (the
library kernel in the TPU interpret mode), at the verdict model's cut shape
(2 layers, hidden 64, 2 heads, L=128).

The reference runs under ``jax.jit`` compiled with
``xla_allow_excess_precision`` off. With it on (XLA's default), the CPU
compiler may drop a bf16 rounding that the program states when the value
stays inside a fusion, which moves the reference's bf16 result by about 0.6
of its whole bf16-against-f32 difference; with it off, the jitted reference
agrees with its op-by-op execution, which rounds at every stated place, up
to fp32 sums taken in another order (``test_reference_keeps_every_
rounding``), and that is the function the port reproduces.

Bound. No reference test covers bf16, so this file states its own: the
port's relative L2 distance from the reference's bf16 result is at most a
quarter of the reference's own bf16-against-f32 distance (``QUARTER``), for
the transformer's output, the verdict logits, the loss and every gradient
leaf. A port that rounded at other places, or missed one, lands at the
order of the bf16-against-f32 distance itself; one that rounds where the
reference does differs only where fp32 sums in another order tip a bf16
rounding, orders of magnitude below it. Each test also asserts that bf16
changes the reference's result, so that the bound is not vacuous.

One addition for gradients. The transpose of the embedding LayerNorm's
bf16 normalize step sums bf16 rows (of ``x - mu`` times the cotangent, and
of the cotangent itself), and XLA's CPU backend accumulates those sums in
bf16, in an order of its own vectorization; the port accumulates them in
f32, rounding once. That sum order moves the reference's embedding
gradients by about 0.6 of their bf16-against-f32 distance: the reference
meets itself no closer when only the order of its sums changes. So each
gradient leaf's bound adds the reference's own distance from itself with
the hidden units permuted (every weight's hidden axis permuted alike, the
gradients permuted back; the larger of two permutations): the same
function, its sums taken in another order. Wherever the reference sums in
f32 that distance is under a tenth of the quarter (asserted), which leaves the
quarter as the bound there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas.tpu import force_tpu_interpret_mode

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.models import transformer as j_tf
from ircl_tpu.verdict import model as j_model
from ircl_tpu_torch.models import transformer as t_tf
from ircl_tpu_torch.ops import flash_attention_cuda as fa
from ircl_tpu_torch.utils.tree import tree_leaves
from ircl_tpu_torch.verdict import model as t_model
from test_torch_verdict_train import (
    TF_KW,
    TRAIN_KW,
    _batch,
    _named_leaves,
    _np_tree,
    _pair,
)

QUARTER = 0.25
NO_EXCESS = {"xla_allow_excess_precision": False}


def _ref(fn, *args):
    """``fn(*args)`` under ``jax.jit`` with every stated rounding kept."""
    with force_tpu_interpret_mode():
        return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)(*args)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_bf16_parity(got, want16, want32, what, spread=0.0):
    """The bound of the module docstring, with bf16 visibly at work;
    ``spread`` is the reference's distance from itself under another sum
    order (gradients only)."""
    shift = _rel(want16, want32)
    assert shift > 1e-6, f"{what}: bf16 does not change the reference ({shift})"
    assert _rel(got, want16) <= QUARTER * shift + spread, (
        what, _rel(got, want16), shift, spread)


def _permute_hidden(params, perm):
    """The verdict tree with every weight's hidden axis permuted by
    ``perm``: the same function of the inputs, its sums over the hidden
    units taken in another order. With the inverse permutation it maps the
    gradients back."""
    p = jax.tree.map(np.asarray, params)
    body = p["body"]
    for name in ("tok_emb", "pos_emb", "type_emb"):
        body[name] = body[name][:, perm]
    for ln in [body["emb_ln"]] + [lp[n] for lp in body["layers"]
                                  for n in ("attn_ln", "ff_ln")]:
        ln["scale"], ln["bias"] = ln["scale"][perm], ln["bias"][perm]
    for lp in body["layers"]:
        for name in ("q", "k", "v", "ff1"):
            lp[name]["w"] = lp[name]["w"][perm, :]
        for name in ("o", "ff2"):
            lp[name]["w"], lp[name]["b"] = lp[name]["w"][:, perm], lp[name]["b"][perm]
    p["head_dense"]["w"] = p["head_dense"]["w"][perm, :]
    return p


def _bf16_pair(attention):
    """Reference and port verdict configs in bf16 and in f32, on the
    reference's weights."""
    j_cfg, t_cfg, j_params, t_params = _pair(attention)
    bf = lambda c, dt: dataclasses.replace(  # noqa: E731
        c, encoder=dataclasses.replace(c.encoder, dtype=dt))
    return (bf(j_cfg, jnp.bfloat16), bf(t_cfg, torch.bfloat16), j_cfg, j_params,
            t_params)


def _inputs():
    return _batch(np.random.default_rng(0))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_reference_keeps_every_rounding():
    """With excess precision off, the jitted reference meets its op-by-op
    execution a hundred times inside the bound (fp32 sums in another order);
    with XLA's default it misses the bound itself (the reason this file
    compiles it so)."""
    j16, _, j32, j_params, _ = _bf16_pair("xla")
    ids, mask, _, _ = _inputs()
    args = (j_params, jnp.asarray(ids), jnp.asarray(mask))

    def fn(cfg):
        return lambda p, i, m: j_tf.transformer_apply(p["body"], cfg.encoder, i, m)

    eager = np.asarray(fn(j16)(*args))
    shift = _rel(eager, np.asarray(jax.jit(fn(j32))(*args)))
    assert _rel(np.asarray(_ref(fn(j16), *args)), eager) <= QUARTER * shift / 100
    assert _rel(np.asarray(jax.jit(fn(j16))(*args)), eager) > QUARTER * shift


@pytest.mark.parametrize("hidden", [8, 64, 768])
def test_layernorm_rounds_as_the_reference(hidden):
    """A bf16 input's LayerNorm, bit for bit the reference's op-by-op
    result: mean and variance rounded to bf16, the normalize step in bf16,
    the f32 scale and bias after."""
    rng = np.random.default_rng(hidden)
    x = (3.0 * rng.normal(size=(4, 7, hidden)) + 1.0).astype(np.float32)
    p = {n: rng.normal(size=hidden).astype(np.float32) for n in ("scale", "bias")}
    want = np.asarray(j_tf._ln(jnp.asarray(x).astype(jnp.bfloat16),
                               jax.tree.map(jnp.asarray, p), 1e-5))
    got = t_tf._ln(_t(x).to(torch.bfloat16), {n: _t(v) for n, v in p.items()}, 1e-5)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_transformer_matches_reference(attention):
    j16, t16, j32, j_params, t_params = _bf16_pair(attention)
    ids, mask, types, _ = _inputs()

    def run(cfg):
        return np.asarray(_ref(
            lambda p, i, m, t: j_tf.transformer_apply(p["body"], cfg.encoder, i, m, t),
            j_params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types)))

    want16, want32 = run(j16), run(j32)
    before = fa.flash_attention.launches
    got = t_tf.transformer_apply(t_params["body"], t16.encoder, _t(ids).long(),
                                 _t(mask), _t(types).long())
    assert fa.flash_attention.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and want16.dtype == np.float32
    _assert_bf16_parity(got.numpy(), want16, want32, "hidden state")


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_verdict_logits_match_reference(attention):
    j16, t16, j32, j_params, t_params = _bf16_pair(attention)
    ids, mask, types, _ = _inputs()

    def run(cfg):
        return np.asarray(_ref(
            lambda p, i, m, t: j_model.verdict_apply(p, cfg, i, m, t),
            j_params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types)))

    got = t_model.verdict_apply(t_params, t16, _t(ids).long(), _t(mask),
                                _t(types).long())
    _assert_bf16_parity(got.numpy(), run(j16), run(j32), "logits")


def _check_flash_inputs(monkeypatch):
    """Record the dtypes that reach the flash wrapper."""
    seen = []
    real = fa.flash_attention

    def spy(q, k, v, *args, **kwargs):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, *args, **kwargs)

    monkeypatch.setattr(t_tf, "flash_attention", spy)
    return seen


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_loss_and_every_gradient_leaf_match_reference(attention, monkeypatch):
    """The flash path hands the attention f32 q, k and v in a bf16 model,
    as the reference does."""
    j16, t16, j32, j_params, t_params = _bf16_pair(attention)
    ids, mask, types, labels = _inputs()
    seen = _check_flash_inputs(monkeypatch)

    def run(cfg, perm=None):
        def loss(params, i, m, t, y):
            logits, _ = j_model.verdict_apply_with_aux(params, cfg, i, m, t)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

        params = j_params if perm is None else _permute_hidden(j_params, perm)
        value, grads = _ref(jax.value_and_grad(loss), params,
                            *map(jnp.asarray, (ids, mask, types, labels)))
        if perm is not None:
            grads = _permute_hidden(grads, np.argsort(perm))
        return float(value), dict(_named_leaves(_np_tree(grads)))

    (l16, g16), (l32, g32) = run(j16), run(j32)
    perms = [run(j16, np.random.default_rng(seed).permutation(TF_KW["hidden"]))[1]
             for seed in (1, 2)]

    def loss_fn(params, i, m, t, y):
        logits, _ = t_model.verdict_apply_with_aux(params, t16, i, m, t)
        return F.cross_entropy(logits, y), logits

    loss, _, grads = t_model.value_and_grad(
        loss_fn, t_params, _t(ids).long(), _t(mask), _t(types).long(),
        _t(labels).long())
    if attention == "flash":
        assert seen == [(torch.float32,) * 3] * TF_KW["layers"]
    else:
        assert not seen
    _assert_bf16_parity([float(loss)], [l16], [l32], "loss")
    got = dict(_named_leaves(grads))
    assert got.keys() == g16.keys() and len(got) == 5 + 16 * 2 + 4
    for name in got:
        if name.endswith("/k/b"):
            # zero in exact arithmetic (softmax is shift-invariant): both
            # packages hold rounding noise there, in either dtype
            assert np.abs(got[name]).max() < 1e-8 and np.abs(g16[name]).max() < 1e-8
            continue
        spread = max(_rel(g[name], g16[name]) for g in perms)
        if name not in ("/body/tok_emb", "/body/pos_emb", "/body/type_emb"):
            # only the embedding gradients pass through the bf16 row sums;
            # elsewhere the reference's sum order moves it by f32 noise
            assert spread < 0.1 * QUARTER * _rel(g16[name], g32[name]), name
        _assert_bf16_parity(got[name], g16[name], g32[name], name, spread)


def test_bf16_train_steps_run_across_the_freeze():
    """Four steps of the bf16 model from the reference's weights: the losses
    meet the reference's bf16 losses under the bound, and the frozen body
    keeps its bits."""
    j16, t16, j32, j_params, t_params = _bf16_pair("xla")
    steps = {}
    for name, cfg in (("16", j16), ("32", j32)):
        step, tx = j_model.make_verdict_train_step(cfg)
        p = jax.tree.map(jnp.array, j_params)
        state = tx.init(p)
        rng, losses, compiled = np.random.default_rng(0), [], None
        for s in range(4):
            args = (p, state, jnp.asarray(s), *map(jnp.asarray, _batch(rng)))
            compiled = compiled or step.lower(*args).compile(compiler_options=NO_EXCESS)
            p, state, loss, _ = compiled(*args)
            losses.append(float(loss))
        steps[name] = losses
    t_step, t_tx = t_model.make_verdict_train_step(t16, device="cpu")
    state = t_tx.init(t_params)
    start = [t.clone() for t in tree_leaves(t_params["body"])]
    rng, losses = np.random.default_rng(0), []
    for s in range(4):
        _, _, loss, _ = t_step(t_params, state, s, *_batch(rng))
        losses.append(float(loss))
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(t_params["body"]), start))
        assert same == (s < TRAIN_KW["warmup_steps"]), s
    assert np.isfinite(losses).all()
    _assert_bf16_parity(losses, steps["16"], steps["32"], "losses")
