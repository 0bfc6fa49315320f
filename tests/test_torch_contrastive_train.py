"""The port's contrastive train step and optimizer against
``ircl_tpu.contrastive`` from one state (``tests/test_train.py``,
``tests/test_proto_edges.py`` and the optimizer case of
``tests/test_io_and_optim.py``).

The JAX package draws the state; ``utils/convert.py`` carries it across
(both encoders, the queue, its pointer, the step, the optimizer's count and
moments or trace), the featurizer's table likewise, and both packages take
the same seeded batches. Small widths: BiLSTM 2 x 16 over 32-d features ->
8, ``max_len`` 8, micro-batch 8 x 2, queue 32.

Tolerances. Loss sums: rtol 1e-5. Gradient norms: rtol 1e-4 (a gradient
back through two recurrent layers carries about 1e-5 of relative rounding
noise in fp32; 9.6e-6 seen in the six Adam steps). The queue: 1e-5 after
one step, 1e-4 after several; the pointer and the step exactly equal.
Parameters after N Adam steps, ``params_k`` too (the EMA carries the query
encoder's Adam steps into it): ``tests/test_torch_verdict_train.py``'s rule,
no element further apart than 2 * N learning rates and at most one element
in a thousand of a leaf more than 1e-5 (Adam turns rounding noise in a
gradient into a step of the learning rate). SGD parameters: 1e-5. Adam's
moments after one step: ``mu`` 1e-6 and ``nu`` 1e-8 absolute (a tenth of a
clipped gradient, and a thousandth of its square).

bfloat16 (``compute_dtype="bfloat16"``): the port rounds the same operands
to bf16 and multiplies them in f32 as XLA's ``preferred_element_type=f32``
does, so the two differ only where an f32 difference of a few ulps moves a
value across a bf16 rounding boundary, which changes it by 2^-8 relative.
Over the few hundred roundings each loss row depends on, that bounds the
loss sum at 5e-3 relative; the queue stays f32.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.contrastive import state as j_state
from ircl_tpu.contrastive import train as j_train
from ircl_tpu.models import encoder as j_enc
from ircl_tpu.models import featurizer as j_feat
from ircl_tpu_torch.contrastive import state as t_state
from ircl_tpu_torch.contrastive import train as t_train
from ircl_tpu_torch.models import encoder as t_enc
from ircl_tpu_torch.models import featurizer as t_feat
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.utils.tree import tree_leaves

LR = 1e-3
ENC = dict(input_size=32, hidden_size=16, output_size=8, num_layers=2)
CFG = dict(temperature=0.05, queue_size=32, queue_start_steps=2, micro_batch=8,
           accum_steps=2, learning_rate=LR)
FEAT = dict(dim=32, max_len=8, vocab_buckets=1 << 12)


def _configs(**kw):
    kw = dict(CFG, **kw)
    return (j_state.TrainConfig(encoder=j_enc.EncoderConfig(**ENC), **kw),
            t_state.TrainConfig(encoder=t_enc.EncoderConfig(**ENC), **kw))


@pytest.fixture(scope="module")
def feats():
    j_f = j_feat.HashEmbedFeaturizer(j_feat.FeaturizerConfig(**FEAT))
    t_f = t_feat.HashEmbedFeaturizer(
        t_feat.FeaturizerConfig(**FEAT), device="cpu",
        params=convert.hash_featurizer_params_from_numpy(
            jax.tree.map(np.asarray, j_f.params), device="cpu"))
    return j_f, t_f


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def carry(j_st, optimizer="adam"):
    """The JAX package's TrainState as the port's, on the CPU."""
    opt = j_st.opt_state[1]
    if optimizer == "adam":
        kw = dict(count=int(opt[0].count), mu=_np(opt[0].mu), nu=_np(opt[0].nu))
    else:
        kw = dict(count=int(opt[1][1].count), trace=_np(opt[1][0].trace))
    return convert.train_state_from_numpy(
        _np(j_st.params_q), _np(j_st.params_k), np.asarray(j_st.queue),
        int(j_st.queue_ptr), int(j_st.step), device="cpu", **kw)


def _batch(j_f, rng, cfg):
    """Anchor/positive pairs that share a distinctive token
    (``tests/test_train.py``'s batches)."""
    texts_a, texts_k = [], []
    for _ in range(cfg.accum_steps * cfg.micro_batch):
        ent = f"tok{rng.integers(50)}"
        texts_a.append(f"{ent} alpha beta gamma")
        texts_k.append(f"delta {ent} epsilon")
    shape = (cfg.accum_steps, cfg.micro_batch, FEAT["max_len"])
    (ids_a, mask_a), (ids_k, mask_k) = j_f.encode_host(texts_a), j_f.encode_host(texts_k)
    return (ids_a.reshape(shape), mask_a.reshape(shape), ids_k.reshape(shape),
            mask_k.reshape(shape))


def _proto(rng, cfg, ks=(5, 7), r=3):
    """Seeded ProtoNCE inputs: per granularity [accum, micro] cluster ids,
    unit centroids, densities around the temperature, sampled negatives."""
    shape = (cfg.accum_steps, cfg.micro_batch)
    ids = [rng.integers(0, k, size=shape).astype(np.int32) for k in ks]
    cents = []
    for k in ks:
        c = rng.normal(size=(k, ENC["output_size"]))
        cents.append((c / np.linalg.norm(c, axis=1, keepdims=True)).astype(np.float32))
    dens = [rng.uniform(0.03, 0.08, size=k).astype(np.float32) for k in ks]
    negs = [rng.choice(k, r, replace=False).astype(np.int32) for k in ks]
    return ids, cents, dens, negs


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _assert_adam_close(j_tree, t_tree, n_steps):
    want, got = dict(_named(_np(j_tree))), dict(_named(t_tree))
    assert want.keys() == got.keys()
    for name in want:
        diff = np.abs(got[name] - want[name])
        assert diff.max() <= 2 * n_steps * LR, name
        assert (diff > 1e-5).mean() <= 1e-3, name


def _assert_close(j_tree, t_tree, atol):
    want, got = dict(_named(_np(j_tree))), dict(_named(t_tree))
    assert want.keys() == got.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol, err_msg=name)


def _run(j_cfg, t_cfg, feats, seed, n_steps, pre_steps=0, with_proto=False):
    """``pre_steps`` of the JAX package, the state carried across, then
    ``n_steps`` of both on the same batches; returns both states and the
    losses and gradient norms of each step."""
    j_f, t_f = feats
    j_step = j_train.make_train_step(j_cfg, j_f)
    t_step = t_train.make_train_step(t_cfg, t_f)
    rng = np.random.default_rng(seed)
    j_st = j_state.init_train_state(jax.random.PRNGKey(seed), j_cfg)
    for _ in range(pre_steps):
        j_st, _, _ = j_step(j_st, *map(jnp.asarray, _batch(j_f, rng, j_cfg)))
    t_st = carry(j_st, j_cfg.optimizer)
    hist = []
    for _ in range(n_steps):
        batch = _batch(j_f, rng, j_cfg)
        proto = _proto(rng, j_cfg) if with_proto else None
        j_proto = jax.tree.map(jnp.asarray, proto) if with_proto else None
        t_proto = ([[torch.tensor(a) for a in x] for x in proto] if with_proto else None)
        j_st, j_loss, j_norm = j_step(j_st, *map(jnp.asarray, batch), j_proto)
        before = tree_leaves(t_st.params_q)[0].clone()
        new, t_loss, t_norm = t_step(t_st, *batch, t_proto)
        assert torch.equal(tree_leaves(t_st.params_q)[0], before)  # not in place
        t_st = new
        hist.append((float(j_loss), float(t_loss), float(j_norm), float(t_norm)))
    return j_st, t_st, hist


def _assert_history(hist):
    for j_loss, t_loss, j_norm, t_norm in hist:
        np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
        np.testing.assert_allclose(t_norm, j_norm, rtol=1e-4)


def test_one_step_matches_jax(feats):
    j_cfg, t_cfg = _configs()
    j_st, t_st, hist = _run(j_cfg, t_cfg, feats, seed=0, n_steps=1)
    _assert_history(hist)
    assert t_st.step == int(j_st.step) == 1
    assert t_st.queue_ptr == int(j_st.queue_ptr) == 16
    np.testing.assert_allclose(t_st.queue.numpy(), np.asarray(j_st.queue), rtol=0,
                               atol=1e-5)
    _assert_adam_close(j_st.params_q, t_st.params_q, 1)
    _assert_adam_close(j_st.params_k, t_st.params_k, 1)
    adam = j_st.opt_state[1][0]
    assert t_st.opt_state["count"] == int(adam.count) == 1
    _assert_close(adam.mu, t_st.opt_state["mu"], 1e-6)
    _assert_close(adam.nu, t_st.opt_state["nu"], 1e-8)
    # the first 16 queue columns are the two micro-batches' keys, unit norm
    np.testing.assert_allclose(torch.linalg.vector_norm(t_st.queue, dim=0)[:16].numpy(),
                               1.0, rtol=1e-5)


@pytest.mark.parametrize("variant", ["adam", "sgd", "no momentum", "proto"])
def test_six_steps_from_a_carried_state_match_jax(feats, variant):
    """One JAX step, the state carried across (non-zero moments, the pointer
    mid-queue), then six steps of both, across ``queue_start_steps``."""
    kw = {"adam": {}, "proto": {}, "sgd": dict(optimizer="sgd", total_steps=10),
          "no momentum": dict(use_momentum=False)}[variant]
    j_cfg, t_cfg = _configs(**kw)
    j_st, t_st, hist = _run(j_cfg, t_cfg, feats, seed=1, n_steps=6, pre_steps=1,
                            with_proto=variant == "proto")
    _assert_history(hist)
    assert t_st.step == int(j_st.step) == 7
    assert t_st.queue_ptr == int(j_st.queue_ptr) == (7 * 16) % 32
    np.testing.assert_allclose(t_st.queue.numpy(), np.asarray(j_st.queue), rtol=0,
                               atol=1e-4)
    if variant == "sgd":
        _assert_close(j_st.params_q, t_st.params_q, 1e-5)
        _assert_close(j_st.params_k, t_st.params_k, 1e-5)
        trace = j_st.opt_state[1][1][0].trace
        assert t_st.opt_state["count"] == int(j_st.opt_state[1][1][1].count) == 7
        _assert_close(trace, t_st.opt_state["trace"], 1e-5)
    else:
        _assert_adam_close(j_st.params_q, t_st.params_q, 6)
        _assert_adam_close(j_st.params_k, t_st.params_k, 6)
        assert t_st.opt_state["count"] == int(j_st.opt_state[1][0].count) == 7
    if variant == "no momentum":  # the key encoder stays where it started
        for a, b in zip(_named(j_st.params_k), _named(t_st.params_k)):
            np.testing.assert_array_equal(a[1], b[1])


def test_queue_activation_raises_loss(feats):
    """``tests/test_train.py``'s case on the port: equal losses before
    ``queue_start_steps``, higher ones once the queue's negatives join."""
    _, t_f = feats
    batch = _batch(feats[0], np.random.default_rng(4), _configs()[1])
    losses = {}
    for name, start in (("on", 2), ("off", 10_000)):
        _, cfg = _configs(queue_start_steps=start)
        st = t_state.init_train_state(4, cfg, device="cpu")
        step = t_train.make_train_step(cfg, t_f)
        losses[name] = []
        for _ in range(4):
            st, loss, _ = step(st, *batch)
            losses[name].append(float(loss))
    np.testing.assert_array_equal(losses["on"][:2], losses["off"][:2])
    assert losses["on"][2] > losses["off"][2] and losses["on"][3] > losses["off"][3]


def test_training_moves_both_encoders_and_lowers_the_loss(feats):
    """``tests/test_train.py``'s descent check on the port's own init."""
    _, t_f = feats
    _, cfg = _configs(queue_start_steps=10_000)
    st = t_state.init_train_state(0, cfg, device="cpu")
    step = t_train.make_train_step(cfg, t_f)
    batch = _batch(feats[0], np.random.default_rng(0), cfg)
    p0, k0 = (tree_leaves(t)[0].clone() for t in (st.params_q, st.params_k))
    losses = []
    for _ in range(20):
        st, loss, norm = step(st, *batch)
        losses.append(float(loss))
        assert np.isfinite(losses[-1]) and torch.isfinite(norm)
    p1, k1 = tree_leaves(st.params_q)[0], tree_leaves(st.params_k)[0]
    assert not torch.allclose(p0, p1) and not torch.allclose(k0, k1)
    assert not torch.allclose(p1, k1)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_momentum_ema_formula(feats):
    _, t_f = feats
    _, cfg = _configs()
    st = t_state.init_train_state(2, cfg, device="cpu")
    st2, _, _ = t_train.make_train_step(cfg, t_f)(
        st, *_batch(feats[0], np.random.default_rng(2), cfg))
    for pk0, pq1, pk1 in zip(*(tree_leaves(t) for t in (st.params_k, st2.params_q,
                                                        st2.params_k))):
        torch.testing.assert_close(pk1, 0.9 * pk0 + 0.1 * pq1, rtol=1e-5, atol=1e-6)


def test_queue_divisibility_fails_fast(feats):
    _, cfg = _configs(queue_size=20)
    with pytest.raises(ValueError, match="queue_size"):
        t_train.make_train_step(cfg, feats[1])
    with pytest.raises(ValueError, match="compute_dtype"):
        t_train.make_train_step(_configs(compute_dtype="float16")[1], feats[1])


def test_bfloat16_step_matches_jax(feats):
    """``tests/test_proto_edges.py``'s bf16 case, held to the JAX package's
    bf16 step from one state (the bound is the module docstring's)."""
    j_cfg, t_cfg = _configs(queue_start_steps=1, compute_dtype="bfloat16")
    j_f, t_f = feats
    j_st = j_state.init_train_state(jax.random.PRNGKey(0), j_cfg)
    t_st = carry(j_st)
    rng = np.random.default_rng(0)
    shape = (j_cfg.accum_steps, j_cfg.micro_batch, FEAT["max_len"])
    ids = rng.integers(0, FEAT["vocab_buckets"], size=shape).astype(np.int32)
    mask = np.ones(shape, np.float32)
    j_step = j_train.make_train_step(j_cfg, j_f)
    t_step = t_train.make_train_step(t_cfg, t_f)
    for _ in range(2):
        j_st, j_loss, _ = j_step(j_st, *map(jnp.asarray, (ids, mask, ids, mask)))
        t_st, t_loss, t_norm = t_step(t_st, ids, mask, ids, mask)
        assert np.isfinite(float(t_loss)) and np.isfinite(float(t_norm))
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=5e-3)
    assert t_st.queue.dtype == torch.float32 and j_st.queue.dtype == jnp.float32
    assert torch.isfinite(t_st.queue).all()


@pytest.mark.parametrize("optimizer, count, norm", [
    ("adam", 0, 0.5), ("adam", 5, 4.0), ("sgd", 0, 0.5), ("sgd", 1, 4.0),
    ("sgd", 50, 4.0), ("sgd", 99, 0.5), ("sgd", 100, 4.0), ("sgd", 150, 4.0),
])
def test_update_matches_optax_at_a_count(optimizer, count, norm):
    """One update from a state whose count is set, with the gradients'
    global norm below and above the clip: schedule, clip, weight decay,
    momentum and bias correction together."""
    j_cfg, t_cfg = _configs(optimizer=optimizer, learning_rate=3e-4, total_steps=100)
    rng = np.random.default_rng(count)
    p = {"w": rng.normal(size=(4, 4)).astype(np.float32),
         "b": rng.normal(size=(4,)).astype(np.float32)}
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    scale = norm / np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))
    g = {k: (v * scale).astype(np.float32) for k, v in g.items()}
    moment = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    tx = j_state.make_optimizer(j_cfg)
    st = tx.init(jax.tree.map(jnp.asarray, p))
    c = jnp.asarray(count, jnp.int32)
    if optimizer == "adam":
        st = (st[0], (st[1][0]._replace(count=c, mu=jax.tree.map(jnp.asarray, moment),
                                        nu=jax.tree.map(lambda m: jnp.asarray(m * m),
                                                        moment)), st[1][1]))
        t_st = {"count": count, "mu": {k: torch.tensor(v) for k, v in moment.items()},
                "nu": {k: torch.tensor(v * v) for k, v in moment.items()}}
    else:
        st = (st[0], (st[1][0], (st[1][1][0]._replace(
            trace=jax.tree.map(jnp.asarray, moment)), st[1][1][1]._replace(count=c))))
        t_st = {"count": count, "trace": {k: torch.tensor(v) for k, v in moment.items()}}
    updates, _ = tx.update(jax.tree.map(jnp.asarray, g), st, jax.tree.map(jnp.asarray, p))
    want = jax.tree.map(np.asarray, jax.tree.map(jnp.add, jax.tree.map(jnp.asarray, p),
                                                 updates))
    t_tx = t_state.make_optimizer(t_cfg)
    t_p = {k: torch.tensor(v) for k, v in p.items()}
    got, new_st = t_tx.update(t_p, {k: torch.tensor(v) for k, v in g.items()}, t_st)
    assert new_st["count"] == count + 1
    for k in p:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(t_p[k].numpy(), p[k])  # not in place
    if optimizer == "sgd":
        lr = t_tx.learning_rate(count)
        assert lr == pytest.approx(3e-4 * 0.5 * (1 + np.cos(np.pi * min(count, 100) / 100)))
        assert (lr == 0.0) == (count >= 100)


def test_sgd_cosine_optimizer_decays():
    """``tests/test_io_and_optim.py``'s case on the port."""
    _, cfg = _configs(optimizer="sgd", learning_rate=3e-4, total_steps=100)
    tx = t_state.make_optimizer(cfg)
    params = {"w": torch.ones(4, 4)}
    st = tx.init(params)
    grads = {"w": torch.ones(4, 4) * 0.1}
    first, st = tx.update(params, grads, st)
    mag1 = float((first["w"] - params["w"]).abs().max())
    for _ in range(99):
        new, st = tx.update(params, grads, st)
    assert mag1 > 0 and float((new["w"] - params["w"]).abs().max()) < mag1 * 0.2
