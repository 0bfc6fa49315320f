"""The port's tensor parallelism on an 8-rank gloo group against
``ircl_tpu.parallel.tp`` on the 8-device virtual mesh (``tests/conftest.py``).

Mirrors ``tests/test_tp.py``: its tiny verdict config (2 layers, hidden 16,
4 heads, L=16, B=8), its seeds and batches, and its five tests (TP(4) x DP(2)
training, the same with sequence parallelism, the local shard shapes of the
parameters and of Adam's moments, prediction, and the transformer alone as
a featurizer). The reference draws the parameters and
``utils/convert.py::verdict_params_from_numpy`` carries them across; the
reference runs its single-device step and its GSPMD mesh, the port its
explicit collectives in one launch of 8 CPU ranks (``parallel/launch.py``,
targets in ``tests/_torch_ranks.py``).

Tolerances are ``tests/test_tp.py``'s: losses rtol 2e-5 (atol 2e-6),
parameters rtol 5e-4 (atol 5e-6). Beyond the reference's tests, the cases
that a port of explicit collectives can get wrong: the first step's
gradients of every leaf, replicated ones included, against the port's
single-device gradients (rtol 1e-4, atol 1e-7: f32 sums in another order),
so that an all-reduce whose backward also reduces (a gradient scaled by the
TP degree) shows; parameters drawn away from zero, biases included, so that
a bias added on every rank before the sum shows; a bfloat16 TP(2) case held
by ``tests/test_torch_bf16.py``'s rule; and sequence parallelism refusing a
length that does not divide over ``model``. Every case also checks that
ranks holding the same coordinates hold the same shards, and that every
rank holds the same replicated leaves, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.models import transformer as j_tf
from ircl_tpu.parallel import tp as j_tp
from ircl_tpu.verdict import model as j_model
from ircl_tpu_torch.models.transformer import TransformerConfig
from ircl_tpu_torch.parallel.launch import launch
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.utils.tree import tree_map
from ircl_tpu_torch.verdict import model as t_model

RANKS = 8
TIMEOUT = 300.0  # a launch; the cases take seconds
ENC = dict(vocab_size=64, hidden=16, layers=2, heads=4, intermediate=32,
           max_positions=16)
TRAIN = dict(warmup_steps=0, total_steps=100, freeze_body_until_warmup=False,
             max_length=16)
LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
PARAM_TOL = dict(rtol=5e-4, atol=5e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)
QUARTER = 0.25  # tests/test_torch_bf16.py's bound


def configs(**enc):
    """The reference's and the port's ``VerdictConfig`` of ``ENC``."""
    from ircl_tpu.models.moe import MoEConfig as JMoE
    from ircl_tpu_torch.models.moe import MoEConfig as TMoE

    moe = enc.pop("moe", None)
    dtype = enc.pop("dtype", None)
    kw = dict(ENC, **enc)
    j_enc = j_tf.TransformerConfig(**kw, moe=moe and JMoE(**moe),
                                   **({"dtype": jnp.bfloat16} if dtype else {}))
    t_enc = TransformerConfig(**kw, moe=moe and TMoE(**moe),
                              **({"dtype": torch.bfloat16} if dtype else {}))
    return (j_model.VerdictConfig(encoder=j_enc, **TRAIN),
            t_model.VerdictConfig(encoder=t_enc, **TRAIN))


def batch(seed, B=8, L=16, mask=None):
    """``tests/test_tp.py``'s batch."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 64, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32) if mask is None else mask
    types = np.zeros((B, L), np.int32)
    labels = rng.integers(0, 2, size=(B,)).astype(np.int32)
    return ids, mask, types, labels


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def j_params(cfg, seed):
    return np_tree(j_model.init_verdict_params(jax.random.PRNGKey(seed), cfg))


@functools.lru_cache(maxsize=None)
def _j_single_step(cfg):
    """The reference's single-device step of ``cfg``, made (and compiled)
    once for the module's cases."""
    return j_model.make_verdict_train_step(cfg)


def j_train(cfg, params0, batches, mesh=None, specs=None, constrain=None,
            ep_constrain=None):
    """The reference's step over ``batches``: (losses, parameters), on one
    device or, with ``mesh`` and ``specs``, on its GSPMD mesh."""
    if mesh is None and constrain is None and ep_constrain is None:
        step, tx = _j_single_step(cfg)
    else:
        step, tx = j_model.make_verdict_train_step(cfg, constrain, ep_constrain)
    p = jax.tree.map(jnp.array, params0)
    if mesh is not None:
        p = j_tp.shard_tree(p, specs, mesh)
        o = j_tp.init_sharded_opt_state(tx, p, mesh, specs)
    else:
        o = tx.init(p)
    losses = []
    for i, b in enumerate(batches):
        b = j_tp.shard_batch(mesh, *b) if mesh is not None else tuple(map(jnp.asarray, b))
        p, o, loss, _ = step(p, o, jnp.asarray(i), *b)
        losses.append(float(loss))
    return losses, np_tree(p)


def t_single(cfg, params0, batches):
    """The port's single-device step: (first batch's gradients, losses,
    parameters), on the CPU."""
    p = convert.verdict_params_from_numpy(params0, "cpu")
    _, _, grads = t_model.make_verdict_grad_fn(cfg, device="cpu")(p, *batches[0])
    step, tx = t_model.make_verdict_train_step(cfg, device="cpu")
    o = tx.init(p)
    losses = []
    for i, b in enumerate(batches):
        p, o, loss, _ = step(p, o, i, *b)
        losses.append(float(loss))
    return _torch_ranks._np(grads), losses, _torch_ranks._np(p)


def named(tree, prefix=""):
    """``(path, array)`` of every leaf, dicts walked by sorted key, so that
    the reference's and the port's trees line up."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def assert_trees_close(got, want, **tol):
    g, w = dict(named(got)), dict(named(want))
    assert g.keys() == w.keys()
    for name in w:
        np.testing.assert_allclose(g[name], w[name], err_msg=name, **tol)


def assert_layout(report):
    """Ranks at the same coordinates hold equal shards; every rank holds the
    same replicated leaves, bit for bit."""
    assert len(report) == RANKS
    assert len({rep for _, _, rep in report}) == 1
    by_coords = {}
    for coords, local, _ in report:
        by_coords.setdefault(coords, set()).add(local)
    assert all(len(d) == 1 for d in by_coords.values()), by_coords


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _off_zero(params, seed):
    """Every leaf moved away from its init (zero biases, unit scales)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def runs():
    assert len(jax.devices()) == RANKS, "conftest must force 8 CPU devices"
    j_cfg, t_cfg = configs()
    jb_cfg, tb_cfg = configs(dtype="bf16")
    steps = lambda **kw: ("verdict_sharded_steps", dict(cfg=t_cfg, **kw))  # noqa: E731
    tp_dp = dict(data=2, model=4)
    cases, refs = {}, {}
    inputs = {
        "tp_dp": (j_params(j_cfg, 0), [batch(s) for s in range(3)], {}),
        "sp": (j_params(j_cfg, 4), [batch(s + 20) for s in range(3)], {"sp": True}),
        "biases": (_off_zero(j_params(j_cfg, 6), 1), [batch(s + 40) for s in range(2)], {}),
    }
    for name, (p0, batches, kw) in inputs.items():
        cases[name] = steps(params0=p0, batches=batches, shape=tp_dp, kind="tp",
                            grads=True, **kw)
        refs[name] = dict(single=j_train(j_cfg, p0, batches),
                          port=t_single(t_cfg, p0, batches))
    mesh = j_tp.make_tp_mesh(model=4, data=2)
    p0, batches, _ = inputs["tp_dp"]
    refs["tp_dp"]["mesh"] = j_train(j_cfg, p0, batches, mesh,
                                    j_tp.verdict_param_specs(p0))
    cases["shapes"] = ("verdict_local_shapes", dict(
        cfg=t_cfg, params0=j_params(j_cfg, 1), shape=tp_dp, kind="tp"))
    cases["predict"] = ("verdict_sharded_forward", dict(
        cfg=t_cfg, params0=j_params(j_cfg, 2), arrays=batch(9)[:3], shape=tp_dp,
        kind="tp", what="predict"))
    tf_params = np_tree(j_tf.init_transformer_params(jax.random.PRNGKey(5),
                                                     j_cfg.encoder))
    cases["featurizer"] = ("verdict_sharded_forward", dict(
        cfg=t_cfg.encoder, params0=tf_params, arrays=batch(3)[:2], shape=tp_dp,
        kind="tp", what="transformer_apply"))
    cases["heads"] = ("verdict_sharded_forward", dict(  # 4 heads over 8 ranks
        cfg=t_cfg, params0=j_params(j_cfg, 2), arrays=batch(9)[:3],
        shape=dict(data=1, model=8), kind="tp", what="predict"))
    short = [tuple(a[:, :14] if a.ndim == 2 else a for a in batch(30))]
    cases["sp_length"] = steps(params0=j_params(j_cfg, 0), batches=short, shape=tp_dp,
                               kind="tp", sp=True)
    # bfloat16 at TP(2): pads in two rows, so the pad bias rounds too
    bf_mask = np.ones((8, 16), np.float32)
    bf_mask[1, 11:] = bf_mask[6, 5:] = 0.0
    bf_p0, bf_in = _off_zero(j_params(j_cfg, 8), 2), batch(50, mask=bf_mask)[:3]
    cases["bf16"] = ("verdict_sharded_forward", dict(
        cfg=tb_cfg, params0=bf_p0, arrays=bf_in, shape=dict(data=4, model=2),
        kind="tp", what="apply"))
    refs["bf16"] = dict(inputs=(bf_p0, bf_in), cfgs=(jb_cfg, tb_cfg, t_cfg))
    got = launch(_torch_ranks.parallel_runs, RANKS, cases, device="cpu", timeout=TIMEOUT)
    return dict(refs=refs, got=got, cfgs=(j_cfg, t_cfg),
                predict_in=(j_params(j_cfg, 2), batch(9)[:3]),
                featurizer_in=(tf_params, batch(3)[:2]))


def test_tp_dp_matches_single_device(runs):
    """``tests/test_tp.py::test_tp_dp_matches_single_device``: TP(4) x DP(2),
    three steps, against the reference's single device and its GSPMD mesh
    and the port's single device."""
    got, ref = runs["got"]["tp_dp"], runs["refs"]["tp_dp"]
    for losses, params in (ref["single"], ref["mesh"], ref["port"][1:]):
        np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL)
        assert_trees_close(got["params"], params, **PARAM_TOL)
    assert_layout(got["layout"])


def test_tp_sp_matches_single_device(runs):
    """``tests/test_tp.py::test_tp_sp_matches_single_device``: Megatron-LM
    sequence parallelism over ``model`` reproduces the single-device run,
    its gradients included."""
    got, ref = runs["got"]["sp"], runs["refs"]["sp"]
    for losses, params in (ref["single"], ref["port"][1:]):
        np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL)
        assert_trees_close(got["params"], params, **PARAM_TOL)
    assert_trees_close(got["grads"], ref["port"][0], **GRAD_TOL)
    assert_layout(got["layout"])


def test_tp_params_actually_sharded(runs):
    """``tests/test_tp.py::test_tp_params_actually_sharded``: each rank
    holds its slices, and Adam's moments take their shapes."""
    got = runs["got"]["shapes"]
    layer = got["params"]["body"]["layers"][0]
    assert layer["ff1"]["w"] == (16, 8)  # 32 / model(4)
    assert layer["o"]["w"] == (4, 16)
    assert layer["q"]["b"] == (4,) and layer["o"]["b"] == (16,)
    assert got["mu"]["body"]["layers"][0]["ff1"]["w"] == (16, 8)
    assert got["params"]["body"]["tok_emb"] == (64, 16) and got["count"] == 0


def test_tp_predict_matches(runs):
    """``tests/test_tp.py::test_tp_predict_matches``: every rank returns the
    whole batch's labels from its rows."""
    j_cfg, _ = runs["cfgs"]
    params, (ids, mask, types) = runs["predict_in"]
    want = np.asarray(j_model.verdict_predict(params, j_cfg, ids, mask, types))
    np.testing.assert_array_equal(runs["got"]["predict"], want)


def test_tp_transformer_featurizer_inference_matches(runs):
    """``tests/test_tp.py::test_tp_transformer_featurizer_inference_matches``:
    the transformer alone, TP-sharded, returns the whole batch's last hidden
    state."""
    j_cfg, _ = runs["cfgs"]
    params, (ids, mask) = runs["featurizer_in"]
    want = np.asarray(jax.jit(lambda p, i, m: j_tf.transformer_apply(
        p, j_cfg.encoder, i, m))(params, ids, mask))
    np.testing.assert_allclose(runs["got"]["featurizer"], want, **LOSS_TOL)


@pytest.mark.parametrize("case", ["tp_dp", "biases"])
def test_tp_gradients_match_single_device(runs, case):
    """The first step's gradient of every leaf (embeddings, LayerNorms,
    ``o.b``, ``ff2.b``, the head, and the shards), gathered from the ranks,
    against the single-device gradient: f's and g's backward sum exactly
    once. ``biases``: every parameter drawn away from its init, so that a
    bias added on every rank before the sum would show."""
    got, ref = runs["got"][case], runs["refs"][case]
    assert_trees_close(got["grads"], ref["port"][0], **GRAD_TOL)
    np.testing.assert_allclose(got["grad_loss"], ref["port"][1][0], **LOSS_TOL)
    for losses, params in (ref["single"], ref["port"][1:]):
        np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL)
        assert_trees_close(got["params"], params, **PARAM_TOL)
    assert_layout(got["layout"])


def test_tp_bf16_matches_single_device_within_a_quarter(runs):
    """bfloat16 at TP(2) (x DP(4), which leaves each row's forward alone):
    the o-projection rounds to bf16 before its sum over ``model``, where the
    reference's explicit path rounds. The logits are within a quarter of
    the single-device bf16-against-f32 distance of the single-device bf16
    model, the port's and the reference's (``tests/test_torch_bf16.py``'s
    rule), and bf16 moves them. The gradients are not held so: rounding
    two partial sums where the single device rounds their sum is another
    function at bf16's resolution (it moves some gradient leaves by a third
    of their bf16-against-f32 distance at this size)."""
    from test_torch_bf16 import _ref

    got = runs["got"]["bf16"]
    (p0, (ids, mask, types)), (jb_cfg, tb_cfg, t_cfg) = (
        runs["refs"]["bf16"]["inputs"], runs["refs"]["bf16"]["cfgs"])
    params = convert.verdict_params_from_numpy(p0, "cpu")
    t_in = (torch.as_tensor(ids).long(), torch.as_tensor(mask), torch.as_tensor(types).long())
    t16 = t_model.verdict_apply(params, tb_cfg, *t_in).numpy()
    t32 = t_model.verdict_apply(params, t_cfg, *t_in).numpy()
    j16 = np.asarray(_ref(lambda p, i, m, t: j_model.verdict_apply(p, jb_cfg, i, m, t),
                          p0, *map(jnp.asarray, (ids, mask, types))))
    gap = rel_l2(t16, t32)
    assert gap > 1e-4, gap
    assert rel_l2(got["logits"], t16) <= QUARTER * gap
    assert rel_l2(got["logits"], j16) <= QUARTER * gap


def test_sp_refuses_a_length_that_does_not_divide(runs):
    kind, name, msg = runs["got"]["sp_length"]
    assert (kind, name) == ("raised", "ValueError")
    assert "length 14" in msg and "4 ranks" in msg


def test_tp_refuses_heads_that_do_not_divide(runs):
    """The model axis must divide the head count, as the reference's layout
    asks (each rank holds whole heads): 4 heads over 8 ranks of ``model``
    are refused, though the widths (16 over 8) divide."""
    kind, name, msg = runs["got"]["heads"]
    assert (kind, name) == ("raised", "ValueError")
    assert "4 heads do not divide over the 8 ranks" in msg


def test_tp_refusals():
    """What is not a mesh, and an explicit axis without its mesh, are
    refused before any collective."""
    from ircl_tpu_torch.models import transformer as t_tf

    _, t_cfg = configs()
    with pytest.raises(TypeError, match="DeviceMesh"):
        t_model.make_verdict_train_step(t_cfg, mesh=object())[0](
            None, None, 0, *batch(0))
    params = t_tf.init_transformer_params(torch.Generator().manual_seed(0),
                                          t_cfg.encoder, "cpu")
    x = torch.zeros(1, 4, 16)
    ctx = t_tf.attention_mask_inputs(t_cfg.encoder, torch.ones(1, 4))
    with pytest.raises(ValueError, match="need mesh="):
        t_tf.transformer_block(x, params["layers"][0], t_cfg.encoder, ctx,
                               model_axis="model")
    half = tree_map(lambda t: t, params)
    half["layers"][0]["q"]["w"] = params["layers"][0]["q"]["w"][:, :8]
    with pytest.raises(ValueError, match="not a shard"):
        t_tf.transformer_apply_with_aux(half, t_cfg.encoder, torch.zeros(1, 4).long(),
                                        torch.ones(1, 4))
