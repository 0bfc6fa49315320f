"""The port's data-parallel contrastive training on an 8-rank gloo group
against ``ircl_tpu.parallel.dp`` on the 8-device virtual mesh
(``tests/conftest.py``), and against the single-device step.

Mirrors ``tests/test_dp.py``: its tiny config (BiLSTM 1 x 8 over 16-d
features -> 8, micro-batch 16, two micro-batches, queue 32), its batches
and its ProtoNCE inputs. The JAX package draws the state, and
``utils/convert.py`` carries it and the featurizer's table across. One
launch of 8 CPU ranks (``parallel/launch.py``, targets in
``tests/_torch_ranks.py``) runs every case; each rank must return rank 0's
bits, so the parameters, optimizer state, queue and pointer stay bit-equal
on every rank.

Tolerances: ``tests/test_dp.py``'s own, loss and gradient norm rtol 1e-4,
parameters and queue 1e-5 absolute, for the DP step against the port's
single-device step and against the reference's single-device and DP steps,
and for the DP trainer against the single-device trainer; pointer, step and
Adam's count equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.contrastive.state import TrainConfig as JTrainConfig
from ircl_tpu.contrastive.state import init_train_state as j_init_train_state
from ircl_tpu.contrastive.train import make_train_step as j_make_train_step
from ircl_tpu.models.encoder import EncoderConfig as JEncoderConfig
from ircl_tpu.models.featurizer import FeaturizerConfig as JFeatCfg
from ircl_tpu.models.featurizer import HashEmbedFeaturizer as JHashFeat
from ircl_tpu.parallel.dp import make_dp_train_step as j_make_dp_train_step
from ircl_tpu.parallel.mesh import make_mesh as j_make_mesh
from ircl_tpu_torch.contrastive.state import TrainConfig
from ircl_tpu_torch.contrastive.state import init_train_state as t_init_train_state
from ircl_tpu_torch.contrastive.train import make_train_step
from ircl_tpu_torch.models.encoder import EncoderConfig
from ircl_tpu_torch.models.featurizer import FeaturizerConfig, HashEmbedFeaturizer
from ircl_tpu_torch.parallel.launch import launch
from ircl_tpu_torch.utils import convert

RANKS = 8
ENC = dict(input_size=16, hidden_size=8, output_size=8, num_layers=1)
CFG = dict(queue_size=32, queue_start_steps=1, micro_batch=16, accum_steps=2,
           learning_rate=1e-3)
FEAT = dict(dim=16, max_len=8, vocab_buckets=1 << 10)
PROTO = dict(loss="ProtoNCE", num_clusters=(4, 6), num_neg_proto=2)
DOCS = [[f"tok{i} sent{j} common words here" for j in range(3)] for i in range(12)]


def _configs(**kw):
    kw = dict(CFG, **kw)
    return (JTrainConfig(encoder=JEncoderConfig(**ENC), **kw),
            TrainConfig(encoder=EncoderConfig(**ENC), **kw))


J_FEAT = JHashFeat(JFeatCfg(**FEAT))
FEAT_PARAMS = jax.tree.map(np.asarray, J_FEAT.params)


def _t_feat():
    return HashEmbedFeaturizer(FeaturizerConfig(**FEAT), device="cpu",
                               params=convert.hash_featurizer_params_from_numpy(
                                   FEAT_PARAMS, device="cpu"))


def _batch(seed):
    """tests/test_dp.py's batches."""
    rng = np.random.default_rng(seed)
    n = CFG["accum_steps"] * CFG["micro_batch"]
    texts_a = [f"ent{rng.integers(40)} foo bar" for _ in range(n)]
    texts_k = [f"baz ent{rng.integers(40)} qux" for _ in range(n)]
    ids_a, mask_a = J_FEAT.encode_host(texts_a)
    ids_k, mask_k = J_FEAT.encode_host(texts_k)
    shp = (CFG["accum_steps"], CFG["micro_batch"], FEAT["max_len"])
    return tuple(a.reshape(shp) for a in (ids_a, mask_a, ids_k, mask_k))


def _proto(seed):
    """tests/test_dp.py's ProtoNCE inputs."""
    rng = np.random.default_rng(seed)
    shape_ids = (CFG["accum_steps"], CFG["micro_batch"])
    ks = PROTO["num_clusters"]
    return (
        [rng.integers(0, c, size=shape_ids).astype(np.int32) for c in ks],
        [rng.normal(size=(c, ENC["output_size"])).astype(np.float32) for c in ks],
        [rng.uniform(0.5, 2.0, size=(c,)).astype(np.float32) for c in ks],
        [rng.integers(0, c, size=(2,)).astype(np.int32) for c in ks],
    )


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carry_np(j_st):
    adam = j_st.opt_state[1][0]
    return dict(params_q=_np(j_st.params_q), params_k=_np(j_st.params_k),
                queue=np.asarray(j_st.queue), queue_ptr=int(j_st.queue_ptr),
                step=int(j_st.step), count=int(adam.count), mu=_np(adam.mu),
                nu=_np(adam.nu))


def _jax_runs(j_cfg, j_st, steps):
    """The reference's single-device and DP steps over ``steps`` (each step
    donates its state, so each run starts from a copy)."""
    single, hist_1 = j_make_train_step(j_cfg, J_FEAT), []
    st1 = jax.tree.map(jnp.copy, j_st)
    for batch, proto in steps:
        p = None if proto is None else jax.tree.map(jnp.asarray, proto)
        st1, loss, gn = single(st1, *map(jnp.asarray, batch), p)
        hist_1.append((float(loss), float(gn)))
    dp, place_state, place_batch, place_proto = j_make_dp_train_step(
        j_cfg, J_FEAT, j_make_mesh(("data",)))
    st8, hist_8 = place_state(jax.tree.map(jnp.copy, j_st)), []
    for batch, proto in steps:
        st8, loss, gn = dp(st8, *place_batch(*batch), place_proto(proto))
        hist_8.append((float(loss), float(gn)))
    return (st1, hist_1), (st8, hist_8)


def _port_single(t_cfg, state_np, steps):
    step = make_train_step(t_cfg, _t_feat())
    st = convert.train_state_from_numpy(**state_np, device="cpu")
    hist = []
    for batch, proto in steps:
        p = None if proto is None else [[torch.tensor(a) for a in x] for x in proto]
        st, loss, gn = step(st, *batch, p)
        hist.append((float(loss), float(gn)))
    return _torch_ranks.state_np(st), hist


STEP_CASES = {  # name: (config overrides, pre-steps of the reference, steps)
    "nt-xent": ({}, 0, lambda: [(_batch(0), None)] * 2),
    "proto": (PROTO, 0, lambda: [(_batch(1), _proto(3))]),
    "six steps from a carried state": ({}, 1, lambda: [(_batch(10 + s), None)
                                                       for s in range(6)]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    assert len(jax.devices()) == RANKS, "conftest must force 8 CPU devices"
    steps_cases, refs = {}, {}
    for name, (over, pre, make_steps) in STEP_CASES.items():
        j_cfg, t_cfg = _configs(**over)
        j_st = j_init_train_state(jax.random.PRNGKey(0), j_cfg)
        single = j_make_train_step(j_cfg, J_FEAT)
        for s in range(pre):
            j_st, _, _ = single(j_st, *map(jnp.asarray, _batch(100 + s)))
        steps = make_steps()
        state_np = _carry_np(j_st)
        refs[name] = dict(jax=_jax_runs(j_cfg, j_st, steps),
                          port_single=_port_single(t_cfg, state_np, steps))
        steps_cases[name] = dict(cfg=t_cfg, feat_cfg=FeaturizerConfig(**FEAT),
                                 feat_params=FEAT_PARAMS, state=state_np, steps=steps)
    root = tmp_path_factory.mktemp("dp_trainers")
    trainer_cases = {
        name: dict(cfg=_configs(**over)[1], feat_cfg=FeaturizerConfig(**FEAT),
                   feat_params=FEAT_PARAMS, docs=DOCS, steps=4, log_step=2,
                   ckptdir=str(root / name / "ckpt"), logdir=str(root / name / "log"))
        for name, over in (("InfoNCE", {}), ("ProtoNCE", dict(
            PROTO, cluster_start_steps=0, cluster_update_steps=2)))
    }
    trainer_cases["ProtoNCE"]["rank_dependent_refresh"] = True
    got = launch(_torch_ranks.dp_runs, RANKS, steps_cases, trainer_cases, device="cpu")
    return refs, got


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _assert_close(got, want, atol):
    g, w = dict(_named(got)), dict(_named(want))
    assert g.keys() == w.keys()
    for name in w:
        np.testing.assert_allclose(g[name], w[name], rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_dp_equals_single_device(runs, case):
    """tests/test_dp.py::test_dp_equals_single_device and
    ::test_dp_proto_equals_single_device on the port, plus six steps from a
    state the reference carried one step: the DP step equals the port's
    single-device step, and follows the reference's DP and single-device
    steps."""
    refs, got = runs
    dp = got["steps"][case]
    port_state, port_hist = refs[case]["port_single"]
    (j1, j1_hist), (j8, j8_hist) = refs[case]["jax"]
    np.testing.assert_allclose(dp["hist"], port_hist, rtol=1e-4)
    for (loss, gn), (jl1, jg1), (jl8, jg8) in zip(dp["hist"], j1_hist, j8_hist):
        np.testing.assert_allclose([loss, gn], [jl1, jg1], rtol=1e-4)
        np.testing.assert_allclose([loss, gn], [jl8, jg8], rtol=1e-4)
    st = dp["state"]
    _assert_close(st["params_q"], port_state["params_q"], 1e-5)
    _assert_close(st["params_k"], port_state["params_k"], 1e-5)
    np.testing.assert_allclose(st["queue"], port_state["queue"], rtol=0, atol=1e-5)
    for j_st in (j1, j8):
        _assert_close(st["params_q"], _np(j_st.params_q), 1e-5)
        _assert_close(st["params_k"], _np(j_st.params_k), 1e-5)
        np.testing.assert_allclose(st["queue"], np.asarray(j_st.queue), rtol=0,
                                   atol=1e-5)
        assert st["queue_ptr"] == port_state["queue_ptr"] == int(j_st.queue_ptr)
        assert st["step"] == port_state["step"] == int(j_st.step)
        assert st["opt_state"]["count"] == int(j_st.opt_state[1][0].count)


@pytest.mark.parametrize("loss", ["InfoNCE", "ProtoNCE"])
def test_trainer_dp_matches_single_device(runs, loss):
    """tests/test_dp.py::test_trainer_dp_matches_single_device on the port
    (and with ProtoNCE, refreshed at steps 0 and 2 on every rank): the DP
    trainer over the sampler's stream reproduces the single-device trainer;
    a fresh DP trainer resumes from rank 0's checkpoint at step 4."""
    _, got = runs
    run = got["trainers"][loss]
    dp, single = run["dp"], run["single"]
    assert dp["state"]["step"] == single["state"]["step"] == 4
    _assert_close(dp["state"]["params_q"], single["state"]["params_q"], 1e-5)
    np.testing.assert_allclose(dp["state"]["queue"], single["state"]["queue"],
                               rtol=0, atol=1e-5)
    assert dp["refreshes"] == single["refreshes"] == (2 if loss == "ProtoNCE" else 0)
    assert dp["resumed_at"] == 4 and dp["resumed_equal"]
    assert dp["checkpoints"] == ["_2", "_4"]


def test_trainer_dp_refresh_keeps_rank_0s_clusters(runs):
    """Where the ranks' cluster refreshes differ (on the card the k-means
    sums with float atomics), every rank trains on rank 0's: the DP
    trainer ends on the bits it reaches when the ranks agree, on every
    rank."""
    _, got = runs
    run = got["trainers"]["ProtoNCE"]
    assert run["rank_dependent"]["refreshes"] == 2
    _assert_close(run["rank_dependent"]["state"], run["dp"]["state"], 0.0)


def test_place_state_replicates_rank_0_in_each_leafs_layout(runs):
    """``place_state`` of states that differ by rank gives every rank rank
    0's values, each leaf in its own strides: ``init_train_state``'s
    recurrent weights are transposed views, which NCCL would refuse to
    broadcast, and a layout can change which kernel a product takes."""
    _, got = runs
    placed = got["placed"]
    want = _torch_ranks.state_np(t_init_train_state(0, _configs()[1], device="cpu"))
    _assert_close(placed["values"], want, 0.0)
    assert placed["same_layout"] and placed["transposed"] > 0


def test_dp_refusals():
    """What is not a mesh is refused before any collective."""
    from ircl_tpu_torch.contrastive.trainer import ContrastiveTrainer
    from ircl_tpu_torch.data.pairs import DocPairSampler
    from ircl_tpu_torch.parallel.dp import make_dp_train_step

    _, t_cfg = _configs()
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_dp_train_step(t_cfg, _t_feat(), object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        ContrastiveTrainer(t_cfg, _t_feat(), DocPairSampler(DOCS, sample="uniform"),
                           mesh="data", device="cpu")
