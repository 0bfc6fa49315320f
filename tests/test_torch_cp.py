"""The port's context parallelism (ring attention) on an 8-rank gloo group
against ``ircl_tpu.parallel.cp`` and ``ircl_tpu.ops.ring_attention``.

Mirrors ``tests/test_cp.py`` on its config (2 layers, hidden 16, 2 heads,
L=64, B=4, vocabulary 97) and its ragged batches, whose pads cross the
sequence blocks (at seq = 8 whole blocks of a row are pads): the forward at
(data, seq) = (1, 4), (2, 4) and (1, 8) against the reference's
``verdict_apply`` (rtol 2e-5, atol 2e-6); three Adam(1e-3) steps at (2, 4)
against the reference's single-device steps (losses rtol 2e-5, parameters
rtol 5e-4, atol 1e-6); the refusal of MoE and flash; and the ring alone
against a masked softmax over the gathered sequence. Beyond them, for the
reverse ring written by hand: the ring's dq, dk and dv against
``jax.grad`` of the reference's ``ring_attention`` under ``shard_map``,
with random pads and with whole blocks of pads, and the first batch's
gradient of every leaf (the head and the embeddings included, which the
``[CLS]`` broadcast and the sum over ``("data", "seq")`` carry) against
``jax.grad`` of the reference's single-device loss, since Adam hides a
gradient's scale. One launch of 8 CPU ranks runs every case; a mesh of 4
ranks runs as two replicas.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as JP

import _torch_ranks
from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.models import transformer as j_tf
from ircl_tpu.ops.ring_attention import ring_attention as j_ring_attention
from ircl_tpu.parallel import cp as j_cp
from ircl_tpu.verdict import model as j_model
from ircl_tpu_torch.models import moe as t_moe
from ircl_tpu_torch.models import transformer as t_tf
from ircl_tpu_torch.parallel import cp as t_cp
from ircl_tpu_torch.parallel.launch import launch
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.verdict import model as t_model
from test_torch_tp import GRAD_TOL, RANKS, TIMEOUT, assert_trees_close, np_tree

B, L, VOCAB = 4, 64, 97
FWD_TOL = dict(rtol=2e-5, atol=2e-6)
RING_GRAD_TOL = dict(rtol=1e-5, atol=2e-6)


def _cfgs(**enc):
    kw = dict(vocab_size=VOCAB, hidden=16, layers=2, heads=2, intermediate=32,
              max_positions=L, **enc)
    return (j_model.VerdictConfig(encoder=j_tf.TransformerConfig(**kw), max_length=L),
            t_model.VerdictConfig(encoder=t_tf.TransformerConfig(**kw), max_length=L))


def _batch(seed=0):
    """``tests/test_cp.py``'s batch: ragged real lengths from L/3 to L."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, size=(B, L)).astype(np.int32)
    lens = rng.integers(L // 3, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    types = (rng.random((B, L)) < 0.5).astype(np.int32)
    labels = rng.integers(0, 2, size=B).astype(np.int32)
    return ids, mask, types, labels


def _ring_inputs(pad_blocks):
    """``test_ring_attention_primitive_matches_local_softmax``'s q, k, v and
    pad bias (seed 3, [2, 2, 32, 8]); ``pad_blocks``: row 1 real only in
    its first block of 8 (three whole blocks of pads); and a cotangent."""
    rng = np.random.default_rng(3)
    shape = (2, 2, 32, 8)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    mask = (rng.random((2, 32)) < 0.8).astype(np.float32)
    if pad_blocks:
        mask[1, 8:] = 0.0
    bias = ((1.0 - mask[:, None, None, :]) * -1e9).astype(np.float32)
    w = rng.normal(size=shape).astype(np.float32)
    return q, k, v, bias, w


@functools.lru_cache(maxsize=None)
def _j_ring(seq):
    """The reference's ring over a ``("data", "seq")`` mesh of ``seq``
    devices, and ``jax.grad`` of ``sum(out * w)`` through it."""
    mesh = j_cp.make_cp_mesh(seq=seq, data=1)
    spec = JP(None, None, "seq", None)
    ring = shard_map(functools.partial(j_ring_attention, axis_name="seq"), mesh=mesh,
                     in_specs=(spec, spec, spec, JP(None, None, None, "seq")),
                     out_specs=spec)
    grad = jax.grad(lambda q, k, v, b, w: jnp.sum(ring(q, k, v, b) * w), argnums=(0, 1, 2))
    return jax.jit(ring), jax.jit(grad)


@pytest.fixture(scope="module")
def runs():
    """Every case's inputs, then the ranks' launch in a thread while the
    reference's results are computed here."""
    assert len(jax.devices()) == RANKS, "conftest must force 8 CPU devices"
    j_cfg, t_cfg = _cfgs()
    cases = {}
    p_fwd = np_tree(j_model.init_verdict_params(jax.random.PRNGKey(0), j_cfg))
    arrays = _batch()
    for data, seq in ((1, 4), (2, 4), (1, 8)):
        cases[f"forward_{data}_{seq}"] = ("cp_forward", dict(
            cfg=t_cfg, params0=p_fwd, arrays=arrays[:3], shape=dict(data=data, seq=seq)))
    p0 = np_tree(j_model.init_verdict_params(jax.random.PRNGKey(1), j_cfg))
    batches = [_batch(seed=10 + s) for s in range(3)]
    cases["train"] = ("cp_steps", dict(cfg=t_cfg, params0=p0, batches=batches,
                                       shape=dict(data=2, seq=4)))
    for name, pads in (("ring", False), ("ring_pads", True)):
        q, k, v, bias, w = _ring_inputs(pads)
        cases[name] = ("ring_parity", dict(q=q, k=k, v=v, bias=bias, w=w, seq=4))

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, _torch_ranks.parallel_runs, RANKS, cases, device="cpu",
                            timeout=TIMEOUT)
        refs = {"forward": np.asarray(jax.jit(lambda p, i, m, t: j_model.verdict_apply(
            p, j_cfg, i, m, t))(p_fwd, *arrays[:3]))}
        # three Adam(1e-3) steps on the reference's single device
        tx = optax.adam(1e-3)

        def loss_fn(p, ids, mask, types, labels):
            logits = j_model.verdict_apply(p, j_cfg, ids, mask, types)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32))
            return -jnp.take_along_axis(logp, labels[:, None], axis=1).mean()

        @jax.jit
        def ref_step(p, o, *b):
            loss, g = jax.value_and_grad(loss_fn)(p, *b)
            up, o = tx.update(g, o, p)
            return optax.apply_updates(p, up), o, loss, g

        p, o, losses = p0, tx.init(p0), []
        for s, b in enumerate(batches):
            p, o, loss, g = ref_step(p, o, *b)
            losses.append(float(loss))
            if s == 0:
                g0 = np_tree(g)
        refs["train"] = dict(losses=losses, params=np_tree(p), grads=g0,
                             grad_loss=losses[0])
        for name, pads in (("ring", False), ("ring_pads", True)):
            q, k, v, bias, w = _ring_inputs(pads)
            ring, ring_grad = _j_ring(4)
            refs[name] = dict(out=np.asarray(ring(q, k, v, bias)),
                              grads=[np.asarray(g) for g in ring_grad(q, k, v, bias, w)])
        got = ranks.result()
    return dict(got=got, refs=refs)


@pytest.mark.parametrize("data,seq", [(1, 4), (2, 4), (1, 8)])
def test_cp_forward_matches_single_device(runs, data, seq):
    """The online softmax reassociates the f32 sums; every other step is
    the single-device code (``transformer_block`` with ``seq_axis``)."""
    got = runs["got"][f"forward_{data}_{seq}"]
    np.testing.assert_allclose(got, runs["refs"]["forward"], **FWD_TOL)


def test_cp_train_matches_single_device(runs):
    """Three Adam steps at (data, seq) = (2, 4): every step's loss and
    every final leaf equal the reference's single device; the first
    gradient of every leaf meets ``jax.grad``."""
    got, ref = runs["got"]["train"], runs["refs"]["train"]
    for s, (g, w) in enumerate(zip(got["losses"], ref["losses"])):
        np.testing.assert_allclose(g, w, rtol=2e-5, err_msg=f"loss diverged at step {s}")
    assert_trees_close(got["params"], ref["params"], rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(got["grad_loss"], ref["grad_loss"], rtol=2e-5)
    assert_trees_close(got["grads"], ref["grads"], **GRAD_TOL)


def test_cp_rejects_moe_and_flash():
    """Refused before the mesh is touched, with the reference's messages."""
    _, t_moe_cfg = _cfgs(moe=t_moe.MoEConfig(num_experts=2, capacity_factor=2.0))
    with pytest.raises(ValueError, match="MoE"):
        t_cp.make_cp_verdict_forward(t_moe_cfg, None)
    with pytest.raises(ValueError, match="flash"):
        t_cp.make_cp_verdict_forward(_cfgs(attention="flash")[1], None)
    with pytest.raises(ValueError, match="MoE"):
        t_cp.make_cp_verdict_train_step(t_moe_cfg, None)


def test_ring_attention_primitive_matches_local_softmax(runs):
    """The ring over 4 ranks equals a plain masked softmax over the gathered
    sequence, and the reference's ring."""
    q, k, v, bias, _ = _ring_inputs(False)
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1]) + bias
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = np.einsum("bhqk,bhkd->bhqd", probs, v)
    got = runs["got"]["ring"]["out"]
    np.testing.assert_allclose(got, want, **FWD_TOL)
    np.testing.assert_allclose(got, runs["refs"]["ring"]["out"], **FWD_TOL)


@pytest.mark.parametrize("name", ["ring", "ring_pads"])
def test_ring_attention_backward_matches_jax_grad(runs, name):
    """The hand-written reverse ring (dq accumulated locally, dk and dv
    travelling back to their owners) against ``jax.grad`` through the
    reference's ring, with whole blocks of pads in ``ring_pads``."""
    got, ref = runs["got"][name], runs["refs"][name]
    np.testing.assert_allclose(got["out"], ref["out"], **FWD_TOL)
    for key, want in zip(("dq", "dk", "dv"), ref["grads"]):
        np.testing.assert_allclose(got[key], want, err_msg=key, **RING_GRAD_TOL)


def test_embedding_positions_start_where_the_block_starts():
    """``transformer_embed(pos_start=)`` equals the reference's: a block of
    the sequence reads its global positions."""
    j_cfg, t_cfg = _cfgs()
    params = np_tree(j_tf.init_transformer_params(jax.random.PRNGKey(4), j_cfg.encoder))
    ids, _, types, _ = _batch(5)
    for start in (0, 16, 48):
        want = j_tf.transformer_embed(params, j_cfg.encoder, ids[:, :16], types[:, :16],
                                      pos_start=start)
        got = t_tf.transformer_embed(convert.transformer_params_from_numpy(params, "cpu"),
                                     t_cfg.encoder, torch.as_tensor(ids[:, :16]).long(),
                                     torch.as_tensor(types[:, :16]).long(),
                                     pos_start=start)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
