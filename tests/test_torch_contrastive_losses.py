"""The port's contrastive losses against ``ircl_tpu.contrastive.losses`` on
the same seeded inputs (``tests/test_losses.py``'s shapes and cases).

Tolerances. Loss values: rtol 1e-5 (fp32 on both sides, sums in another
order). Gradients with respect to q and k, against ``jax.grad``: 1e-6
absolute where the largest element is at most 1, and 2e-6 of the largest
element (16 float32 ulps of it) where it is larger: logits over a
temperature of 0.05-0.07 reach 20-45, so gradient elements are of order
1-20, and ``logsumexp`` and its gradient sum in another order in the two
packages (MoCo's unnormalized queue gave 1.25e-6 of its largest element).
``sample_negative_prototypes`` draws from a ``torch.Generator`` and cannot
match JAX's bits, so its contract is held instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.contrastive import losses as j_losses
from ircl_tpu_torch.contrastive import losses as t_losses

RTOL = 1e-5
GRAD_ATOL, GRAD_OF_LARGEST = 1e-6, 2e-6


def _unit(rng, *shape, axis=-1):
    x = rng.normal(size=shape)
    return (x / np.linalg.norm(x, axis=axis, keepdims=True)).astype(np.float32)


def _t(*arrays, grad=False):
    out = [torch.tensor(a, requires_grad=grad) for a in arrays]
    return out if len(out) > 1 else out[0]


def _grad_atol(want):
    largest = float(np.abs(np.asarray(want)).max())
    return GRAD_ATOL if largest <= 1.0 else GRAD_OF_LARGEST * largest


@pytest.mark.parametrize("queue_mode", ["none", "off", "on", "flag 0.0", "flag 1.0"])
def test_nt_xent_value_and_gradients_match_jax(queue_mode):
    rng = np.random.default_rng(0)
    n, d, qsz = 6, 8, 10
    q, k = _unit(rng, n, d), _unit(rng, n, d)
    queue = _unit(rng, d, qsz, axis=0)
    kw = {"none": dict(queue=None),
          "off": dict(queue=queue, use_queue=False),
          "on": dict(queue=queue, use_queue=True),
          "flag 0.0": dict(queue=queue, use_queue=np.float32(0.0)),
          "flag 1.0": dict(queue=queue, use_queue=np.float32(1.0))}[queue_mode]

    def j_kw():
        return {key: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                for key, v in kw.items()}

    def t_kw():
        out = dict(kw)
        if out["queue"] is not None:
            out["queue"] = torch.tensor(out["queue"])
        if isinstance(out.get("use_queue"), np.floating):
            out["use_queue"] = torch.tensor(out["use_queue"])  # a 0-dim flag
        return out

    want, (wq, wk) = jax.value_and_grad(
        lambda a, b: j_losses.nt_xent_loss(a, b, 0.05, **j_kw()), argnums=(0, 1)
    )(jnp.asarray(q), jnp.asarray(k))
    tq, tk = _t(q, k, grad=True)
    got = t_losses.nt_xent_loss(tq, tk, 0.05, **t_kw())
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    np.testing.assert_allclose(tq.grad.numpy(), wq, rtol=0, atol=_grad_atol(wq))
    np.testing.assert_allclose(tk.grad.numpy(), wk, rtol=0, atol=_grad_atol(wk))
    # the flag off is the loss without a queue, as in the reference
    if queue_mode in ("off", "flag 0.0"):
        none = t_losses.nt_xent_loss(_t(q), _t(k), 0.05)
        np.testing.assert_allclose(float(got.detach()), float(none), rtol=RTOL)


def test_moco_infonce_value_and_gradients_match_jax():
    rng = np.random.default_rng(2)
    q, k = _unit(rng, 5, 8), _unit(rng, 5, 8)
    queue = rng.normal(size=(8, 12)).astype(np.float32)
    want, (wq, wk) = jax.value_and_grad(
        lambda a, b: j_losses.moco_infonce_loss(a, b, jnp.asarray(queue), 0.07),
        argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    tq, tk = _t(q, k, grad=True)
    got = t_losses.moco_infonce_loss(tq, tk, _t(queue), 0.07)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    np.testing.assert_allclose(tq.grad.numpy(), wq, rtol=0, atol=_grad_atol(wq))
    np.testing.assert_allclose(tk.grad.numpy(), wk, rtol=0, atol=_grad_atol(wk))


def _proto_inputs(rng, n, d, ks, r, leak):
    ids, cents, dens, negs = [], [], [], []
    for kk in ks:
        cid = rng.integers(0, kk, size=n)
        others = [c for c in range(kk) if c not in set(cid.tolist())]
        # leaking: the negatives hold every positive, as when num_neg exceeds
        # the clusters that are not positives
        neg = (np.concatenate([np.unique(cid), others])[:r] if leak
               else rng.choice(others, r, replace=False))
        ids.append(cid.astype(np.int32))
        cents.append(_unit(rng, kk, d))
        dens.append(rng.uniform(0.03, 0.1, size=kk).astype(np.float32))
        negs.append(neg.astype(np.int32))
    return ids, cents, dens, negs


@pytest.mark.parametrize("leak", [False, True])
def test_proto_loss_value_and_gradient_match_jax(leak):
    rng = np.random.default_rng(3)
    n, d = 4, 8
    q = _unit(rng, n, d)
    ids, cents, dens, negs = _proto_inputs(rng, n, d, (8, 12), 6 if leak else 3, leak)
    if leak:
        assert all(set(i.tolist()) <= set(g.tolist()) for i, g in zip(ids, negs))
    jt = [list(map(jnp.asarray, x)) for x in (ids, cents, dens, negs)]
    want, wq = jax.value_and_grad(lambda a: j_losses.proto_loss(a, *jt))(jnp.asarray(q))
    tq = _t(q, grad=True)
    got = t_losses.proto_loss(tq, *[[torch.tensor(a) for a in x]
                                    for x in (ids, cents, dens, negs)])
    got.backward()
    assert np.isfinite(float(got.detach()))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    np.testing.assert_allclose(tq.grad.numpy(), wq, rtol=0, atol=_grad_atol(wq))


@pytest.mark.parametrize("num_clusters, pos, num_neg", [
    (32, [1, 5, 5, 7], 20),  # test_losses.py's case
    (32, [1, 5, 5, 7], 29),  # every other cluster
    (8, [0, 3, 3, 6], 7),  # K - 1, as the trainer asks: positives must come in
    (4, [0, 1, 2, 3], 3),  # only positives exist
])
def test_sample_negative_prototypes_contract(num_clusters, pos, num_neg):
    """Distinct ids, as many as asked; the positives left out while enough
    other clusters exist, and otherwise only after every other cluster."""
    pos_t = torch.tensor(pos)
    others = set(range(num_clusters)) - set(pos)
    for seed in range(5):
        gen = torch.Generator().manual_seed(seed)
        negs = t_losses.sample_negative_prototypes(gen, num_clusters, pos_t, num_neg)
        got = negs.tolist()
        assert negs.dtype == torch.int64 and len(got) == num_neg == len(set(got))
        assert all(0 <= c < num_clusters for c in got)
        if num_neg <= len(others):
            assert set(got) <= others
        else:
            assert others <= set(got)
    draws = {tuple(t_losses.sample_negative_prototypes(
        torch.Generator().manual_seed(s), 32, torch.tensor([1, 5]), 8).tolist())
        for s in range(4)}
    assert len(draws) > 1  # the generator drives the draw
