"""The port's k-means, phi densities and clustering against ``ircl_tpu``'s
(``tests/test_cluster.py`` and ``tests/test_proto_edges.py``'s cases).

The port's k-means++ draws come from a ``torch.Generator``, so the Lloyd
loop is held to the JAX package's ``kmeans_fit(num_redo=1)`` from the
JAX package's own seeding. Tolerances: assignments equal, centroids within
1e-5 absolute; squared distances within 4 float32 ulps of the largest
||x||^2, since both packages expand ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2
and the small result keeps the rounding of the large terms (blobs at scale
3 have ||x||^2 near 100: 1.5e-5 apart); ``phi_density`` and
``run_hierarchical`` within rtol 1e-5 (Ward's labels equal: both run scipy
on the same float64 points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.contrastive import cluster as j_cluster
from ircl_tpu.ops import kmeans as j_km
from ircl_tpu_torch.contrastive import cluster as t_cluster
from ircl_tpu_torch.contrastive.losses import proto_loss, sample_negative_prototypes
from ircl_tpu_torch.ops import kmeans as t_km

ATOL = 1e-5
RTOL = 1e-5


def _blobs(rng, k=4, per=50, d=8, spread=0.05):
    centers = rng.normal(size=(k, d)) * 3
    pts = np.concatenate(
        [c + spread * rng.normal(size=(per, d)) for c in centers]
    ).astype(np.float32)
    return pts, np.repeat(np.arange(k), per)


def _points(kind):
    rng = np.random.default_rng(0)
    if kind == "blobs":
        return _blobs(rng)[0], 4
    return rng.normal(size=(200, 8)).astype(np.float32), 8  # no structure


@pytest.mark.parametrize("kind", ["blobs", "normal"])
def test_lloyd_from_jax_seeding_matches_jax_kmeans_fit(kind):
    x, k = _points(kind)
    key = jax.random.PRNGKey(7)
    init = jax.jit(j_km._kmeanspp_init, static_argnums=2)(key, jnp.asarray(x), k)
    want_c, want_a, want_d = j_km.kmeans_fit(key, jnp.asarray(x), k, 20, 1)
    got_c, got_a, got_d = t_km.lloyd(torch.tensor(x), torch.tensor(np.asarray(init)), 20)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=ATOL)
    cancel = 4 * np.finfo(np.float32).eps * float((x * x).sum(axis=1).max())
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=cancel)


def test_kmeans_recovers_blobs():
    rng = np.random.default_rng(0)
    pts, labels = _blobs(rng)
    gen = torch.Generator().manual_seed(0)
    _, assign, sq_d = t_km.kmeans_fit(gen, torch.tensor(pts), 4, 25, 4)
    assign = assign.numpy()
    for b in range(4):  # every blob maps to exactly one cluster
        assert len(set(assign[labels == b].tolist())) == 1
    assert float(sq_d.mean()) < 0.1


def test_kmeans_keeps_the_lowest_inertia_of_its_redos():
    x, k = _points("normal")
    inertia = [
        float(t_km.kmeans_fit(torch.Generator().manual_seed(3), torch.tensor(x), k, 5,
                              redo)[2].sum())
        for redo in (1, 4)
    ]
    # four seedings from one generator: the first is the one-redo run's
    assert inertia[1] <= inertia[0]


@pytest.mark.parametrize("case", ["duplicates", "more clusters than points"])
def test_kmeanspp_zero_probability_draw_picks_index_0_like_jax(case):
    """Once every point is a centroid (or all coincide) every probability is
    0: ``jax.random.choice`` then picks index 0, where ``torch.multinomial``
    would raise."""
    rng = np.random.default_rng(1)
    if case == "duplicates":
        x = np.repeat(rng.normal(size=(1, 8)), 12, axis=0).astype(np.float32)
    else:
        x = rng.normal(size=(12, 8)).astype(np.float32)
    k = 16
    got = t_km.kmeanspp_init(torch.Generator().manual_seed(0), torch.tensor(x), k).numpy()
    want = np.asarray(jax.jit(j_km._kmeanspp_init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(x), k))
    for c in (got, want):
        assert np.isfinite(c).all()
        rows = {r.tobytes() for r in c}
        assert rows == {r.tobytes() for r in x}  # every point chosen, nothing else
        # past the last new point, index 0 again and again
        assert (c[len(set(map(bytes, x))):] == x[0]).all()
    gen = torch.Generator().manual_seed(0)
    _, _, sq_d = t_km.kmeans_fit(gen, torch.tensor(x), k, 3, 2)
    assert torch.isfinite(sq_d).all()


@pytest.mark.parametrize("case", ["random", "all singletons", "empty clusters"])
def test_phi_density_matches_jax(case):
    rng = np.random.default_rng(1)
    if case == "random":
        k, assign = 8, rng.integers(0, 8, 200)
    elif case == "all singletons":  # granularity >= corpus: flat temperatures
        k, assign = 12, rng.permutation(12)
    else:
        k, assign = 20, rng.integers(0, 6, 50)
    sq_d = rng.random(len(assign)).astype(np.float32)
    want = np.asarray(j_km.phi_density(
        jnp.asarray(assign.astype(np.int32)), jnp.asarray(sq_d), k, temperature=0.05))
    got = t_km.phi_density(torch.tensor(assign), torch.tensor(sq_d), k, 0.05).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got.shape == (k,) and (got > 0).all()
    np.testing.assert_allclose(got.mean(), 0.05, rtol=1e-5)


def test_normalize_rows_matches_jax():
    c = np.random.default_rng(2).normal(size=(6, 8)).astype(np.float32)
    c[2] = 0.0
    np.testing.assert_allclose(t_km.normalize_rows(torch.tensor(c)).numpy(),
                               np.asarray(j_km.normalize_rows(jnp.asarray(c))),
                               rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("ks", [(3, 5), (64,)])
def test_run_hierarchical_matches_jax(ks):
    rng = np.random.default_rng(3)
    pts = _blobs(rng, k=3, per=20)[0] if ks != (64,) else rng.normal(size=(12, 8))
    want = j_cluster.run_hierarchical(pts, ks, temperature=0.05)
    got = t_cluster.run_hierarchical(pts, ks, temperature=0.05, device="cpu")
    assert got.num_granularities == len(ks)
    for g in range(len(ks)):
        np.testing.assert_array_equal(got.emb2cluster[g].numpy(),
                                      np.asarray(want.emb2cluster[g]))
        for name in ("centroids", "density"):
            np.testing.assert_allclose(getattr(got, name)[g].numpy(),
                                       np.asarray(getattr(want, name)[g]), rtol=RTOL)


def test_run_kmeans_multi_granularity():
    rng = np.random.default_rng(2)
    pts, _ = _blobs(rng, k=6, per=30)
    res = t_cluster.run_kmeans(pts, [4, 6], 0.05, seed=3, device="cpu")
    assert res.num_granularities == 2
    for c, a, d, k in zip(res.centroids, res.emb2cluster, res.density, [4, 6]):
        assert c.shape == (k, 8) and int(a.max()) < k and d.shape == (k,)
        np.testing.assert_allclose(torch.linalg.vector_norm(c, dim=1).numpy(), 1.0,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(d.mean()), 0.05, rtol=1e-5)
    again = t_cluster.run_kmeans(pts, [4, 6], 0.05, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(res.emb2cluster, again.emb2cluster))


def test_all_singleton_clusters_give_finite_proto_losses():
    """``tests/test_proto_edges.py``'s case: more clusters than points."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(12, 8)).astype(np.float32)
    for result in (
        t_cluster.run_hierarchical(emb, (64,), 0.05, device="cpu"),
        t_cluster.run_kmeans(emb, (64,), 0.05, num_iters=3, num_redo=1, device="cpu"),
    ):
        dens = result.density[0]
        assert torch.isfinite(dens).all() and (dens > 0).all()
        ids = result.emb2cluster[0][:4]
        q = torch.tensor(rng.normal(size=(4, 8)).astype(np.float32))
        negs = sample_negative_prototypes(
            torch.Generator().manual_seed(0), result.centroids[0].shape[0], ids, 3)
        loss = proto_loss(q, [ids], [result.centroids[0]], [dens], [negs])
        assert torch.isfinite(loss)
