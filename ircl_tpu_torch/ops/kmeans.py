"""K-means on the card: one matrix product an iteration for the distances,
``index_add_`` for the centroid sums.

Counterpart of ``ircl_tpu/ops/kmeans.py`` (plain XLA there, plain PyTorch
here), which replaces the reference's faiss GPU clustering
(``src/contrastor/utils.py:28-71``): ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2,
argmin over the centroids, empty clusters keep their previous centroid.

- ``kmeanspp_init`` is k-means++ seeding: K sequential draws from a
  ``torch.Generator`` on the points' device, each a few launches with no
  read back to the host. A draw inverts the cumulative distribution as
  ``jax.random.choice`` does, so where every probability is 0 (duplicate
  points, K >= N) it picks index 0, as JAX does, instead of raising as
  ``torch.multinomial`` would.
- ``lloyd`` is the iteration alone, so that it can start from any seeding
  (the tests start it from the JAX package's).
- ``kmeans_fit`` runs ``num_redo`` seedings one after another and keeps the
  lowest inertia (a ``vmap`` in the reference; faiss's ``nredo``).

Also the phi concentration estimate used for per-prototype temperatures
(``src/contrastor/utils.py:79-94``): phi_c = mean(sqrt(d_i)) / log(n_c + 10),
singletons get the largest phi, clipped to [p10, p90], scaled so that the
mean phi is the temperature. Products run in full fp32
(``utils.precision.float32_precision``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ircl_tpu_torch.utils.precision import float32_precision


def kmeanspp_init(gen: torch.Generator, x: torch.Tensor, num_clusters: int) -> torch.Tensor:
    """k-means++ seeding: ``[num_clusters, D]`` centroids, each drawn with
    probability proportional to its squared distance from the nearest
    centroid drawn before it. ``gen`` lies on ``x``'s device."""
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=gen, device=x.device)
    centroids = x.new_zeros((num_clusters, x.shape[1]))
    centroids[:1] = x[first]
    min_d = ((x - x[first]) ** 2).sum(dim=1)
    for i in range(1, num_clusters):
        probs = min_d / torch.clamp(min_d.sum(), min=1e-12)
        cum = torch.cumsum(probs, dim=0)
        r = cum[-1:] * (1.0 - torch.rand(1, generator=gen, device=x.device))
        idx = torch.searchsorted(cum, r).clamp_(max=n - 1)
        c = x[idx]  # [1, D]
        centroids[i : i + 1] = c
        min_d = torch.minimum(min_d, ((x - c) ** 2).sum(dim=1))
    return centroids


def _assign(x: torch.Tensor, x_sq: torch.Tensor, centroids: torch.Tensor):
    """(assignments [N], squared distances to them [N]); x_sq is constant
    per row (argmin-invariant) but kept so the distances are true ones."""
    c_sq = (centroids * centroids).sum(dim=1)  # [K]
    d = x_sq - 2.0 * (x @ centroids.T) + c_sq[None, :]
    dist, a = torch.min(d, dim=1)
    return a, torch.clamp(dist, min=0.0)


def lloyd(
    x: torch.Tensor, centroids: torch.Tensor, num_iters: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``num_iters`` Lloyd iterations from ``centroids``; (centroids [K, D],
    assignments [N], squared distances [N] to the own centroid)."""
    k = centroids.shape[0]
    with float32_precision():
        x_sq = (x * x).sum(dim=1, keepdim=True)  # [N, 1]
        ones = x.new_ones(x.shape[0])
        for _ in range(num_iters):
            a, _ = _assign(x, x_sq, centroids)
            sums = x.new_zeros(centroids.shape).index_add_(0, a, x)
            counts = x.new_zeros(k).index_add_(0, a, ones)
            new = sums / torch.clamp(counts[:, None], min=1.0)
            centroids = torch.where(counts[:, None] > 0, new, centroids)
        a, d = _assign(x, x_sq, centroids)
    return centroids, a, d


def kmeans_fit(
    gen: torch.Generator,
    x: torch.Tensor,  # [N, D] points
    num_clusters: int,
    num_iters: int = 20,
    num_redo: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm from k-means++ seeding, ``num_redo`` times; the
    lowest inertia wins. Returns (centroids [K, D], assignments [N],
    squared distances [N] to the own centroid)."""
    runs = [
        lloyd(x, kmeanspp_init(gen, x, num_clusters), num_iters)
        for _ in range(num_redo)
    ]
    if num_redo == 1:
        return runs[0]
    best = torch.argmin(torch.stack([d.sum() for _, _, d in runs])).reshape(1)
    # index_select keeps the choice on the device (no read of ``best``)
    return tuple(torch.stack(parts).index_select(0, best)[0] for parts in zip(*runs))


def phi_density(
    assignments: torch.Tensor,  # [N] cluster ids
    sq_dists: torch.Tensor,  # [N] squared distance to the own centroid
    num_clusters: int,
    temperature: float,
) -> torch.Tensor:
    """Per-cluster concentration temperatures (the reference's formula)."""
    a = assignments.long()
    zeros = sq_dists.new_zeros(num_clusters)
    counts = zeros.index_add(0, a, torch.ones_like(sq_dists))
    sqrt_sum = zeros.index_add(0, a, torch.sqrt(sq_dists))
    multi = counts > 1
    density = torch.where(
        multi,
        (sqrt_sum / torch.clamp(counts, min=1.0)) / torch.log(counts + 10.0),
        0.0,
    )
    dmax = density.max()
    density = torch.where(multi, density, dmax)
    # every cluster a singleton (granularity >= corpus) or zero spread: the
    # singleton rule (the largest multi-cluster density) is undefined and
    # zero temperatures would make the proto loss NaN, so all are flat
    density = torch.where(dmax <= 0.0, torch.ones_like(density), density)
    lo = torch.quantile(density, 0.10)
    hi = torch.quantile(density, 0.90)
    density = torch.clamp(density, lo, hi)
    return temperature * density / torch.clamp(density.mean(), min=1e-12)


def normalize_rows(c: torch.Tensor) -> torch.Tensor:
    return c / torch.clamp(torch.linalg.vector_norm(c, dim=1, keepdim=True), min=1e-12)
