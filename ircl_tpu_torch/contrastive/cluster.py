"""Cluster orchestration for ProtoNCE / HProtoNCE.

Counterpart of ``ircl_tpu/contrastive/cluster.py``, the reference's
``run_kmeans`` / ``run_hierarchical_clustering``
(``src/contrastor/utils.py:50-160``): the corpus embedded by the query
encoder is clustered at several granularities, and each granularity gives
normalized centroids and phi-scaled per-prototype temperatures for the
proto loss. K-means runs on the device (``ops/kmeans.py``); Ward
hierarchical clustering runs on the host through scipy's nn-chain (the
reference used fastcluster for the same job), carried over line for line,
and its results are moved to the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from ircl_tpu_torch.ops.kmeans import kmeans_fit, normalize_rows, phi_density
from ircl_tpu_torch.utils.device import resolve_device


@dataclass
class ClusterResult:
    """Per granularity: assignments over the dataset, normalized centroids,
    per-cluster temperature vector. Mirrors the reference dict
    {'emb2cluster', 'centroids', 'density'}."""

    emb2cluster: List[torch.Tensor]
    centroids: List[torch.Tensor]
    density: List[torch.Tensor]

    @property
    def num_granularities(self) -> int:
        return len(self.centroids)


def run_kmeans(
    embeddings,  # [N, D] corpus embeddings, numpy or a tensor
    num_clusters: Sequence[int],
    temperature: float,
    num_iters: int = 20,
    num_redo: int = 3,
    seed: int = 0,
    device=None,
) -> ClusterResult:
    """K-means at each granularity on ``device`` (by default the card),
    seeded ``seed + g`` for granularity g (reference ``run_kmeans``,
    ``src/contrastor/utils.py:50-105``)."""
    x = torch.as_tensor(embeddings, dtype=torch.float32, device=resolve_device(device))
    out = ClusterResult([], [], [])
    for g, k in enumerate(num_clusters):
        gen = torch.Generator(device=x.device).manual_seed(seed + g)
        centroids, assign, sq_d = kmeans_fit(gen, x, int(k), num_iters, num_redo)
        out.emb2cluster.append(assign)
        out.centroids.append(normalize_rows(centroids))
        out.density.append(phi_density(assign, sq_d, int(k), temperature))
    return out


def run_hierarchical(
    embeddings: np.ndarray,
    num_clusters: Sequence[int],
    temperature: float,
    device=None,
) -> ClusterResult:
    """Ward linkage once, then cuts at each granularity (reference
    ``run_hierarchical_clustering``, ``src/contrastor/utils.py:108-160``),
    on the host; the results go to ``device`` (by default the card)."""
    import scipy.cluster.hierarchy as sch

    device = resolve_device(device)
    x = np.asarray(embeddings, dtype=np.float64)
    link = sch.linkage(x, method="ward", metric="euclidean")

    out = ClusterResult([], [], [])
    for k in num_clusters:
        k = int(min(k, x.shape[0]))
        labels = sch.fcluster(link, k, criterion="maxclust") - 1
        kk = labels.max() + 1
        centroids = np.zeros((kk, x.shape[1]))
        counts = np.bincount(labels, minlength=kk).astype(np.float64)
        np.add.at(centroids, labels, x)
        centroids /= np.maximum(counts[:, None], 1.0)

        sq = np.sum((x - centroids[labels]) ** 2, axis=1)
        sqrt_sum = np.zeros(kk)
        np.add.at(sqrt_sum, labels, np.sqrt(sq))
        multi = counts > 1
        density = np.where(
            multi, (sqrt_sum / np.maximum(counts, 1.0)) / np.log(counts + 10.0), 0.0
        )
        if multi.any() and density.max() > 0:
            density = np.where(multi, density, density.max())
        else:
            # all-singleton (granularity >= corpus size) or zero spread:
            # the reference's singleton rule (max of multi densities) is
            # undefined here and zero temperatures would NaN the proto
            # loss — use a flat temperature instead
            density = np.ones(kk)
        density = np.clip(
            density, np.percentile(density, 10), np.percentile(density, 90)
        )
        density = temperature * density / max(density.mean(), 1e-12)

        cn = centroids / np.maximum(
            np.linalg.norm(centroids, axis=1, keepdims=True), 1e-12
        )
        out.emb2cluster.append(torch.as_tensor(labels.astype(np.int32), device=device))
        out.centroids.append(torch.as_tensor(cn.astype(np.float32), device=device))
        out.density.append(torch.as_tensor(density.astype(np.float32), device=device))
    return out
