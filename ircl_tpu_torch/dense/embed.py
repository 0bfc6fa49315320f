"""Corpus embedding sweep: batched text -> normalized embedding matrix.

Counterpart of ``ircl_tpu/dense/embed.py`` (the reference's
``extract_all_emb`` no-grad loop, ``src/contrastor/utils.py:11-25``): the
host tokenizes fixed-size batches, the device runs the embed function, and
the rows come back as one ``[M, D]`` float32 numpy array.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from ircl_tpu_torch.parallel.common import all_gather_rows
from ircl_tpu_torch.parallel.mesh import axis_rank, axis_size, check_mesh


def embed_corpus(
    embed_fn: Callable,
    params,
    featurizer,
    texts: Sequence[str],
    batch_size: int = 256,
    mesh=None,
) -> np.ndarray:
    """Embed a text corpus in fixed-size batches: the last batch is padded
    with ``""`` and its pad rows dropped, so every batch has one shape.

    One-deep pipeline: batch N+1 is tokenized and launched before batch N's
    rows are copied to the host, so host encoding overlaps device work
    (CUDA launches return before the device finishes).

    ``mesh``: shard each batch's rows over the mesh's first axis (data
    parallelism; ``batch_size`` must divide by the axis size). Each rank
    embeds its ``batch_size / W`` rows of every batch, the rows are
    all-gathered in rank order, and every rank returns the full array."""
    rows = slice(None)
    if mesh is not None:
        check_mesh(mesh)
        axis = mesh.mesh_dim_names[0]
        n_ranks = axis_size(mesh, axis)
        if batch_size % n_ranks:  # the reference asserts
            raise AssertionError((batch_size, n_ranks))
        part = batch_size // n_ranks
        lo = axis_rank(mesh, axis) * part
        rows = slice(lo, lo + part)
    out: List[np.ndarray] = []
    n = len(texts)
    pending = None  # (device result, real rows)
    for i in range(0, n, batch_size):
        chunk = list(texts[i : i + batch_size])
        pad = batch_size - len(chunk)
        if pad:
            chunk = chunk + [""] * pad
        ids, mask = featurizer.encode_host(chunk)
        emb = embed_fn(params, ids[rows], mask[rows])
        if mesh is not None:
            emb = torch.cat(all_gather_rows(emb, mesh, axis))
        if pending is not None:
            out.append(pending[0].cpu().numpy()[: pending[1]])
        pending = (emb, batch_size - pad)
    if pending is not None:
        out.append(pending[0].cpu().numpy()[: pending[1]])
    if not out:
        return np.empty((0, 0), np.float32)
    return np.concatenate(out, axis=0)
