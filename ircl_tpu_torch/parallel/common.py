"""Shared building blocks of the corpus-sharded scorers, and the collectives of
the model-parallel paths.

Counterpart of ``ircl_tpu/parallel/common.py``. ``ShardedEllIndex``,
``ShardedHybridIndex`` and the sharded dense scorer share one layout and one
merge: doc-major ELL transposed to ``[K, N]``, K padded to 8 and N to
``shards * 256``, each rank keeping its own column block; then a local top-k
whose (scores, global ids) are all-gathered over the axis's group and
re-top-k'd on every rank. Below them: the autograd Functions of tensor,
sequence and expert parallelism, and the point-to-point transfers of
pipeline and context parallelism.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ircl_tpu_torch.parallel.mesh import axis_rank, axis_size, mesh_device


def pad_and_shard_ell_t(ell_terms, ell_vals, mesh, axis: str):
    """``[N, K]`` ELL -> this rank's block of the transposed
    ``[K_pad, N_pad]`` arrays, on its device. Returns ``(terms_t, vals_t,
    rows_per_shard)``. K pads to 8 with -1 terms; N pads to
    ``shards * 256`` with empty docs."""
    n_shards = axis_size(mesh, axis)
    terms_t = np.ascontiguousarray(ell_terms.T)  # [K, N]
    vals_t = np.ascontiguousarray(ell_vals.T)
    k_w, n = terms_t.shape
    k_pad = -(-k_w // 8) * 8 - k_w
    chunk = n_shards * 256
    n_pad = -(-n // chunk) * chunk - n
    terms_t = np.pad(terms_t, ((0, k_pad), (0, n_pad)), constant_values=-1)
    vals_t = np.pad(vals_t, ((0, k_pad), (0, n_pad)), constant_values=0.0)
    rows = terms_t.shape[1] // n_shards
    lo = axis_rank(mesh, axis) * rows
    cols = slice(lo, lo + rows)
    dev = mesh_device(mesh)
    return (
        torch.tensor(np.ascontiguousarray(terms_t[:, cols]), device=dev),
        torch.tensor(np.ascontiguousarray(vals_t[:, cols]), device=dev),
        rows,
    )


def all_gather_rows(x: torch.Tensor, mesh, axis: str) -> list:
    """Every rank's ``x`` along ``axis``, in rank order (``x``'s shape on
    every rank)."""
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(axis))
    return parts


def gather_data_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every ``data`` rank's rows of ``x``, in rank order (``x`` itself
    without a mesh, or without a data axis of more than one rank)."""
    if mesh is None or "data" not in (mesh.mesh_dim_names or ()) or (
            axis_size(mesh, "data") == 1):
        return x
    return torch.cat(all_gather_rows(x.detach(), mesh, "data"))


def replicate(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The axis's first rank's ``x``, on every rank, in a new tensor of
    ``x``'s strides (the collectives take contiguous tensors; a layout can
    change which kernel a product takes, and so its bits)."""
    buf = x.clone(memory_format=torch.contiguous_format)
    src = int(mesh[axis].mesh.flatten()[0])  # the axis's first rank, globally
    dist.broadcast(buf, src=src, group=mesh.get_group(axis))
    return buf if x.is_contiguous() else torch.empty_like(x).copy_(buf)


def gather_topk_merge(s: torch.Tensor, gids: torch.Tensor, k: int, mesh, axis: str):
    """Merge the ranks' local top-k: all-gather the small ``[B, kk]``
    (scores, global ids), then one narrow top-k. Each row's candidates lie
    shard-major, as the reference's ``moveaxis(0, 1).reshape`` lays them,
    so ties meet the top-k in the same order."""
    b = s.shape[0]
    all_s = torch.stack(all_gather_rows(s, mesh, axis), dim=1).reshape(b, -1)
    all_i = torch.stack(all_gather_rows(gids, mesh, axis), dim=1).reshape(b, -1)
    ms, midx = torch.topk(all_s, min(k, all_s.shape[1]), dim=1)
    return ms, torch.gather(all_i, 1, midx)


# ---- the collectives of tensor, sequence and expert parallelism ---------------
#
# The reference's GSPMD (and shard_map's transpose rules) place the backward
# collective of every forward one; here each pair is one autograd Function,
# Megatron-LM's f and g and their sequence-parallel forms. ``groups`` is a
# tuple of process groups, reduced over one after another (a sum over the
# product of the axes); a caller passes only groups of more than one rank.


def _all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    for group in groups:
        dist.all_reduce(out, group=group)
    return out


def _all_gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _own_rows(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    return x.chunk(n, dim=1)[dist.get_rank(group)].contiguous()


def _reduce_scatter_seq(x: torch.Tensor, group) -> torch.Tensor:
    chunks = [c.contiguous() for c in x.chunk(dist.get_world_size(group), dim=1)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


class _CopyToGroup(torch.autograd.Function):
    """f: the identity forward; the gradient all-reduced over ``groups``."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups), None


class _ReduceFromGroup(torch.autograd.Function):
    """g: the all-reduce forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterSeq(torch.autograd.Function):
    """This rank's rows along dim 1 of a replicated tensor; the gradient
    all-gathered, so every rank holds the whole one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_seq(g, ctx.group), None


class _GatherSeq(torch.autograd.Function):
    """The all-gather along dim 1 of the ranks' rows. ``reduce_grad``: the
    gradient is a partial sum on each rank (it fed column-parallel products)
    and is reduce-scattered; otherwise it is whole on every rank and this
    rank keeps its rows."""

    @staticmethod
    def forward(ctx, x, group, reduce_grad):
        ctx.group, ctx.reduce_grad = group, reduce_grad
        return _all_gather_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            return _reduce_scatter_seq(g, ctx.group), None, None
        return _own_rows(g, ctx.group), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    """The reduce-scatter along dim 1 of a row-parallel product's partial
    sums; the gradient all-gathered."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_seq(g, ctx.group), None


def copy_to_group(x: torch.Tensor, groups) -> torch.Tensor:
    """Megatron's f, on the replicated input of a column-parallel product:
    ``x`` itself; its gradient, a partial sum on each rank, summed over
    ``groups``. ``x`` unchanged where there is no group."""
    return _CopyToGroup.apply(x, tuple(groups)) if groups else x


def reduce_from_group(x: torch.Tensor, groups) -> torch.Tensor:
    """Megatron's g, on a row-parallel product's partial sums: their sum
    over ``groups``, with the gradient passed through (it is whole on every
    rank). ``x`` unchanged where there is no group."""
    return _ReduceFromGroup.apply(x, tuple(groups)) if groups else x


def scatter_seq(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of rows along dim 1 of a replicated ``x``."""
    return _ScatterSeq.apply(x, group)


def gather_seq(x: torch.Tensor, group, reduce_grad: bool = True) -> torch.Tensor:
    """The ranks' blocks of rows along dim 1, all-gathered in rank order."""
    return _GatherSeq.apply(x, group, reduce_grad)


def reduce_scatter_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of ``x``, each rank keeping its block of rows
    along dim 1."""
    return _ReduceScatterSeq.apply(x, group)


# ---- the point-to-point transfers of pipeline and context parallelism ----------
#
# Peers are named by their rank within ``group``. gloo's send and recv hand
# the tensor's pointer to its host transport, so on gloo a CUDA tensor goes
# through host memory (several gloo ranks sharing one card); NCCL takes the
# CUDA tensor itself. Any other failure raises as it comes.


def _through_host(device, group) -> bool:
    return torch.device(device).type != "cpu" and dist.get_backend(group) == "gloo"


def isend_to(t: torch.Tensor, dst: int, group):
    """Start sending ``t`` to rank ``dst`` of ``group``; wait on the result
    (``wait_sends``) before the send's buffer may go."""
    buf = t.detach().contiguous()
    if _through_host(buf.device, group):
        buf = buf.cpu()
    return dist.isend(buf, dist.get_global_rank(group, dst), group=group), buf


def wait_sends(sends) -> None:
    for work, _ in sends:
        work.wait()


def recv_from(shape, dtype, device, src: int, group) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` received from rank ``src`` of
    ``group``, on ``device``."""
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if _through_host(device, group) else device)
    dist.recv(buf, dist.get_global_rank(group, src), group=group)
    return buf.to(device)


def shift(tensors, dst: int, src: int, group):
    """One hop of a ring: ``tensors`` packed into one buffer and sent to rank
    ``dst`` of ``group`` while the same shapes and dtypes are received from
    rank ``src`` (``dist.batch_isend_irecv``); the received tensors."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    flat = torch.cat([t.detach().reshape(-1).to(dt) for t in tensors])
    device = flat.device
    if _through_host(device, group):
        flat = flat.cpu()
    got = torch.empty_like(flat)
    ops = [dist.P2POp(dist.isend, flat, dist.get_global_rank(group, dst), group),
           dist.P2POp(dist.irecv, got, dist.get_global_rank(group, src), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    parts = torch.split(got.to(device), [t.numel() for t in tensors])
    return [p.view(t.shape).to(t.dtype) for p, t in zip(parts, tensors)]
