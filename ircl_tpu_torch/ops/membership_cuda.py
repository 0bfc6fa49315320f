"""Membership slab for the sparse index: a CUDA kernel and its plain version.

Counterpart of ``ircl_tpu/ops/membership_pallas.py``. For a query batch
whose union of terms is ``u_sorted``:

    M[u, d]  = sum_k vals[d, k] * (terms[d, k] == u_sorted[u])   (index slab)
    Wt[u, b] = sum_t qw[b, t]   * (qb[b, t]    == u_sorted[u])   (query slab)
    scores   = Wt^T @ M

``membership_slab`` and ``membership_slab_windowed`` keep the Pallas
functions' arguments and k-major ``[K, N]`` layouts. On CUDA tensors both
launch ``csrc/membership_slab.cu``, which resolves each term to its slab
rows once instead of comparing every cell and writes every cell once (see
the note in that file); on CPU tensors both run ``membership_slab_ref``,
the compare loop of the contract. The three agree bit for bit.
``membership_slab_windowed`` also takes ``out=`` and ``col_offset=``,
keyword-only, to fill a column range of a larger buffer
(``ops/hybrid.py::_bucketed_membership``).
``membership_topk_fused`` is the ELL engine's
top-k over the two slabs.
"""

from __future__ import annotations

import numpy as np
import torch

from ircl_tpu_torch.utils.precision import float32_precision


def _check_slab_args(u_sorted, terms_t, contrib_t) -> None:
    if u_sorted.dim() != 1 or terms_t.dim() != 2:
        raise ValueError(
            f"u_sorted must be [U] and terms_t [K, N]; got "
            f"{tuple(u_sorted.shape)} and {tuple(terms_t.shape)}"
        )
    if contrib_t.shape != terms_t.shape:
        raise ValueError(
            f"contrib_t {tuple(contrib_t.shape)} does not match terms_t "
            f"{tuple(terms_t.shape)}"
        )
    if (u_sorted.dtype, terms_t.dtype, contrib_t.dtype) != (
        torch.int32, torch.int32, torch.float32
    ):
        raise TypeError(
            f"expected int32/int32/float32, got {u_sorted.dtype}/"
            f"{terms_t.dtype}/{contrib_t.dtype}"
        )
    if not (u_sorted.device == terms_t.device == contrib_t.device):
        raise ValueError("u_sorted, terms_t and contrib_t lie on different devices")
    if not (
        u_sorted.is_contiguous()
        and terms_t.is_contiguous()
        and contrib_t.is_contiguous()
    ):
        raise ValueError("membership slab inputs must be contiguous")


def membership_slab_ref(
    u_sorted: torch.Tensor, terms_t: torch.Tensor, contrib_t: torch.Tensor
) -> torch.Tensor:
    """Plain version: the compare contract, one ``[U, N]`` compare per k,
    accumulated in k order (the Pallas loop's order)."""
    m = torch.zeros(
        (u_sorted.shape[0], terms_t.shape[1]),
        dtype=torch.float32, device=terms_t.device,
    )
    for k in range(terms_t.shape[0]):
        eq = terms_t[k][None, :] == u_sorted[:, None]
        m += torch.where(eq, contrib_t[k][None, :], 0.0)
    return m


def _check_out(out, col_offset, u_sorted, terms_t) -> None:
    """``out`` takes the slab in its columns [col_offset, col_offset + N)."""
    if out is None:
        if col_offset:
            raise ValueError("col_offset needs out=")
        return
    n = terms_t.shape[1]
    if out.dim() != 2 or out.shape[0] != u_sorted.shape[0]:
        raise ValueError(
            f"out must be [U={u_sorted.shape[0]}, >= N]; got {tuple(out.shape)}"
        )
    if not 0 <= col_offset <= out.shape[1] - n:
        raise ValueError(
            f"columns [{col_offset}, {col_offset + n}) do not fit out's "
            f"{out.shape[1]}"
        )
    if out.dtype != torch.float32:
        raise TypeError(f"out must be float32, got {out.dtype}")
    if out.device != u_sorted.device:
        raise ValueError("out lies on another device than the slab's inputs")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")


_MAX_ROW_CHUNKS = 65535  # the kernel's grid.y splits U into chunks of 64 rows


def _check_slab_geometry(u_sorted, terms_t) -> None:
    """Raise on what the CUDA kernel cannot take (the plain version takes
    it all): a union of more than 65535 chunks of 64 rows, or more than
    2^31 - 1 blocks of 128 docs."""
    if -(-u_sorted.shape[0] // 64) > _MAX_ROW_CHUNKS:
        raise ValueError(
            f"a union of {u_sorted.shape[0]} slots exceeds the kernel's "
            f"{64 * _MAX_ROW_CHUNKS}"
        )
    if -(-terms_t.shape[1] // 128) >= 2**31:
        raise ValueError(f"{terms_t.shape[1]} docs exceed the kernel's grid")


def _slab(fn, u_sorted, terms_t, contrib_t, out=None, col_offset=0):
    """The slab on CPU tensors (plain version) or from the CUDA entry point
    ``ircl_membership_slab``, counted as a launch of ``fn``, returned as
    ``out``'s columns [col_offset, col_offset + N) when ``out`` is given."""
    _check_slab_args(u_sorted, terms_t, contrib_t)
    _check_out(out, col_offset, u_sorted, terms_t)
    n = terms_t.shape[1]
    if u_sorted.device.type == "cpu":
        slab = membership_slab_ref(u_sorted, terms_t, contrib_t)
        if out is None:
            return slab
        out[:, col_offset : col_offset + n] = slab
        return out[:, col_offset : col_offset + n]
    if u_sorted.device.type != "cuda":
        raise ValueError(f"no membership slab kernel for device {u_sorted.device}")
    _check_slab_geometry(u_sorted, terms_t)
    from ircl_tpu_torch.utils.kernel_build import load_kernels

    kern = load_kernels()
    if out is None:  # every cell is written: no zero pass
        out = torch.empty(
            (u_sorted.shape[0], n), dtype=torch.float32, device=u_sorted.device
        )
    with torch.cuda.device(u_sorted.device):
        rc = kern.lib.ircl_membership_slab(
            u_sorted.data_ptr(), u_sorted.shape[0],
            terms_t.data_ptr(), contrib_t.data_ptr(),
            terms_t.shape[0], n, out.data_ptr(), out.shape[1], col_offset,
            torch.cuda.current_stream().cuda_stream,
        )
    kern.check(rc, "membership slab launch")
    fn.launches += 1
    return out[:, col_offset : col_offset + n]


def membership_slab(
    u_sorted: torch.Tensor,  # [U] int32 sorted union ids, sentinel-padded
    terms_t: torch.Tensor,  # [K, N] int32 raw term ids (pad -1)
    contrib_t: torch.Tensor,  # [K, N] f32 values (0 on padding)
    u_tile: int = 512,
    d_tile: int = 256,
) -> torch.Tensor:
    """Dense slab M [U, N] (exact). ``u_tile`` and ``d_tile`` are the Pallas
    grid tiles; the CUDA kernel has no such tiles and ignores them, and it
    takes any U, N and K, in any order down a column. CPU tensors go to
    ``membership_slab_ref``."""
    return _slab(membership_slab, u_sorted, terms_t, contrib_t)


membership_slab.launches = 0


def membership_slab_windowed(
    u_sorted: torch.Tensor,  # [U] int32 sorted union ids (sentinel-padded)
    terms_t: torch.Tensor,  # [K, N] int32 raw term ids, ascending per doc,
    #                         pads (-1) trailing
    contrib_t: torch.Tensor,  # [K, N] f32
    u_tile: int = 512,
    d_tile: int = 256,
    *,
    out: torch.Tensor | None = None,  # [U, >= N] f32: write the slab into it
    col_offset: int = 0,  # at out's columns [col_offset, col_offset + N)
) -> torch.Tensor:
    """The slab of ``membership_slab`` for inputs whose columns ascend with
    pads trailing. The Pallas version cut each grid cell's k loop to a
    value window; the CUDA kernel is ``membership_slab``'s, which walks
    such a column's terms once with a cursor (it checks the order, so the
    slab is right for any input). Same tiles as ``membership_slab``; its
    own launch count, to mirror the reference's call sites. With ``out``
    the slab fills that buffer's columns [col_offset, col_offset + N),
    leaving the others as they are, and the view of those columns is
    returned."""
    return _slab(membership_slab_windowed, u_sorted, terms_t, contrib_t, out,
                 col_offset)


membership_slab_windowed.launches = 0


def pad_for_slab(terms_t, contrib_t, d_tile: int, k_multiple: int = 8):
    """Host-side padding of k-major numpy arrays to tile multiples (the
    reference's layout, kept so both packages see the same shapes)."""
    k_width, n = terms_t.shape
    k_pad = max(-(-k_width // k_multiple) * k_multiple, k_multiple) - k_width
    n_pad = max(-(-n // d_tile) * d_tile, d_tile) - n  # empty inputs pad to one tile
    if k_pad or n_pad:
        terms_t = np.pad(terms_t, ((0, k_pad), (0, n_pad)), constant_values=-1)
        contrib_t = np.pad(contrib_t, ((0, k_pad), (0, n_pad)), constant_values=0.0)
    return terms_t, contrib_t


def scores_matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool = False):
    """The scoring GEMM ``a @ b``. Full fp32 unless ``tf32``, whatever the
    caller's global TF32 setting, so it cannot lower an exact engine's
    scores (``utils/precision.py``)."""
    with float32_precision(tf32):
        return torch.matmul(a, b)


def membership_topk_fused(
    terms_t: torch.Tensor,  # [K, N_pad] int32 doc terms (pre-padded, -1)
    vals_t: torch.Tensor,  # [K, N_pad] f32
    u_sorted: torch.Tensor,  # [U] int32 union slots, sentinel-padded
    qb_t: torch.Tensor,  # [T8, B_pad] int32 query buckets (pre-padded)
    qw_t: torch.Tensor,  # [T8, B_pad] f32 query weights (0 on padding)
    k: int,
    num_real_docs: int,
):
    """Exact top-k over the ELL index: (scores [B_pad, k], ids [B_pad, k]);
    padded queries yield empty rows. Rows with score <= 0 or id >=
    ``num_real_docs`` are empty: (0, -1). Equal scores may come back in
    another order than ``lax.top_k``'s (lowest index first)."""
    u_tile = min(512, u_sorted.shape[0])
    m = membership_slab(u_sorted, terms_t, vals_t, u_tile=u_tile, d_tile=256)
    wt = membership_slab(u_sorted, qb_t, qw_t, u_tile=u_tile, d_tile=128)
    scores = scores_matmul(wt.T, m)  # [B_pad, N_pad], full fp32
    kk = min(k, scores.shape[1])
    top_s, top_i = torch.topk(scores, kk, dim=1)
    empty = (top_s <= 0.0) | (top_i >= num_real_docs)
    return (
        torch.where(empty, 0.0, top_s),
        torch.where(empty, -1, top_i.to(torch.int32)),
    )
