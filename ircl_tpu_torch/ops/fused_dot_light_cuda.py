"""Heavy dot fused into the light add + tile top-k: a CUDA kernel and its
plain version.

Counterpart of the kernel that ``scripts/probe_fused_dot_light.py`` builds
(``_kernel`` / ``fused`` inside its ``main()``). The fused bucketed engine
writes the transposed scores ``H_T = M^T W`` ``[N_pad, B]`` to device memory
and ``light_add_topk_t`` reads them back; this kernel keeps them on chip.
The slab ``M [U, N_pad]`` and the query slab ``W [U, B]`` are split outside
into bf16 halves (``split_hi_lo``: ``hi = bf16(x)``, ``lo = bf16(x - hi)``,
nearest even), and per (d-tile, column):

    h  = mh^T wh + ml^T wh + mh^T wl        (three bf16 dots, fp32 sums)
    H' = h + the light pools                (as light_add_topk_t)

then the tile's top-k, with ``light_add_topk_t``'s outputs and tie rule.
On CUDA tensors ``fused_dot_light_topk`` launches ``csrc/fused_dot_light.cu``
(bf16 tensor-core products, see the note there); on CPU tensors it runs
``fused_dot_light_topk_ref``. A product of two bf16 values is exact in
fp32, so the two differ only in the order of the fp32 sums (the kernel
groups ``hi.hi + (lo.hi + hi.lo)``); both differ from the exact fp32 slab
product by the dropped ``lo.lo`` term, about 2^-16 of a score: the probe
holds itself to rtol 2e-5, atol 1e-5 against the fused engine, and so do
the tests.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ircl_tpu_torch.ops.light_add_cuda import light_add_topk_t_ref
from ircl_tpu_torch.ops.membership_cuda import scores_matmul
from ircl_tpu_torch.utils.precision import split_hi_lo  # noqa: F401  (re-exported)

_KERNEL_DOCS, _KERNEL_COLS, _KERNEL_UNION = 128, 64, 32  # fused_dot_light.cu's tiles


def _check_args(m_hi, m_lo, w_hi, w_lo, docs_t, contribs_t, k, d_tile):
    if m_hi.dim() != 2 or m_lo.shape != m_hi.shape:
        raise ValueError(
            f"m_hi and m_lo must both be [U, N_pad]; got {tuple(m_hi.shape)} "
            f"and {tuple(m_lo.shape)}"
        )
    if w_hi.dim() != 2 or w_lo.shape != w_hi.shape or w_hi.shape[0] != m_hi.shape[0]:
        raise ValueError(
            f"w_hi and w_lo must both be [U={m_hi.shape[0]}, B]; got "
            f"{tuple(w_hi.shape)} and {tuple(w_lo.shape)}"
        )
    if docs_t.dim() != 2 or contribs_t.shape != docs_t.shape or (
        docs_t.shape[1] != w_hi.shape[1]
    ):
        raise ValueError(
            f"docs_t and contribs_t must be [P, B={w_hi.shape[1]}]; got "
            f"{tuple(docs_t.shape)} and {tuple(contribs_t.shape)}"
        )
    tensors = (m_hi, m_lo, w_hi, w_lo, docs_t, contribs_t)
    bf = torch.bfloat16
    want = (bf, bf, bf, bf, torch.int32, torch.float32)
    if tuple(t.dtype for t in tensors) != want:
        raise TypeError(
            f"expected dtypes {want}, got {tuple(t.dtype for t in tensors)}"
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError("fused_dot_light_topk inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_dot_light_topk inputs must be contiguous")
    if d_tile <= 0 or d_tile % 8 or m_hi.shape[1] % d_tile:
        raise ValueError(
            f"d_tile {d_tile} must be a positive multiple of 8 dividing "
            f"N_pad {m_hi.shape[1]}"
        )
    if not 1 <= k <= d_tile:
        raise ValueError(f"k must be in [1, d_tile={d_tile}], got {k}")


def high3_scores_t_ref(m_hi, m_lo, w_hi, w_lo):
    """Plain heavy scores ``H_T [N_pad, B]``: the three dots as fp32 matrix
    products of the bf16 halves (TF32 off), summed in the probe kernel's
    order."""
    mh, ml = m_hi.to(torch.float32).T, m_lo.to(torch.float32).T
    wh, wl = w_hi.to(torch.float32), w_lo.to(torch.float32)
    h_t = scores_matmul(mh, wh)
    h_t += scores_matmul(ml, wh)
    h_t += scores_matmul(mh, wl)
    return h_t


def fused_dot_light_topk_ref(
    m_hi, m_lo, w_hi, w_lo, docs_t, contribs_t, k: int = 5, d_tile: int = 1024,
):
    """Plain version: ``high3_scores_t_ref``, then the plain light add and
    tile top-k."""
    h_t = high3_scores_t_ref(m_hi, m_lo, w_hi, w_lo)
    return light_add_topk_t_ref(h_t, docs_t, contribs_t, k=k, d_tile=d_tile)


def fused_dot_light_topk(
    m_hi: torch.Tensor,  # [U, N_pad] bf16 slab, high halves
    m_lo: torch.Tensor,  # [U, N_pad] bf16 low halves
    w_hi: torch.Tensor,  # [U, B] bf16 query slab, high halves
    w_lo: torch.Tensor,  # [U, B] bf16
    docs_t: torch.Tensor,  # [P, B] int32 pool docs, ascending along P
    contribs_t: torch.Tensor,  # [P, B] f32
    k: int = 5,
    b_tile: int = 128,
    d_tile: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused high3 dot + light add + per-tile top-k. Returns (scores
    [n_dt * k8, B], doc positions [n_dt * k8, B]) as ``light_add_topk_t``
    does. ``d_tile`` shapes the output and is honoured; ``b_tile`` is the
    Pallas batch tile, which the CUDA kernel does not have, and is ignored.
    The kernel takes d_tile % 128 == 0 and B % 64 == 0; a union that is not
    a multiple of 32 is padded with zero rows here."""
    _check_args(m_hi, m_lo, w_hi, w_lo, docs_t, contribs_t, k, d_tile)
    if m_hi.device.type == "cpu":
        return fused_dot_light_topk_ref(
            m_hi, m_lo, w_hi, w_lo, docs_t, contribs_t, k=k, d_tile=d_tile
        )
    if m_hi.device.type != "cuda":
        raise ValueError(f"no fused dot + light add kernel for device {m_hi.device}")
    from ircl_tpu_torch.utils.kernel_build import load_kernels

    U, n = m_hi.shape
    B = w_hi.shape[1]
    n_dt = n // d_tile
    if d_tile % _KERNEL_DOCS or B % _KERNEL_COLS:
        raise ValueError(
            f"the kernel needs d_tile % {_KERNEL_DOCS} == 0 and B % "
            f"{_KERNEL_COLS} == 0, got d_tile={d_tile}, B={B}"
        )
    if n_dt > 65535:
        raise ValueError(f"{n_dt} d-tiles exceed the kernel's grid (65535)")
    if U == 0 or U % _KERNEL_UNION:
        extra = max(_KERNEL_UNION, -(-U // _KERNEL_UNION) * _KERNEL_UNION) - U
        rows = (0, 0, 0, extra)  # zero union rows add nothing
        m_hi, m_lo, w_hi, w_lo = (
            torch.nn.functional.pad(t, rows) for t in (m_hi, m_lo, w_hi, w_lo)
        )
        U += extra
    k8 = -(-k // 8) * 8
    kern = load_kernels()
    out_s = torch.empty((n_dt * k8, B), dtype=torch.float32, device=m_hi.device)
    out_i = torch.empty((n_dt * k8, B), dtype=torch.int32, device=m_hi.device)
    with torch.cuda.device(m_hi.device):
        rc = kern.lib.ircl_fused_dot_light(
            m_hi.data_ptr(), m_lo.data_ptr(), U, n, w_hi.data_ptr(),
            w_lo.data_ptr(), B, docs_t.data_ptr(), contribs_t.data_ptr(),
            docs_t.shape[0], d_tile, k, out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kern.check(rc, "fused_dot_light_topk launch")
    fused_dot_light_topk.launches += 1
    return out_s, out_i


fused_dot_light_topk.launches = 0
