"""One-pass fused hybrid scoring: a CUDA kernel and its plain version.

Counterpart of ``ircl_tpu/ops/fused_hybrid_pallas.py``, the engine for
corpora whose slab ``M [U, N]`` and scores ``H [B, N]`` should not be
materialized. Per (d-tile, column) of one ELL width bucket:

    h[d, b]  = sum_k vals[k, d] * sum_{u: u_sorted[u] == terms[k, d]} wt[u, b]
    H'[d, b] = h[d, b] + sum_p contribs[p, b] * (docs[p, b] == base + d)

and only the tile's top-k (score, global position ``base + d``) leave the
kernel. On CUDA tensors ``fused_hybrid_tile_topk`` launches
``csrc/fused_hybrid.cu``, which searches each d-tile's terms once and
gathers the rows of ``wt`` they hit instead of rebuilding the slab tile
(see the note there); on CPU tensors it runs
``fused_hybrid_tile_topk_ref``: the plain slab, an fp32 product, and the
plain light add. Kernel and plain version sum a doc's
terms in the same (ascending slot) order as fp32 FMAs; against a library
GEMM's blocked sums they agree to rtol 1e-5, ids except across exact ties.
``hybrid_topk_onepass`` runs both buckets and the final top-k. In the
reference this engine is a function that tests and probes call, not a
ranker mode, and so it is here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ircl_tpu_torch.ops.light_add_cuda import light_add_topk_t_ref
from ircl_tpu_torch.ops.membership_cuda import (
    membership_slab_ref,
    membership_slab_windowed,
    scores_matmul,
)

_KERNEL_DOCS = 32  # docs a chunk in fused_hybrid.cu
_MAX_STAGED_U = 4096  # a union up to this many slots is staged in shared memory
_MAX_SHARED = 227 * 1024  # bytes of shared memory a block may ask for


def _kernel_shared_bytes(k_width: int, u: int) -> int:
    """Shared memory of one block of ``csrc/fused_hybrid.cu``: the hits
    (slot, run, value) of a chunk's docs, their counts, the chunk's terms
    in rows padded by one, and the union when it is staged."""
    docs = _KERNEL_DOCS
    staged = u if u <= _MAX_STAGED_U else 0
    return 4 * (3 * k_width * docs + docs + k_width * (docs + 1) + staged)


def _check_kernel_geometry(terms_t, u_sorted, wt, d_tile: int, base: int) -> None:
    """Raise on what the CUDA kernel cannot take (the plain version takes
    it all): its chunk of 32 docs, its grid, its shared memory, 16-byte
    reads of ``wt`` rows, int32 positions."""
    k_width, n = terms_t.shape
    if d_tile % _KERNEL_DOCS:
        raise ValueError(f"the kernel needs d_tile % {_KERNEL_DOCS} == 0, got {d_tile}")
    if n // d_tile > 65535:
        raise ValueError(f"{n // d_tile} d-tiles exceed the kernel's grid (65535)")
    shared = _kernel_shared_bytes(k_width, u_sorted.shape[0])
    if shared > _MAX_SHARED:
        raise ValueError(
            f"ELL width {k_width} needs {shared} bytes of shared memory, past "
            f"the kernel's {_MAX_SHARED}"
        )
    if wt.shape[1] % 4 or wt.data_ptr() % 16:
        raise ValueError(
            f"the kernel reads wt rows 16 bytes at a time: B_pad {wt.shape[1]} "
            "must be a multiple of 4 and wt 16-byte aligned"
        )
    if u_sorted.shape[0] >= 2**31:
        raise ValueError(f"a union of {u_sorted.shape[0]} slots overflows int32")
    if base + n >= 2**31:
        raise ValueError(f"positions up to {base + n} overflow int32")


def _check_args(terms_t, vals_t, u_sorted, wt, docs_t, contribs_t, k, d_tile):
    if terms_t.dim() != 2 or vals_t.shape != terms_t.shape:
        raise ValueError(
            f"terms_t and vals_t must both be [K, N_pad]; got "
            f"{tuple(terms_t.shape)} and {tuple(vals_t.shape)}"
        )
    if u_sorted.dim() != 1 or wt.dim() != 2 or wt.shape[0] != u_sorted.shape[0]:
        raise ValueError(
            f"u_sorted must be [U] and wt [U, B_pad]; got "
            f"{tuple(u_sorted.shape)} and {tuple(wt.shape)}"
        )
    if docs_t.dim() != 2 or contribs_t.shape != docs_t.shape or (
        docs_t.shape[1] != wt.shape[1]
    ):
        raise ValueError(
            f"docs_t and contribs_t must be [P, B_pad={wt.shape[1]}]; got "
            f"{tuple(docs_t.shape)} and {tuple(contribs_t.shape)}"
        )
    tensors = (terms_t, vals_t, u_sorted, wt, docs_t, contribs_t)
    want = (torch.int32, torch.float32, torch.int32, torch.float32,
            torch.int32, torch.float32)
    if tuple(t.dtype for t in tensors) != want:
        raise TypeError(
            f"expected dtypes {want}, got {tuple(t.dtype for t in tensors)}"
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError("fused_hybrid_tile_topk inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_hybrid_tile_topk inputs must be contiguous")
    if d_tile <= 0 or d_tile % 8 or terms_t.shape[1] % d_tile:
        raise ValueError(
            f"d_tile {d_tile} must be a positive multiple of 8 dividing "
            f"N_pad {terms_t.shape[1]}"
        )
    if not 1 <= k <= d_tile:
        raise ValueError(f"k must be in [1, d_tile={d_tile}], got {k}")


def fused_hybrid_tile_topk_ref(
    terms_t, vals_t, u_sorted, wt, docs_t, contribs_t,
    k: int = 5, d_tile: int = 1024, base: int = 0,
):
    """Plain version: the compare-contract slab, one fp32 product (TF32
    off), then the plain light add and tile top-k over pools shifted into
    the bucket's local rows."""
    n = terms_t.shape[1]
    m = membership_slab_ref(u_sorted, terms_t, vals_t)  # [U, N_pad]
    h_t = scores_matmul(m.T, wt).contiguous()  # [N_pad, B_pad]
    local = docs_t.long() - base
    inside = (local >= 0) & (local < n)
    local = torch.where(inside, local, n).to(torch.int32)  # n: in no tile
    s, pos = light_add_topk_t_ref(h_t, local, contribs_t, k=k, d_tile=d_tile)
    return s, torch.where(pos >= 0, pos + base, pos)


def fused_hybrid_tile_topk(
    terms_t: torch.Tensor,  # [K, N_pad] int32 ELL terms (ascending, pad -1)
    vals_t: torch.Tensor,  # [K, N_pad] f32
    u_sorted: torch.Tensor,  # [U] int32 union, ascending (sentinel pad)
    wt: torch.Tensor,  # [U, B_pad] f32 query slab
    docs_t: torch.Tensor,  # [P, B_pad] int32 pools (ascending along P; pads
    #                        carry out-of-range positions)
    contribs_t: torch.Tensor,  # [P, B_pad] f32
    k: int = 5,
    u_tile: int = 512,
    d_tile: int = 1024,
    b_tile: int = 1024,
    base: int = 0,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile top-k of (heavy + light) scores over one ELL bucket whose
    docs occupy global positions [base, base + N_pad). Returns (scores
    [n_dt * k8, B_pad], positions [n_dt * k8, B_pad]): every d-tile's top-k
    totals best first, then k8 - k pad rows (-3.4e38 / -1), ties inside a
    tile to the largest position. ``d_tile`` shapes the output and is
    honoured; ``u_tile`` and ``b_tile`` are the Pallas grid's tiles, which
    the CUDA kernel does not have, and are ignored. ``precision`` is checked
    and otherwise ignored: the kernel sums in fp32 whatever it names."""
    from ircl_tpu_torch.ops.hybrid import _PREC

    _PREC[precision]
    _check_args(terms_t, vals_t, u_sorted, wt, docs_t, contribs_t, k, d_tile)
    if terms_t.device.type == "cpu":
        return fused_hybrid_tile_topk_ref(
            terms_t, vals_t, u_sorted, wt, docs_t, contribs_t,
            k=k, d_tile=d_tile, base=base,
        )
    if terms_t.device.type != "cuda":
        raise ValueError(f"no fused hybrid kernel for device {terms_t.device}")
    from ircl_tpu_torch.utils.kernel_build import load_kernels

    _check_kernel_geometry(terms_t, u_sorted, wt, d_tile, base)
    k_width, n = terms_t.shape
    B = wt.shape[1]
    n_dt = n // d_tile
    k8 = -(-k // 8) * 8
    kern = load_kernels()
    out_s = torch.empty((n_dt * k8, B), dtype=torch.float32, device=wt.device)
    out_i = torch.empty((n_dt * k8, B), dtype=torch.int32, device=wt.device)
    with torch.cuda.device(wt.device):
        rc = kern.lib.ircl_fused_hybrid(
            terms_t.data_ptr(), vals_t.data_ptr(), k_width, n,
            u_sorted.data_ptr(), u_sorted.shape[0], wt.data_ptr(), B,
            docs_t.data_ptr(), contribs_t.data_ptr(), docs_t.shape[0],
            d_tile, base, k, out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kern.check(rc, "fused_hybrid_tile_topk launch")
    fused_hybrid_tile_topk.launches += 1
    return out_s, out_i


fused_hybrid_tile_topk.launches = 0


def hybrid_topk_onepass(
    terms_a: torch.Tensor,  # [K_a, Na_pad] narrow width bucket (k-major)
    vals_a: torch.Tensor,
    terms_b: torch.Tensor,  # [K_b, Nb_pad] wide bucket
    vals_b: torch.Tensor,
    u_sorted: torch.Tensor,  # [U] heavy union, sentinel-padded
    qb_t: torch.Tensor,  # [T8, B_pad] heavy query buckets, per-query ascending
    qw_t: torch.Tensor,  # [T8, B_pad]
    light_docs: torch.Tensor,  # [B, P] PERMUTED positions, ascending per row
    light_contribs: torch.Tensor,  # [B, P]
    k: int = 5,
    u_tile: int = 512,
    d_tile: int = 1024,
    b_tile: int = 1024,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a width-bucketed hybrid index without materializing
    slab or scores. Positions are in the permuted doc space
    [bucket_a | bucket_b]; callers map back through ``pos2old``. Query terms
    and light pools must be pre-sorted (the ranker's host prep does both)."""
    from ircl_tpu_torch.ops.hybrid import _u_tile

    pad = torch.nn.functional.pad
    B = light_docs.shape[0]
    b_pad = -(-B // b_tile) * b_tile
    qt = _u_tile(u_sorted.shape[0])
    wt = membership_slab_windowed(u_sorted, qb_t, qw_t, u_tile=qt, d_tile=128)
    if wt.shape[1] < b_pad:
        wt = pad(wt, (0, b_pad - wt.shape[1]))
    # the reference pads the union to u_tile granularity for its grid; the
    # CUDA kernel has no u-tiles and takes the union as it is
    wt = wt[:, :b_pad].contiguous()

    sd, sv = light_docs, light_contribs
    if b_pad != B:
        sd = pad(sd, (0, 0, 0, b_pad - B), value=2**31 - 1)
        sv = pad(sv, (0, 0, 0, b_pad - B))
    sd_t = sd.T.contiguous()
    sv_t = sv.T.contiguous()

    def fit_tile(n):
        # largest tile <= d_tile that divides the (256-multiple) bucket width
        for t in (d_tile, 512, 256):
            if t <= d_tile and n % t == 0:
                return t
        return 256

    na = terms_a.shape[1]
    kw = dict(k=k, u_tile=u_tile, b_tile=b_tile, precision=precision)
    sa, ia = fused_hybrid_tile_topk(
        terms_a, vals_a, u_sorted, wt, sd_t, sv_t,
        d_tile=fit_tile(na), base=0, **kw,
    )
    sb, ib = fused_hybrid_tile_topk(
        terms_b, vals_b, u_sorted, wt, sd_t, sv_t,
        d_tile=fit_tile(terms_b.shape[1]), base=na, **kw,
    )
    all_s = torch.cat([sa, sb], dim=0).T[:B]  # [B, cands]
    all_i = torch.cat([ia, ib], dim=0).T[:B]
    top_s, top_pos = torch.topk(all_s, min(k, all_s.shape[1]), dim=1)
    top_i = torch.gather(all_i, 1, top_pos)
    empty = top_s <= 0.0
    return (
        torch.where(empty, 0.0, top_s),
        torch.where(empty, -1, top_i),
    )
