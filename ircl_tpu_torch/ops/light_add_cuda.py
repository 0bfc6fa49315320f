"""Light-pool add + per-tile top-k: a CUDA kernel and its plain version.

Counterpart of ``ircl_tpu/ops/light_add_pallas.py``. The hybrid engine's
transposed heavy scores ``H_T [N_pad, B]`` take every light posting-pool
contribution

    H'[d, b] = H_T[d, b] + sum_p contribs[p, b] * (docs[p, b] == d)

and each d-tile emits its top-k, so only ``n_dt * k8`` candidates per
query reach the final top-k and ``H'`` is never written. On CUDA tensors
``light_add_topk_t`` launches ``csrc/light_add_topk.cu`` (see the note in
that file); on CPU tensors it runs ``light_add_topk_t_ref``. Both follow
the Pallas contract exactly, ties included: within a tile, equal scores go
to the largest row. ``H_T`` is read, never updated.
"""

from __future__ import annotations

import torch

_NEG = -3.4e38  # pad rows' score, as in the Pallas kernel


def _check_args(h_t, docs_t, contribs_t, k: int, d_tile: int) -> None:
    if h_t.dim() != 2 or docs_t.dim() != 2:
        raise ValueError(
            f"h_t must be [N_pad, B] and docs_t [P, B]; got "
            f"{tuple(h_t.shape)} and {tuple(docs_t.shape)}"
        )
    if contribs_t.shape != docs_t.shape or docs_t.shape[1] != h_t.shape[1]:
        raise ValueError(
            f"shapes disagree: h_t {tuple(h_t.shape)}, docs_t "
            f"{tuple(docs_t.shape)}, contribs_t {tuple(contribs_t.shape)}"
        )
    if (h_t.dtype, docs_t.dtype, contribs_t.dtype) != (
        torch.float32, torch.int32, torch.float32
    ):
        raise TypeError(
            f"expected float32/int32/float32, got {h_t.dtype}/"
            f"{docs_t.dtype}/{contribs_t.dtype}"
        )
    if not (h_t.device == docs_t.device == contribs_t.device):
        raise ValueError("h_t, docs_t and contribs_t lie on different devices")
    if not (
        h_t.is_contiguous() and docs_t.is_contiguous()
        and contribs_t.is_contiguous()
    ):
        raise ValueError("light_add_topk_t inputs must be contiguous")
    if d_tile <= 0 or d_tile % 8 or h_t.shape[0] % d_tile:
        raise ValueError(
            f"d_tile {d_tile} must be a positive multiple of 8 dividing "
            f"N_pad {h_t.shape[0]}"
        )
    if not 1 <= k <= d_tile:
        raise ValueError(f"k must be in [1, d_tile={d_tile}], got {k}")


def light_add_topk_t_ref(
    h_t: torch.Tensor,
    docs_t: torch.Tensor,
    contribs_t: torch.Tensor,
    k: int = 5,
    d_tile: int = 256,
):
    """Plain version. Adds the pools row by row of P (each row hits each
    column once, so the adds never collide), which is the Pallas sum order.
    A stable descending sort of each tile with its rows reversed gives equal
    scores to the largest row, the Pallas tie rule."""
    n_pad, B = h_t.shape
    n_dt = n_pad // d_tile
    k8 = -(-k // 8) * 8
    h = h_t.clone()
    cols = torch.arange(B, device=h.device)
    for p in range(docs_t.shape[0]):
        d = docs_t[p].long()
        ok = (d >= 0) & (d < n_pad)
        h[d[ok], cols[ok]] += contribs_t[p][ok]
    tiles = h.view(n_dt, d_tile, B).flip(1)
    s, pos = torch.sort(tiles, dim=1, descending=True, stable=True)
    rows = d_tile - 1 - pos[:, :k] + (
        torch.arange(n_dt, device=h.device) * d_tile
    )[:, None, None]
    out_s = torch.full((n_dt, k8, B), _NEG, dtype=torch.float32, device=h.device)
    out_i = torch.full((n_dt, k8, B), -1, dtype=torch.int32, device=h.device)
    out_s[:, :k] = s[:, :k]
    out_i[:, :k] = rows.to(torch.int32)
    return out_s.view(n_dt * k8, B), out_i.view(n_dt * k8, B)


def light_add_topk_t(
    h_t: torch.Tensor,  # [N_pad, B] f32 transposed heavy scores
    docs_t: torch.Tensor,  # [P, B] int32 pool docs, ascending along P
    contribs_t: torch.Tensor,  # [P, B] f32
    k: int = 5,
    b_tile: int = 128,
    d_tile: int = 256,
):
    """Fused light-add + per-tile top-k. Returns (scores [n_dt * k8, B],
    doc positions [n_dt * k8, B]): the top-k totals of every d-tile of
    ``d_tile`` rows, best first, then k8 - k pad rows (-3.4e38 / -1), with
    k8 = k rounded up to 8. Pool entries outside [0, N_pad) (the ranker's
    pads carry N_pad) add nothing. ``d_tile`` shapes the output and is
    honoured; ``b_tile`` is the Pallas batch tile, which the CUDA kernel
    does not have, and is ignored."""
    _check_args(h_t, docs_t, contribs_t, k, d_tile)
    if h_t.device.type == "cpu":
        return light_add_topk_t_ref(h_t, docs_t, contribs_t, k=k, d_tile=d_tile)
    if h_t.device.type != "cuda":
        raise ValueError(f"no light_add_topk_t kernel for device {h_t.device}")
    from ircl_tpu_torch.utils.kernel_build import load_kernels

    n_pad, B = h_t.shape
    n_dt = n_pad // d_tile
    if n_dt > 65535:
        raise ValueError(f"{n_dt} d-tiles exceed the kernel's grid (65535)")
    k8 = -(-k // 8) * 8
    kern = load_kernels()
    out_s = torch.empty((n_dt * k8, B), dtype=torch.float32, device=h_t.device)
    out_i = torch.empty((n_dt * k8, B), dtype=torch.int32, device=h_t.device)
    with torch.cuda.device(h_t.device):
        rc = kern.lib.ircl_light_add_topk(
            h_t.data_ptr(), docs_t.data_ptr(), contribs_t.data_ptr(),
            n_pad, B, docs_t.shape[0], d_tile, k,
            out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kern.check(rc, "light_add_topk_t launch")
    light_add_topk_t.launches += 1
    return out_s, out_i


light_add_topk_t.launches = 0
