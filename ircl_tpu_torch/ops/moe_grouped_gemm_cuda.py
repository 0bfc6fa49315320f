"""Grouped expert GEMM of the dropless MoE: a CUDA kernel and its plain version.

The routed rows of a layer lie sorted by expert in one buffer ``x [R, K]``
(bf16), expert ``e`` owning rows ``offsets[e] .. offsets[e + 1] - 1``
(``offsets [E + 1]`` int32, on the device of ``x``), and each expert's rows
are multiplied by its weight ``w[e] [N, K]`` (bf16, a Linear layer's
``[out, in]``): bf16 operands, f32 sums, the output rounded to bf16. With
``swiglu`` the weight holds an expert's gate and up rows interleaved by
eights (``interleave_gate_up``) and the output is the published model's
``act_fn(gate_proj(x)) * up_proj(x)``, each of the three rounded to bf16,
``[R, N / 2]``.

On CUDA tensors ``grouped_gemm`` launches ``csrc/moe_grouped_gemm.cu``,
which reads the offsets from device memory: nothing here waits for the
card. Rows at or past ``offsets[E]`` are left unwritten there (zero in the
plain version); the caller never reads them. On CPU tensors it runs
``grouped_gemm_ref``, a loop over the experts. ``grouped_gemm.launches``
counts the kernel's launches. ``tile_schedule`` is the kernel's mapping of
its linear tile index to (expert, rows, first column), written out for the
CPU tests.
"""

from __future__ import annotations

import bisect

import torch
import torch.nn.functional as F

_BF16 = torch.bfloat16


def interleave_gate_up(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``[..., I, K]`` gate and up weights as one ``[..., 2I, K]``: rows
    ``16j .. 16j + 7`` are gate rows ``8j .. 8j + 7`` and the next eight
    the up rows of the same columns (``I`` a multiple of 8)."""
    *lead, i, k = gate.shape
    if i % 8:
        raise ValueError(f"the expert width {i} must be a multiple of 8")
    pair = torch.stack([gate.reshape(*lead, i // 8, 8, k), up.reshape(*lead, i // 8, 8, k)],
                       dim=-3)
    return pair.reshape(*lead, 2 * i, k)


def swiglu_interleaved(z: torch.Tensor) -> torch.Tensor:
    """bf16 ``silu(g) * u`` of a ``[rows, 2I]`` product by interleaved gate
    and up rows, each step rounded to bf16 as the published model's bf16
    tensors round it: ``[rows, I]``."""
    rows, n = z.shape
    gu = z.to(_BF16).reshape(rows, n // 16, 2, 8)
    g, u = gu[:, :, 0].reshape(rows, n // 2), gu[:, :, 1].reshape(rows, n // 2)
    return F.silu(g) * u


TILE_ROWS = 128  # the kernel's rows a tile


def tile_width(n: int) -> int:
    """The kernel's columns a tile: 256 where they divide ``n``, else 128."""
    return 256 if n % 256 == 0 else 128


def tile_schedule(offsets, n: int, block: int = 0, grid: int = 1) -> list:
    """``(expert, row0, row1, n0)`` of the output tiles that block ``block``
    of ``grid`` computes, in its order: tile ``t`` is the ``t // (n /
    tile_width(n))``-th tile of 128 rows over the experts' runs (expert
    ``e``'s tiles after those of the experts before it), columns fastest,
    and the block takes ``t = block, block + grid, ...``. ``row1`` is the
    end of the rows that the tile writes: at most 128 past ``row0`` and never
    past its expert's last row. The default walks every tile once."""
    off = [int(v) for v in offsets]
    bn = tile_width(n)
    n_cols = n // bn
    tiles = [0]  # tiles[e]: the tiles of rows of the experts before e
    for lo, hi in zip(off, off[1:]):
        tiles.append(tiles[-1] + max(0, hi - lo + TILE_ROWS - 1) // TILE_ROWS)
    out = []
    for t in range(block, tiles[-1] * n_cols, grid):
        rt, col = divmod(t, n_cols)
        e = bisect.bisect_right(tiles, rt) - 1
        row0 = off[e] + (rt - tiles[e]) * TILE_ROWS
        out.append((e, row0, min(off[e + 1], row0 + TILE_ROWS), col * bn))
    return out


def _check(x, w, offsets, swiglu):
    if x.dim() != 2 or w.dim() != 3 or offsets.dim() != 1:
        raise ValueError(f"expected x [R, K], w [E, N, K] and offsets [E + 1]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(offsets.shape)}")
    E, N, K = w.shape
    if x.shape[1] != K or offsets.shape[0] != E + 1:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"offsets {tuple(offsets.shape)}")
    if (x.dtype, w.dtype, offsets.dtype) != (_BF16, _BF16, torch.int32):
        raise TypeError(f"expected bfloat16/bfloat16/int32, got {x.dtype}/{w.dtype}/"
                        f"{offsets.dtype}")
    if not (x.device == w.device == offsets.device):
        raise ValueError("x, w and offsets lie on different devices")
    if not (x.is_contiguous() and w.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("grouped_gemm inputs must be contiguous")
    if swiglu and N % 16:
        raise ValueError(f"an interleaved gate and up weight has 16j rows, got {N}")


def grouped_gemm_ref(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                     swiglu: bool = False) -> torch.Tensor:
    """Plain version: each expert's rows times its weight in f32, rounded to
    bf16 (then ``swiglu_interleaved``); rows past ``offsets[E]`` are zero."""
    E, N, _ = w.shape
    out = torch.zeros((x.shape[0], N // 2 if swiglu else N), dtype=_BF16, device=x.device)
    off = offsets.tolist()
    for e in range(E):
        lo, hi = off[e], off[e + 1]
        if hi > lo:
            z = (x[lo:hi].float() @ w[e].float().T).to(_BF16)
            out[lo:hi] = swiglu_interleaved(z) if swiglu else z
    return out


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                 swiglu: bool = False) -> torch.Tensor:
    """``y [R, N]`` (``[R, N / 2]`` with ``swiglu``): row ``r`` of ``x``
    times ``w[e]^T`` for the expert ``e`` whose run of rows holds it."""
    _check(x, w, offsets, swiglu)
    if x.device.type == "cpu":
        return grouped_gemm_ref(x, w, offsets, swiglu)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped_gemm kernel for device {x.device}")
    E, N, K = w.shape
    if K % 64 or N % 128:
        raise ValueError(f"the kernel takes K a multiple of 64 and N of 128, got K={K}, N={N}")
    from ircl_tpu_torch.utils.kernel_build import load_kernels

    R = x.shape[0]
    kern = load_kernels()
    y = torch.empty((R, N // 2 if swiglu else N), dtype=_BF16, device=x.device)
    with torch.cuda.device(x.device):
        rc = kern.lib.ircl_moe_grouped_gemm(
            x.data_ptr(), w.data_ptr(), offsets.data_ptr(), E, R, K, N, int(swiglu),
            y.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    kern.check(rc, "grouped_gemm launch")
    grouped_gemm.launches += 1
    return y


grouped_gemm.launches = 0
