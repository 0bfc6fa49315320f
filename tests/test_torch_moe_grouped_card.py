"""The grouped expert GEMM kernel (``csrc/moe_grouped_gemm.cu``) against its
plain version at the Moonlight cell's widths, and the MLA + MoE forward
without a device-to-host sync. These need the card and skip without one;
this file imports no JAX, so on the card's machine it runs alone:

    python3 -m pytest --noconftest -q tests/test_torch_moe_grouped_card.py
"""

from __future__ import annotations

import pytest
import torch

from ircl_tpu_torch.models import mla_moe
from ircl_tpu_torch.ops.moe_grouped_gemm_cuda import (
    grouped_gemm,
    grouped_gemm_ref,
    interleave_gate_up,
    swiglu_interleaved,
)
from ircl_tpu_torch.utils.precision import float32_precision
from ircl_tpu_torch.verdict.model import VerdictConfig, verdict_apply


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _uneven_offsets(E, rows, gen):
    """Offsets of ``rows`` rows over ``E`` experts: skewed counts, some
    experts empty, one with fewer rows than a tile."""
    w = torch.rand(E, generator=gen) ** 3
    w[[3, 17, 40]] = 0.0
    counts = torch.floor(w / w.sum() * rows).long()
    counts[5] = 37
    counts[0] += rows - int(counts.sum())
    return torch.cat([torch.zeros(1, dtype=torch.long), counts.cumsum(0)]).to(torch.int32)


def _within_rounding(got, a, w, offsets):
    """Each expert's product ``a w^T`` within half a bf16 unit of the exact
    (f64) sum, plus the f32 accumulation's error, bounded by 2^-11 of the sum
    of the terms' magnitudes: a wrong row or column is off by about the
    product itself, some 2^-6 of that sum at these widths."""
    off = offsets.tolist()
    for e in range(len(off) - 1):
        lo, hi = off[e], off[e + 1]
        if hi == lo:
            continue
        exact = a[lo:hi].double() @ w[e].double().T
        scale = a[lo:hi].double().abs() @ w[e].double().abs().T
        gap = (got[lo:hi].double() - exact).abs()
        assert bool((gap <= 2 ** -8 * exact.abs() + 2 ** -11 * scale).all()), (e, float(gap.max()))


@pytest.mark.card
def test_grouped_kernel_against_its_plain_version_at_the_cell_widths():
    dev = _card()
    E, H, I, R = 64, 2048, 1408, 20000
    gen = torch.Generator().manual_seed(0)
    offsets = _uneven_offsets(E, R - 300, gen).to(dev)  # 300 rows past the last expert
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(R, H, generator=g, device=dev).to(torch.bfloat16)
    gate = (0.02 * torch.randn(E, I, H, generator=g, device=dev)).to(torch.bfloat16)
    up = (0.02 * torch.randn(E, I, H, generator=g, device=dev)).to(torch.bfloat16)
    down = (0.02 * torch.randn(E, H, I, generator=g, device=dev)).to(torch.bfloat16)
    w13 = interleave_gate_up(gate, up).contiguous()
    before = grouped_gemm.launches
    raw = grouped_gemm(x, w13, offsets)  # the gate and up products as they are
    h = grouped_gemm(x, w13, offsets, swiglu=True)
    y = grouped_gemm(h, down, offsets)
    torch.cuda.synchronize()
    assert grouped_gemm.launches == before + 3
    end = int(offsets[-1])
    _within_rounding(raw, x, w13, offsets)
    _within_rounding(y, h, down, offsets)
    # the epilogue: silu(gate) * up of the kernel's own products, rounded as
    # bf16 tensors round (the card's silu may differ in the last f32 bit)
    want = swiglu_interleaved(raw[:end]).float()
    gap = (h[:end].float() - want).abs()
    assert bool((gap <= 2 ** -7 * want.abs()).all()) and float((gap > 0).float().mean()) < 1e-3
    # the plain version (the CPU path, here on the card) agrees as far as the
    # sums' order lets it: both within the bound, a rounding apart on few entries
    with float32_precision():
        plain = grouped_gemm_ref(x, w13, offsets)
    _within_rounding(plain, x, w13, offsets)
    assert float((raw[:end] != plain[:end]).float().mean()) < 0.01
    # twice the same bits: no atomics
    assert torch.equal(grouped_gemm(h, down, offsets)[:end], y[:end])


# name: (E, K, N, R, rows of each expert); rows past their sum stay unwritten
SHAPES = {
    # R off the 128-row tile, the last run ending at the buffer's end: the
    # TMA unit fills the last tile's rows past R with zeros
    "last_run_ends_at_an_unaligned_buffer_end": (4, 256, 512, 333, [100, 0, 200, 33]),
    "runs_start_mid_tile": (6, 128, 256, 800, [5, 130, 1, 257, 128, 127]),
    "every_row_on_one_expert": (1, 192, 768, 1000, [1000]),
    "one_expert_of_sixteen_has_rows": (16, 128, 256, 900, [0] * 9 + [700] + [0] * 6),
    "k_1408_wraps_the_ring_unevenly": (3, 1408, 256, 600, [300, 0, 211]),  # 22 k-steps
    "n_384_takes_the_narrow_tile": (4, 128, 384, 500, [64, 200, 0, 190]),
}


def _launch(x, w, offsets, swiglu, fill):
    """The C entry point into an output filled with ``fill`` beforehand."""
    from ircl_tpu_torch.utils.kernel_build import load_kernels

    E, N, K = w.shape
    y = torch.full((x.shape[0], N // 2 if swiglu else N), fill, dtype=torch.bfloat16,
                   device=x.device)
    kern = load_kernels()
    rc = kern.lib.ircl_moe_grouped_gemm(x.data_ptr(), w.data_ptr(), offsets.data_ptr(), E,
                                        x.shape[0], K, N, int(swiglu), y.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
    kern.check(rc, "grouped_gemm launch")
    return y


@pytest.mark.card
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_grouped_kernel_on_edge_shapes(shape):
    dev = _card()
    E, K, N, R, counts = SHAPES[shape]
    offsets = torch.tensor([0, *torch.tensor(counts).cumsum(0).tolist()], dtype=torch.int32,
                           device=dev)
    end = int(offsets[-1])
    g = torch.Generator(device=dev).manual_seed(len(shape))
    x = torch.randn(R, K, generator=g, device=dev).to(torch.bfloat16)
    w = (0.05 * torch.randn(E, N, K, generator=g, device=dev)).to(torch.bfloat16)
    raw = grouped_gemm(x, w, offsets)
    h = grouped_gemm(x, w, offsets, swiglu=True)
    torch.cuda.synchronize()
    _within_rounding(raw, x, w, offsets)
    want = swiglu_interleaved(raw[:end]).float()
    assert bool(((h[:end].float() - want).abs() <= 2 ** -7 * want.abs()).all())
    with float32_precision():
        plain, plain_h = grouped_gemm_ref(x, w, offsets), grouped_gemm_ref(x, w, offsets, True)
    for got, ref in ((raw, plain), (h, plain_h)):  # a rounding apart on few entries
        assert float((got[:end] != ref[:end]).float().mean()) < 0.01
    # rows at or past offsets[E] keep what was there; two launches, one answer
    for swiglu, first in ((False, raw), (True, h)):
        y = _launch(x, w, offsets, swiglu, -7.0)
        torch.cuda.synchronize()
        assert bool((y[end:] == -7.0).all()) and torch.equal(y[:end], first[:end])


@pytest.mark.card
def test_forward_makes_no_host_sync():
    dev = _card()
    cfg = mla_moe.MLAMoEConfig(layers=3)  # the published widths, one dense and two MoE layers
    params = mla_moe.init_mla_moe_params(cfg, 2 ** 33 + 5, dev)
    B, L = 4, 512
    ids = torch.randint(5, 8192, (B, L), device=dev)
    lens = torch.tensor([512, 65, 300, 1], device=dev)
    mask = (torch.arange(L, device=dev)[None] < lens[:, None]).float()
    vcfg = VerdictConfig(encoder=cfg, max_length=L)
    verdict_apply(params, vcfg, ids, mask, None)  # loads the kernels
    torch.cuda.synchronize()
    offsets = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = verdict_apply(params, vcfg, ids, mask, None, offsets_out=offsets)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert logits.shape == (B, 2) and bool(torch.isfinite(logits).all())
    assert offsets[0].shape == (2, cfg.experts + 1)
    assert int(offsets[0][0, -1]) == cfg.experts_per_token * int(lens.sum())
