"""Float32 arithmetic on the card: full fp32 unless TF32 is asked for.

PyTorch runs float32 matrix products in full fp32 by default, but cuDNN
runs float32 convolutions and recurrences in TF32 by default, and a caller
may have switched TF32 on for matrix products. The port's exact paths
(sparse and dense scoring, the encoder) hold their gates only in full fp32,
so they run inside ``float32_precision()``.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_precision(tf32: bool = False):
    """Set TF32 for CUDA matrix products and cuDNN to ``tf32`` (off by
    default: full fp32) inside the block, and restore the caller's settings
    after. The switches are process-wide: callers that compute from several
    threads serialize (the service holds a lock)."""
    prev_matmul = torch.get_float32_matmul_precision()
    prev_cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev_matmul)
        torch.backends.cudnn.allow_tf32 = prev_cudnn


def split_hi_lo(x: torch.Tensor):
    """float32 ``x`` as two bfloat16 halves: ``hi = bf16(x)`` and
    ``lo = bf16(x - hi)``, both rounded to nearest even. ``hi + lo`` keeps
    16 of x's 24 mantissa bits; a product of two halves is exact in fp32."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def split_tf32(x: torch.Tensor):
    """float32 ``x`` as two TF32 values held in float32: ``hi`` is x rounded
    to a 10-bit mantissa, to nearest with ties away from zero as
    ``cvt.rna.tf32.f32`` rounds, and ``lo`` is the remainder ``x - hi`` (exact
    in fp32) rounded the same way. The low 13 mantissa bits of both are
    zero, ``hi + lo`` is within 2^-22 of x, and a product of two halves is
    exact in fp32. Zeros keep their sign, a denormal is rounded at the same
    bit (to a multiple of 2^-136) and not flushed, and where ``hi`` is not
    finite ``lo`` is 0."""
    def rna(t):
        # the bits are sign and magnitude: half a unit of the last kept
        # place added to the magnitude, then the 13 low bits cut
        bits = t.contiguous().view(torch.int32)
        rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
        return torch.where(torch.isfinite(t), rounded, t)

    hi = rna(x)
    lo = rna(torch.where(torch.isfinite(hi), x - hi, torch.zeros_like(x)))
    return hi, lo


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the tensor-core kernels take it: both operands split by
    ``split_tf32`` and ``hi @ hi + (hi @ lo + lo @ hi)`` in fp32, the small
    terms summed apart. The sums run in fp32 as PyTorch orders them; how the
    tensor cores round their accumulator is not modelled."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    with float32_precision():
        return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)
