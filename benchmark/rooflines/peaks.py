"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W). Every roofline and ``mfu`` share is stated against these,
with the card's power limit printed beside the run.

Matrix operations of these configurations are counted at the TF32 tensor
rate: it is the highest rate at which the card takes float32 operands, and
the configurations forbid a one-pass TF32 or bf16 product (their scores and
the verdict model are float32), so no float32-exact implementation, split
TF32 with three passes included, can read above 100%. The float32 FMA rate
would let such an implementation read an impossible share.
"""

TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float, flops: float = TF32_FLOPS) -> float:
    """The larger of the operations at ``flops`` and the bytes at the
    memory's rate."""
    return max(ops / flops, nbytes / HBM_BYTES_PER_S)
