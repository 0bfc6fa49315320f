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
