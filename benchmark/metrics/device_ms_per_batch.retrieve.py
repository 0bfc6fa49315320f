"""The sparse engine's device half a batch, mean over the window: CUDA
events around ``hybrid_from_host_async`` (uploads, slabs, GEMM, light add
and top-k), as ``tools/bench.py`` takes them."""

import numpy as np


def read(run):
    ms = run.device_ms.get("device_half")
    return float(np.mean(ms)) if ms else None
