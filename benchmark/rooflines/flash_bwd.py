"""Kernels #6b + #6c (``csrc/flash_attention_bwd.cu``), every layer of a
train step: seven products over the pairs the segment ids leave (dK/dV:
s, dp, dv, dk; dQ: s, dp, dq) at the TF32 rate, or q, k, v, do and the
row statistics (l, m, di) read once and dq, dk, dv written once, whichever
takes longer."""

from benchmark.rooflines import verdict_model
from benchmark.rooflines.peaks import least_seconds


def match(name: str) -> bool:
    return "flash_attention_dkv_kernel" in name or "flash_attention_dq_kernel" in name


def seconds(w: dict) -> float:
    hd = w["hidden"] / w["heads"]
    ops = 7 * 2.0 * hd * w["heads"] * verdict_model.live_pairs(w)
    rows = len(w["lengths"]) * w["L"] * w["heads"]
    nbytes = 7 * 4.0 * verdict_model.head_elements(w) + 3 * 4.0 * rows
    return w["layers"] * least_seconds(ops, nbytes)
