"""Kernel #6a (``csrc/flash_attention.cu``), every layer of a batch: two
products (q k^T and p v) over the pairs the segment ids leave at the TF32
rate, or q, k, v read once, o written once and the segment ids read,
whichever takes longer."""

from benchmark.rooflines import verdict_model
from benchmark.rooflines.peaks import least_seconds


def match(name: str) -> bool:
    return "flash_attention_kernel" in name


def seconds(w: dict) -> float:
    hd = w["hidden"] / w["heads"]
    ops = 2 * 2.0 * hd * w["heads"] * verdict_model.live_pairs(w)
    nbytes = 4 * 4.0 * verdict_model.head_elements(w) + 2 * 4.0 * len(w["lengths"]) * w["L"]
    return w["layers"] * least_seconds(ops, nbytes)
