"""Kernel #3 (``csrc/light_add_topk.cu``): the heavy scores H_T [N, B]
float32 read once, the batch's light postings (doc and contribution) read
once, the tile winners written (negligible)."""

from benchmark.rooflines.peaks import least_seconds


def match(name: str) -> bool:
    return "light_add_topk" in name


def seconds(w: dict) -> float:
    return least_seconds(0.0, 4.0 * w["N"] * w["B"] + 8.0 * w["light_postings"])
