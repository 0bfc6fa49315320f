"""Kernel #2 (``csrc/membership_slab.cu``): the doc slabs [U, N] and the
query slab [U, B], float32, written once; every heavy posting of the
index's ELL rows (term id and value) and the batch's query vectors read
once."""

from benchmark.rooflines.peaks import least_seconds


def match(name: str) -> bool:
    return "membership_slab" in name


def seconds(w: dict) -> float:
    nbytes = 4.0 * w["U"] * (w["N"] + w["B"]) + 8.0 * w["heavy_index_postings"] + 8.0 * w["entries"]
    return least_seconds(0.0, nbytes)
