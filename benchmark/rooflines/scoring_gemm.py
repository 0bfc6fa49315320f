"""The scoring GEMM of the hybrid engine: heavy-term slab [N, U] times the
query slab [U, B], float32 (cuBLAS SGEMM). U is the batch's heavy union, N
the documents and B the queries, unpadded."""

from benchmark.rooflines.peaks import least_seconds


def match(name: str) -> bool:
    n = name.lower()
    return ("gemm" in n or "cutlass" in n or "xmma" in n) and "membership" not in n


def seconds(w: dict) -> float:
    u, n, b = w["U"], w["N"], w["B"]
    return least_seconds(2.0 * u * n * b, 4.0 * (u * n + u * b + n * b))
