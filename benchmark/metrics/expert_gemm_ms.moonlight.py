"""Device time a traced request of the grouped expert GEMM's kernels
(``rooflines/expert_gemm.py``'s match), in ms."""

from benchmark.rooflines import expert_gemm


def read(run):
    s = run.trace_summary
    if s is None or not run.traced:
        return None
    took = s.seconds(expert_gemm.match)
    return 1e3 * took / len(run.traced) if took > 0 else None
