"""Share of its roofline (``rooflines/expert_gemm.py``) over the traced span."""

from benchmark.harness import roofline_share
from benchmark.rooflines import expert_gemm


def read(run):
    return roofline_share(run, expert_gemm)
