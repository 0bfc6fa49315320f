"""Share of its roofline (``rooflines/scoring_gemm.py``) over the traced span."""

from benchmark.harness import roofline_share
from benchmark.rooflines import scoring_gemm


def read(run):
    return roofline_share(run, scoring_gemm)
