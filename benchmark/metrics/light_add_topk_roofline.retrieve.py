"""Share of its roofline (``rooflines/light_add_topk.py``) over the traced span."""

from benchmark.harness import roofline_share
from benchmark.rooflines import light_add_topk


def read(run):
    return roofline_share(run, light_add_topk)
