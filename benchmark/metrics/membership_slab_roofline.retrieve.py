"""Share of its roofline (``rooflines/membership_slab.py``) over the traced span."""

from benchmark.harness import roofline_share
from benchmark.rooflines import membership_slab


def read(run):
    return roofline_share(run, membership_slab)
