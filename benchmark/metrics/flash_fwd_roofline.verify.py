"""Share of its roofline (``rooflines/flash_fwd.py``) over the traced span."""

from benchmark.harness import roofline_share
from benchmark.rooflines import flash_fwd


def read(run):
    return roofline_share(run, flash_fwd)
