"""The window's batches' least exact sparse work (``rooflines/
retrieve_batch.py``) over the window's time."""

from benchmark.harness import step_mfu
from benchmark.rooflines import retrieve_batch


def read(run):
    return step_mfu(run, retrieve_batch.least)
