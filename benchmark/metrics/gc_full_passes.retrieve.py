"""Full passes of Python's collector (``python.gc2`` program spans) a
traced batch."""

from benchmark.program_spans import gc_full_passes


def read(run):
    return gc_full_passes(run)
