"""Python's collector a traced batch, in ms: all ``python.gc*`` program
spans, wherever they interrupted the program (0 where no pass ran)."""

from benchmark.program_spans import gc_ms


def read(run):
    return gc_ms(run)
