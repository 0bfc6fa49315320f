"""Self time of the program span ``ranker.launch`` a traced batch, in ms: in
``hybrid_from_host_async``, the host's time to launch the sparse engine."""

from benchmark.program_spans import self_ms


def read(run):
    return self_ms(run, "ranker.launch")
