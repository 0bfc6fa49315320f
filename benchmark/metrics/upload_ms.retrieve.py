"""Self time of the program span ``ranker.upload`` a traced batch, in ms: in
``hybrid_from_host_async``, the five pageable host-to-device copies of the
host half's arrays."""

from benchmark.program_spans import self_ms


def read(run):
    return self_ms(run, "ranker.upload")
