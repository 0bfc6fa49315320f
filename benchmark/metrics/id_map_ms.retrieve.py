"""Self time of the program span ``ranker.id_map`` a traced batch, in ms: in
``finalize_closest``, engine positions to doc ids and one list a query, the
collector's passes inside it left out (``gc_ms.retrieve``)."""

from benchmark.program_spans import self_ms


def read(run):
    return self_ms(run, "ranker.id_map")
