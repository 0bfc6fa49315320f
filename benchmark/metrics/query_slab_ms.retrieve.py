"""Self time of the program span ``ranker.query_slab`` a traced batch, in ms:
in ``hybrid_host_inputs``, the heavy-term mask, the batch's union of heavy
buckets, the per-query term sort and the query slab rows."""

from benchmark.program_spans import self_ms


def read(run):
    return self_ms(run, "ranker.query_slab")
