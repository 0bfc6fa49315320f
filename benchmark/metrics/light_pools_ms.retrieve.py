"""Self time of the program span ``ranker.light_pools`` a traced batch, in
ms: in ``hybrid_host_inputs``, the C++ gather of the light terms' posting
pools."""

from benchmark.program_spans import self_ms


def read(run):
    return self_ms(run, "ranker.light_pools")
