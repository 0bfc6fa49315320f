"""Self time of the program span ``ranker.readback`` a traced batch, in ms:
in ``finalize_closest``, the host waiting for the card and copying the top-k
back."""

from benchmark.program_spans import self_ms


def read(run):
    return self_ms(run, "ranker.readback")
