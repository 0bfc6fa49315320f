"""Self time of the program span ``verdict.readback`` a traced request, in
ms: in ``VerdictClassifier.classify``, the host waiting for the card and
copying the probabilities back."""

from benchmark.program_spans import self_ms


def read(run):
    return self_ms(run, "verdict.readback")
