"""Self time of the program span ``verdict.upload`` a traced request, in ms:
in ``VerdictClassifier.classify``, ids, mask and types to the card."""

from benchmark.program_spans import self_ms


def read(run):
    return self_ms(run, "verdict.upload")
