"""Self time of the program span ``verdict.tokenize`` a traced request, in ms:
in ``VerdictClassifier.classify``, the host WordPiece of the request's pairs."""

from benchmark.program_spans import self_ms


def read(run):
    return self_ms(run, "verdict.tokenize")
