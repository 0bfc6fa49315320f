"""Self time of the program span ``verdict.forward`` a traced request, in ms:
in ``VerdictClassifier.classify``, the host's time to launch the forward."""

from benchmark.program_spans import self_ms


def read(run):
    return self_ms(run, "verdict.forward")
