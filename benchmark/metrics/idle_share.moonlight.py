"""Share of the traced span with no operation on the device."""

from benchmark.harness import idle_share


def read(run):
    return idle_share(run)
