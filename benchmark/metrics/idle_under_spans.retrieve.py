"""The share of the traced span's device-idle time, in %, whose gaps have
their middle inside a program span (``ircl.*``): how much of the card's
idle the program's spans account for."""

from benchmark.program_spans import idle_under_spans


def read(run):
    return idle_under_spans(run)
