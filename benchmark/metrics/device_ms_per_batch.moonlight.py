"""Kernel time a request on the card (the Moonlight body's forward), from
the profiler over the traced span."""


def read(run):
    s = run.trace_summary
    if s is None or not run.traced:
        return None
    return 1e3 * sum(s.kernel_s.values()) / len(run.traced)
