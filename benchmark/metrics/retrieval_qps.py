"""Claims (queries) whose top-k came back to the host in the window, over
the window's seconds."""


def read(run):
    return run.rate()
