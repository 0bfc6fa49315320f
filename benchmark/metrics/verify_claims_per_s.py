"""Claims classified in the window, over the window's seconds."""


def read(run):
    return run.rate()
