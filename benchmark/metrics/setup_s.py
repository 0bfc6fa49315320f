"""Set-up: process start to the window's start, compilation included."""


def read(run):
    return run.setup_s
