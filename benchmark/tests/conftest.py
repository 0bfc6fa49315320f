"""The benchmark's own tests. They run on the CPU at tiny sizes, through
the program's plain paths; a test marked ``card`` needs a CUDA device and
skips without one, deciding inside the test."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")
