"""The 95th percentile, over every request completed in the window, of the
time from its dispatch to its result on the host (numpy's linear
interpolation)."""

import numpy as np


def read(run):
    lat = run.latencies_ms()
    return float(np.percentile(lat, 95)) if lat else None
