"""The ranker's host half a batch, mean over the window: the query
vectorizer, ``hybrid_host_inputs`` (light pools, union, query slab inputs)
and ``hybrid_from_host_async``'s host time (the pageable uploads and the
launches). The read-back (``finalize_closest``) is not in it."""

import numpy as np


def read(run):
    parts = [run.spans.get(n) for n in ("vectorize", "host_inputs", "upload_launch")]
    if not all(parts):
        return None
    return 1e3 * float(np.mean(np.sum(parts, axis=0)))
