"""Profiling helpers: device traces and a throughput meter.

Counterpart of ``ircl_tpu/utils/profiling.py``. ``trace`` records the
enclosed block with ``torch.profiler`` (CPU activity, and CUDA activity
where a card is present) and writes a Chrome trace into ``logdir``, which
Perfetto or ``chrome://tracing`` open; ``Throughput`` is carried over line
for line.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a trace of the enclosed block into
    ``{logdir}/trace_{pid}_{time_ns}.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )


class Throughput:
    """Sliding throughput meter: items/sec over the last window."""

    def __init__(self):
        self._t0: Optional[float] = None
        self._items = 0

    def start(self) -> None:
        self._t0 = time.time()
        self._items = 0

    def add(self, n: int = 1) -> None:
        if self._t0 is None:
            self.start()
        self._items += n

    def rate(self) -> float:
        if self._t0 is None or self._items == 0:
            return 0.0
        return self._items / max(time.time() - self._t0, 1e-9)
