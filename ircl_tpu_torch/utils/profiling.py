"""Profiling helpers: device traces and the program's own spans.

``trace``, the counterpart of ``ircl_tpu/utils/profiling.py``'s, records
the enclosed block with ``torch.profiler`` (CPU activity, and CUDA
activity where a card is present) and writes a Chrome trace into
``logdir``, which Perfetto or ``chrome://tracing`` open.

``span(name)`` marks a stretch of the program's host work as
``ircl.<name>`` in whatever ``torch.profiler`` session is recording
(``trace``'s or a caller's own): a ``user_annotation`` event on the
profiler's clock, in the same trace as the kernels, so that every stretch
in which the card sat idle lies under the host work that kept it waiting.
With no session recording, a span costs one check and returns a shared
no-op object. Spans nest by time on their thread; a span's self time is its
duration less the spans inside it.

The first ``trace``, or the first span entered while a session records,
installs one ``gc`` callback that marks each pass of Python's collector the
same way, as ``ircl.python.gc<generation>``, inside whatever span it
interrupts; with no session recording it returns after one check. A process
that never profiles has no callback.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_recording = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a trace of the enclosed block into
    ``{logdir}/trace_{pid}_{time_ns}.json``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    collector_spans.install()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )


def span(name: str):
    """A context manager that marks the enclosed host work as
    ``ircl.<name>`` while a ``torch.profiler`` session records, and the
    shared no-op context otherwise."""
    if not _recording():
        return _OFF
    collector_spans.install()
    return record_function("ircl." + name)


class _CollectorSpans:
    """The ``gc`` callback: a span from each collection's start to its stop.
    Collections never nest, so one open span at a time suffices."""

    def __init__(self):
        self.open = None
        self.installed = False

    def install(self) -> None:
        """Append the callback to ``gc.callbacks``, once a process."""
        if not self.installed:
            gc.callbacks.append(self)
            self.installed = True

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            if _recording():
                self.open = record_function(f"ircl.python.gc{info['generation']}")
                self.open.__enter__()
        elif self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


collector_spans = _CollectorSpans()
