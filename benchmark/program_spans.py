"""The program's own spans in a traced run, for the per-layer metrics that
read them.

``ircl_tpu_torch/utils/profiling.py`` marks the program's host work as
``ircl.<name>`` annotations, and each pass of Python's collector as
``ircl.python.gc<generation>``, in whatever ``torch.profiler`` session
records: in a ``--trace 1`` run, the harness's probe. After the window this
module reads that session's events once and keeps what it finds in
``run.info``. The harness has already saved the session to a Chrome trace
(``harness.read_trace``), which a session allows once, so the events are
read from the session's results in memory, in the export's form: ``ph``,
``cat``, ``name``, ``ts`` and ``dur`` in microseconds, ``tid``.

From them, per traced request (``len(run.traced)``): each name's self time,
its duration less the ``ircl.*`` spans nested in it on its thread (in
practice, collector passes), and its count. And the device's idle gaps,
found as ``harness.reduce_trace`` finds them, each put down to the
innermost ``ircl.*`` span open at its middle; the idle seconds under each
name go to stderr. Where the trace holds no ``ircl.*`` span (a program
that has none) every reader returns None.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from benchmark.harness import DEVICE_CATS, _label, log

PREFIX = "ircl."
GC = "python.gc"


def session_events(prof) -> List[dict]:
    """The profiler session's host annotations and device operations."""
    raw = prof.profiler.kineto_results.events()
    marks = {e.name() for e in raw if _category(e, ()) == "user_annotation"}
    out = []
    for e in raw:
        cat = _category(e, marks)
        if cat == "user_annotation" or cat in DEVICE_CATS:
            out.append({"ph": "X", "cat": cat, "name": e.name(), "ts": e.start_ns() * 1e-3,
                        "dur": e.duration_ns() * 1e-3, "tid": e.start_thread_id()})
    return out


def _category(e, marks) -> Optional[str]:
    """An event's category as the Chrome export names it, from the event's
    device type and annotation flag (torch releases differ in what else an
    event states): a host annotation is a host event that is an annotation,
    and a device operation a device event that is neither an annotation nor
    the device's mirror of one (the same name as a host annotation in
    ``marks``), a ``kernel`` here, be it a kernel, a copy or a set."""
    from torch.autograd import DeviceType

    on_device = e.device_type() != DeviceType.CPU
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    return "kernel" if on_device and e.name() not in marks else None


def summarize(events: List[dict]) -> Optional[dict]:
    """Self seconds and counts by span name (the prefix taken off), the
    device's idle seconds by the innermost span at each gap's middle (None
    for a gap outside every span), and the idle seconds in all; None where
    no ``ircl.*`` span is among ``events``."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith(PREFIX)]
    if not spans:
        return None
    self_us: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    threads = defaultdict(list)
    for e in spans:
        threads[e.get("tid")].append(e)
    for on_thread in threads.values():
        on_thread.sort(key=lambda e: (e["ts"], -e["dur"]))
        open_: List[dict] = []  # the spans open at the current start, outermost first
        for e in on_thread:
            name = e["name"][len(PREFIX):]
            self_us[name] += e["dur"]
            count[name] += 1
            while open_ and open_[-1]["ts"] + open_[-1]["dur"] <= e["ts"]:
                open_.pop()
            if open_:
                self_us[open_[-1]["name"][len(PREFIX):]] -= e["dur"]
            open_.append(e)
    idle: Dict[Optional[str], float] = defaultdict(float)
    dev = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    if dev:
        start = np.array([e["ts"] for e in dev], np.float64)
        reach = np.maximum.accumulate(start + np.array([e["dur"] for e in dev], np.float64))
        gap = np.flatnonzero(start[1:] > reach[:-1])
        gap_a, gap_b = reach[:-1][gap], start[1:][gap]
        labels = _label(spans, (gap_a + gap_b) / 2, lambda e: True)
        for label, a, b in zip(labels, gap_a, gap_b):
            idle[label and label[len(PREFIX):]] += (b - a) * 1e-6
    return {"self_s": {n: us * 1e-6 for n, us in self_us.items()}, "count": dict(count),
            "idle_s": dict(idle), "idle_total_s": sum(idle.values()) if dev else None}


def summary(run) -> Optional[dict]:
    """``summarize`` of the run's traced session, read once a run."""
    if "program_spans" not in run.info:
        run.info["program_spans"] = _read(run)
    return run.info["program_spans"]


def _read(run) -> Optional[dict]:
    prof = run.probe.prof if run.probe is not None else None
    if prof is None or not run.traced:
        return None
    t = time.perf_counter()
    events = session_events(prof)
    s = summarize(events)
    n = len(run.traced)
    if s is None:
        log(f"program spans: none among the trace's {len(events)} events")
        return None
    log(f"program spans over {n} traced requests, read in {time.perf_counter() - t:.2f}s "
        "(name: count, self ms a request): " + ", ".join(
            f"{k}: {s['count'][k]}, {1e3 * s['self_s'][k] / n:.3f}" for k in sorted(s["count"])))
    if s["idle_total_s"] is not None:
        h = run.trace_summary
        log(f"{sum(e['cat'] in DEVICE_CATS for e in events)} device operations"
            + (f" (the harness's trace: {sum(h.launches.values())}, idle "
               f"{h.window_s - h.busy_s:.4f} s)" if h else "")
            + f"; device idle {s['idle_total_s']:.4f} s, by innermost program span (s): "
            + str({k or "outside every program span": round(float(v), 4)
                   for k, v in sorted(s["idle_s"].items(), key=lambda kv: -kv[1])}))
    return s


def self_ms(run, name: str) -> Optional[float]:
    """``name``'s self time a traced request, in ms; None where it never ran."""
    s = summary(run)
    if s is None or name not in s["count"]:
        return None
    return 1e3 * s["self_s"][name] / len(run.traced)


def gc_ms(run) -> Optional[float]:
    """The collector's passes a traced request, in ms (0 where none ran)."""
    s = summary(run)
    if s is None:
        return None
    return 1e3 * sum(v for n, v in s["self_s"].items() if n.startswith(GC)) / len(run.traced)


def gc_full_passes(run) -> Optional[float]:
    """The collector's full passes (over its oldest generation) a traced
    request."""
    s = summary(run)
    if s is None:
        return None
    return s["count"].get(GC + "2", 0) / len(run.traced)


def idle_under_spans(run) -> Optional[float]:
    """The share of the device's idle time, in %, whose gaps have their
    middle inside an ``ircl.*`` span."""
    s = summary(run)
    if s is None or not s["idle_total_s"]:
        return None
    covered = sum(v for k, v in s["idle_s"].items() if k is not None)
    return 100.0 * covered / s["idle_total_s"]
