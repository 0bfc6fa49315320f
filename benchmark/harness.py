"""The benchmark's run of one cell: set-up, window, comparison, result line.

A cell is found by name in ``BENCHMARK.json``; everything it needs is a
file found by name under ``benchmark/``: its configuration
(``configs/<config>.json``), its traffic mix (``workloads/<traffic>.json``,
whose ``kind`` names the window driver ``traffic/<kind>.py``), and one
reader a metric (``metrics/<metric>.py``, a function ``read(run)`` that
returns the value or None). A driver module has ``build(run)``, which sets
up and warms the program and returns the cell; the cell has
``window(run)``, ``release()`` and ``check(run)``, and may have
``work(run)`` for the roofline readers.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "ircl_tpu")  # top-level names, whole
TRACE_DIR = os.path.join(ROOT, ".trace")
TRACE_SPAN_S = 4.0  # the traced span of a --trace 1 run, in every cell


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from a file under ``benchmark/`` whose name may hold dots."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` with its files resolved."""

    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(name: str, bench: dict, root: str = ROOT) -> Cell:
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(os.path.join(root, "configs", wl["config"] + ".json"))
    mix = load_json(os.path.join(root, "workloads", wl["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, config, mix, wl["chips"], e2e, per_layer)


@dataclass
class Request:
    """One request of the window: host clock at dispatch and at its result,
    and the units of work it carried (claims, pairs, samples)."""

    start: float
    end: float
    units: int


@dataclass
class Check:
    """A number compared, its limit, and whether it passed (value <= limit)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)  # NaN fails


@dataclass
class Run:
    """What one run of a cell sets up, measures and compares; the metric
    readers read it."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    control: bool = False
    t0: float = field(default_factory=time.time)
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    requests: List[Request] = field(default_factory=list)
    spans: Dict[str, List[float]] = field(default_factory=lambda: defaultdict(list))
    device_ms: Dict[str, List[float]] = field(default_factory=lambda: defaultdict(list))
    info: dict = field(default_factory=dict)
    checks: List[Check] = field(default_factory=list)
    probe: Optional["Probe"] = None
    trace_summary: Optional["TraceSummary"] = None
    traced: range = range(0)  # the requests inside the traced span
    work: Dict[int, dict] = field(default_factory=dict)  # request -> its work
    memory_peak_bytes: int = 0

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix

    def span(self, name: str):
        return _Span(self, name)

    def rate(self) -> Optional[float]:
        if not self.requests or self.window_s <= 0:
            return None
        return sum(r.units for r in self.requests) / self.window_s

    def latencies_ms(self) -> List[float]:
        return [1e3 * (r.end - r.start) for r in self.requests]


class _Span:
    """Host clock around a call into a layer, kept under ``name``; inside a
    traced span also a profiler annotation ``bench.<name>``."""

    def __init__(self, run: Run, name: str):
        self.run, self.name = run, name

    def __enter__(self):
        import torch

        self.rf = torch.profiler.record_function("bench." + self.name)
        self.rf.__enter__()
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.run.spans[self.name].append(time.perf_counter() - self.t)
        self.rf.__exit__(*exc)
        return False


class Probe:
    """Profiles one steady span of the window under ``torch.profiler``: it
    starts once a third of the window has passed and stops after
    ``TRACE_SPAN_S`` seconds, or where the window closes first. The driver
    asks ``due(i)`` before dispatching request ``i``; when it is due the
    driver drains what is in flight and calls ``toggle(i)``, so that the
    span holds whole requests only."""

    def __init__(self, run: Run, t_start: float):
        self.run = run
        self.start_at = t_start + run.seconds / 3
        self.prof = None
        self.first = None
        self.stopped = False
        self.t_started = 0.0

    def due(self, i: int) -> bool:
        if self.stopped or not self.run.trace:
            return False
        now = time.perf_counter()
        if self.prof is None:
            return now >= self.start_at
        return now >= self.t_started + TRACE_SPAN_S

    def toggle(self, i: int) -> None:
        import torch

        if self.prof is None:
            self.prof = start_profiler(self.run.device, self.run.mix.get("trace_host_ops", True))
            self.first, self.t_started = i, time.perf_counter()
            self.annotation = torch.profiler.record_function("bench.traced")
            self.annotation.__enter__()
        else:
            self.stop(i)

    def stop(self, i: int) -> None:
        if self.prof is None or self.stopped:
            return
        _sync(self.run.device)
        self.annotation.__exit__(None, None, None)
        self.prof.stop()
        self.stopped = True
        self.run.traced = range(self.first, i)


def _sync(device) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize()


def start_profiler(device, host_ops: bool = True):
    """``torch.profiler`` on the device, and on the host unless
    ``host_ops`` is false: recording every host operation slows a step of
    thousands of small operations, so such a cell traces the device alone."""
    from torch.profiler import ProfilerActivity, profile

    cuda = getattr(device, "type", "") == "cuda"
    acts = [ProfilerActivity.CPU] if host_ops or not cuda else []
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


@dataclass
class TraceSummary:
    """The traced span reduced: device busy seconds (union of kernel,
    copy and set intervals), the span from the first device operation's
    start to the last one's end, kernel seconds and launches by name, and
    idle seconds by what the host was doing."""

    busy_s: float
    window_s: float
    kernel_s: Dict[str, float]
    launches: Dict[str, int]
    idle_by_host: Dict[str, float]

    def seconds(self, match) -> float:
        """Kernel seconds of the kernels whose name ``match(name)`` takes."""
        return sum(s for n, s in self.kernel_s.items() if match(n))


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce_trace(events: List[dict]) -> Optional[TraceSummary]:
    """A Chrome trace's events (``torch.profiler``'s export) reduced to a
    ``TraceSummary``; None where no operation ran on the device. An idle
    gap is put down to the innermost benchmark span open at its middle, else
    to the CUDA runtime call then running, else to the host."""
    import numpy as np

    dev = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    if not dev:
        return None
    kernel_s: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    for e in dev:
        kernel_s[e["name"]] += e["dur"] * 1e-6
        launches[e["name"]] += 1
    start = np.array([e["ts"] for e in dev], np.float64)
    end = start + np.array([e["dur"] for e in dev], np.float64)
    reach = np.maximum.accumulate(end)  # the busy front after each operation
    gap = np.flatnonzero(start[1:] > reach[:-1])
    gap_a, gap_b = reach[:-1][gap], start[1:][gap]
    window = reach[-1] - start[0]
    busy = window - float((gap_b - gap_a).sum())
    idle: Dict[str, float] = defaultdict(float)
    if len(gap):
        mid = (gap_a + gap_b) / 2
        labels = _label(events, mid, lambda e: e.get("cat") == "user_annotation"
                        and e["name"].startswith("bench.") and e["name"] != "bench.traced")
        runtime = _label(events, mid, lambda e: e.get("cat") == "cuda_runtime")
        for i, (a, b) in enumerate(zip(gap_a, gap_b)):
            idle[labels[i] or runtime[i] or "host outside any span"] += (b - a) * 1e-6
    return TraceSummary(busy * 1e-6, window * 1e-6, dict(kernel_s), dict(launches), dict(idle))


def _label(events: List[dict], times, keep) -> List[Optional[str]]:
    """For each time, the name of the shortest event that ``keep`` takes
    and that is open at that time (None where none is)."""
    import numpy as np

    sel = [e for e in events if e.get("ph") == "X" and keep(e)]
    out: List[Optional[str]] = [None] * len(times)
    if not sel:
        return out
    a = np.array([e["ts"] for e in sel], np.float64)
    d = np.array([e["dur"] for e in sel], np.float64)
    for i, t in enumerate(times):
        open_ = np.flatnonzero((a <= t) & (a + d >= t))
        if len(open_):
            out[i] = sel[open_[np.argmin(d[open_])]]["name"]
    return out


def read_trace(prof) -> Optional[TraceSummary]:
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return reduce_trace(events)


def breakdown(summary: TraceSummary) -> dict:
    ops = sorted(summary.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in gaps]}


def host_counters() -> dict:
    """This process's CPU seconds and the host clock."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall": time.perf_counter(), "cpu": ru.ru_utime + ru.ru_stime}


def host_report(a: dict, b: dict) -> str:
    """CPU seconds over the window's seconds, and where the process may run."""
    return (f"process cpu {b['cpu'] - a['cpu']:.2f} s of {b['wall'] - a['wall']:.2f} s; "
            f"{os.cpu_count()} cpus, affinity {sorted(os.sched_getaffinity(0))}")


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def read_metric(name: str, run: Run):
    mod = load_module(os.path.join(ROOT, "metrics", name + ".py"), "benchmark_metric_" + name)
    return mod.read(run)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, *,
             control: bool = False, t0: Optional[float] = None) -> dict:
    """Sets up, measures and compares one cell; the result line's dict.
    ``control`` runs the configuration's control in the program's place."""
    import torch

    run = Run(cell, seed, seconds, trace, torch.device(device), control=control,
              t0=time.time() if t0 is None else t0)
    driver = importlib.import_module("benchmark.traffic." + cell.mix["kind"])
    if trace:  # the profiler's first start initializes its tracer: not in the window
        start_profiler(run.device, cell.mix.get("trace_host_ops", True)).stop()
    state = driver.build(run)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    gc.collect()  # set-up's garbage, so that every run starts its window alike
    host = host_counters()
    t_window = time.perf_counter()
    run.setup_s = time.time() - run.t0
    run.probe = Probe(run, t_window)
    state.window(run)
    log("host over the window: " + host_report(host, host_counters()))
    thirds = [0, 0, 0]
    for r in run.requests:
        thirds[min(2, int(3 * (r.end - t_window) / max(run.window_s, 1e-9)))] += r.units
    log("window: %d requests in %.3f s (units by third: %s); host spans (mean ms): %s" % (
        len(run.requests), run.window_s, thirds,
        {k: round(1e3 * sum(v) / len(v), 3) for k, v in run.spans.items() if v}))
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {found}")
    state.release()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    if run.probe.prof is not None:
        run.trace_summary = read_trace(run.probe.prof)
        log(f"trace of {len(run.traced)} requests read in {time.perf_counter() - t:.2f}s")
    t = time.perf_counter()
    run.checks = state.check(run)
    log(f"comparison in {time.perf_counter() - t:.2f}s")
    if trace and hasattr(state, "work"):
        state.work(run)
    return result_line(run)


def result_line(run: Run) -> dict:
    import torch

    names = run.cell.per_layer if run.trace else run.cell.end_to_end
    metrics = {}
    for m in names:
        v = read_metric(m["name"], run)
        if v is None and not run.trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if run.device.type == "cuda":
        kind, count = torch.cuda.get_device_name(run.device), run.cell.chips
    else:
        kind, count = "cpu", 1
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu", "kind": kind,
              "count": count, "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": bool(run.failed == 0 and run.checks and all(c.ok for c in run.checks)),
           "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
           "device": device}
    if run.trace:
        s = run.trace_summary
        device["busy_s"] = s.busy_s if s else 0.0
        device["window_s"] = s.window_s if s else 0.0
        if s:
            out["breakdown"] = breakdown(s)
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return out


def roofline_share(run: Run, kernel) -> Optional[float]:
    """``kernel``'s share of its roofline over the traced span, in %: the
    least time of the traced requests' work (``kernel.seconds``) over the
    time its kernels (``kernel.match``) took. None where nothing was read."""
    s = run.trace_summary
    if s is None or not run.traced or any(i not in run.work for i in run.traced):
        return None
    took = s.seconds(kernel.match)
    if took <= 0:
        return None
    return 100.0 * sum(kernel.seconds(run.work[i]) for i in run.traced) / took


def idle_share(run: Run) -> Optional[float]:
    """The traced span's share with no operation on the device, in %."""
    s = run.trace_summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def step_mfu(run: Run, least) -> Optional[float]:
    """The least time of the window's completed requests' work (``least``)
    over the window's time, in %."""
    done = range(len(run.requests))
    if not run.requests or any(i not in run.work for i in done):
        return None
    return 100.0 * sum(least(run.work[i]) for i in done) / run.window_s
