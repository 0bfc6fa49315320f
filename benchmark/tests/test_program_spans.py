"""``benchmark/program_spans.py``: self time, counts and idle coverage on a
hand-made trace, the readers' None where the program has no spans, and the
program's spans read from a traced tiny cell on the CPU."""

from __future__ import annotations

import os
import types

import pytest
import torch

from benchmark import harness, program_spans
from benchmark.tests import tiny


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


# Two requests. The card runs [0, 10), [110, 120), [200, 210) (us), so it
# idles over [10, 110), whose middle (60) lies in a collector pass inside
# ``ranker.id_map``, and over [120, 200), whose middle (160) lies outside
# every program span (only in a benchmark span).
EVENTS = [
    _x("kernel", "gemm", 0, 10), _x("gpu_memcpy", "Memcpy DtoH", 110, 10),
    _x("kernel", "gemm", 200, 10),
    _x("user_annotation", "ircl.ranker.id_map", 0, 100),
    _x("user_annotation", "ircl.python.gc2", 50, 20),
    _x("user_annotation", "ircl.ranker.id_map", 220, 30),
    _x("user_annotation", "ircl.python.gc0", 300, 4, tid=2),
    _x("user_annotation", "bench.finalize", 100, 120),
    _x("cpu_op", "aten::copy_", 10, 200),
]


def _run(events, traced=2):
    run = types.SimpleNamespace(info={}, traced=range(traced),
                                probe=types.SimpleNamespace(prof=object()))
    run.info["program_spans"] = program_spans.summarize(events)
    return run


def test_self_time_counts_and_idle_coverage():
    s = program_spans.summarize(EVENTS)
    assert s["count"] == {"ranker.id_map": 2, "python.gc2": 1, "python.gc0": 1}
    assert s["self_s"]["ranker.id_map"] == pytest.approx((100 - 20 + 30) * 1e-6)
    assert s["self_s"]["python.gc2"] == pytest.approx(20e-6)
    assert s["idle_s"] == {"python.gc2": pytest.approx(100e-6), None: pytest.approx(80e-6)}
    assert s["idle_total_s"] == pytest.approx(180e-6)
    run = _run(EVENTS)
    assert program_spans.self_ms(run, "ranker.id_map") == pytest.approx(0.055)
    assert program_spans.gc_ms(run) == pytest.approx(0.012)
    assert program_spans.gc_full_passes(run) == 0.5
    assert program_spans.idle_under_spans(run) == pytest.approx(100 * 100 / 180)
    assert program_spans.self_ms(run, "ranker.vectorize") is None
    no_full = _run([e for e in EVENTS if e["name"] != "ircl.python.gc2"])
    assert program_spans.gc_full_passes(no_full) == 0
    assert program_spans.gc_ms(no_full) == pytest.approx(0.002)


def test_a_program_without_spans_reads_none():
    run = _run([e for e in EVENTS if not e["name"].startswith("ircl.")])
    assert run.info["program_spans"] is None
    for read in (lambda r: program_spans.self_ms(r, "ranker.id_map"), program_spans.gc_ms,
                 program_spans.gc_full_passes, program_spans.idle_under_spans):
        assert read(run) is None
    untraced = types.SimpleNamespace(info={}, traced=range(0), probe=None)
    assert program_spans.idle_under_spans(untraced) is None


def test_no_device_operation_leaves_idle_unread():
    s = program_spans.summarize([e for e in EVENTS if e["cat"] == "user_annotation"])
    assert s["idle_total_s"] is None and s["count"]["ranker.id_map"] == 2
    assert program_spans.idle_under_spans(_run([e for e in EVENTS
                                                if e["cat"] == "user_annotation"])) is None


class _Event:
    """A profiler result's event, as far as the reader asks of it: one whose
    device mirror of a host annotation is not flagged as an annotation."""

    def __init__(self, cat, name, ts, dur):
        self.cat, self._name, self.ts, self.dur = cat, name, ts, dur

    def name(self):
        return self._name

    def start_ns(self):
        return int(self.ts * 1000)

    def duration_ns(self):
        return int(self.dur * 1000)

    def start_thread_id(self):
        return 1

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self.cat in ("kernel", "gpu_memcpy", "gpu_user_annotation",
                                               "gpu_memset") else DeviceType.CPU

    def is_user_annotation(self):
        return self.cat == "user_annotation"


class _FlaggedMirrorEvent(_Event):
    """One whose device mirror of a host annotation is flagged as one."""

    def is_user_annotation(self):
        return self.cat in ("user_annotation", "gpu_user_annotation")


@pytest.mark.parametrize("kind", [_Event, _FlaggedMirrorEvent])
def test_session_events_keep_annotations_and_device_operations(kind):
    raw = [kind("user_annotation", "ircl.ranker.upload", 0, 50),
           kind("cpu_op", "aten::copy_", 1, 40), kind("cuda_runtime", "cudaMemcpyAsync", 2, 30),
           kind("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 5, 20),
           kind("gpu_user_annotation", "ircl.ranker.upload", 5, 20),
           kind("kernel", "gemm", 30, 10), kind("gpu_memset", "Memset (Device)", 45, 1)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: raw)))
    got = program_spans.session_events(prof)
    assert [(e["name"], e["ts"], e["dur"]) for e in got] == [
        ("ircl.ranker.upload", 0, 50), ("Memcpy HtoD (Pageable -> Device)", 5, 20),
        ("gemm", 30, 10), ("Memset (Device)", 45, 1)]
    assert got[0]["cat"] == "user_annotation"
    assert all(e["cat"] in harness.DEVICE_CATS for e in got[1:])


RETRIEVE = ("vectorize_ms", "query_slab_ms", "light_pools_ms", "upload_ms", "launch_ms",
            "readback_wait_ms", "id_map_ms", "gc_ms", "gc_full_passes")
VERIFY = ("tokenize_ms", "upload_ms", "forward_enqueue_ms", "readback_wait_ms", "gc_ms")


@pytest.mark.parametrize("kind, names, suffix", [("retrieve_claims", RETRIEVE, "retrieve"),
                                                 ("verify", VERIFY, "verify")])
def test_traced_tiny_cell_reads_the_program_spans(kind, names, suffix):
    cell = tiny.cell(kind)
    cell.per_layer = [{"name": f"{n}.{suffix}", "unit": "u"}
                      for n in names + ("idle_under_spans",)]
    # one torch thread (the tests run in several workers) and a window long
    # enough that its traced part holds whole requests on a loaded host
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = harness.run_cell(cell, 2 ** 31 + 5, 6.0, True, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert out["correct"], out["checks"]
    # on the CPU no device operation: the idle share stays out
    assert set(out["metrics"]) == {f"{n}.{suffix}" for n in names}
    assert all(v["value"] >= 0 for v in out["metrics"].values())


def test_every_new_metric_has_its_reader():
    bench = harness.load_json(os.path.join(harness.REPO, "BENCHMARK.json"))
    cells = {"fever50k.retrieve": RETRIEVE + ("idle_under_spans",),
             "fever50k.verify": VERIFY + ("idle_under_spans",)}
    for cell, names in cells.items():
        suffix = cell.split(".")[1]
        for n in names:
            (m,) = [m for m in bench["per_layer"] if m["name"] == f"{n}.{suffix}"]
            assert m["workloads"] == [cell]
            assert m["source"] == ("program_counter" if n == "gc_full_passes" else "program_span")
