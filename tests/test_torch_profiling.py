"""The port's ``utils/profiling.py``: ``trace`` writes a ``torch.profiler``
Chrome trace of the enclosed block, and ``Throughput`` is the JAX package's
meter carried over line for line (``ircl_tpu/utils/profiling.py``)."""

import json
import os
import time

import pytest
import torch

from ircl_tpu.utils import profiling as j_prof
from ircl_tpu_torch.utils import profiling as t_prof


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with t_prof.trace(str(logdir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(logdir)
    with open(logdir / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)


def test_trace_stops_when_the_block_raises(tmp_path):
    with pytest.raises(KeyError):
        with t_prof.trace(str(tmp_path)):
            raise KeyError("inside")
    assert len(os.listdir(tmp_path)) == 1
    with t_prof.trace(str(tmp_path)):  # a second trace can start
        torch.zeros(4).sum()
    assert len(os.listdir(tmp_path)) == 2


def test_throughput_matches_reference(monkeypatch):
    clock = iter([100.0, 100.0, 102.0, 102.0])
    monkeypatch.setattr(time, "time", lambda: next(clock))
    meters = [j_prof.Throughput(), t_prof.Throughput()]
    assert [m.rate() for m in meters] == [0.0, 0.0]
    for m in meters:
        m.add(10)  # starts the clock (one read each)
    assert [m.rate() for m in meters] == [5.0, 5.0]
