"""The yardstick's arithmetic against hand-counted shapes, and the
reduction of a profiler trace."""

from __future__ import annotations

import types

import numpy as np
import pytest

from benchmark import harness
from benchmark.rooflines import (flash_bwd, flash_fwd, light_add_topk, membership_slab, peaks,
                                 retrieve_batch, scoring_gemm, verdict_model)

ROBERTA = {"roberta": {"hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12,
                       "num_attention_heads": 12, "num_labels": 2},
           "verdict": {"max_length": 512}}


def test_scoring_gemm_bound_is_its_operations():
    w = {"U": 8192, "N": 50000, "B": 4096}
    ops = 2 * 8192 * 50000 * 4096  # 3.355e12 FLOP
    assert scoring_gemm.seconds(w) == pytest.approx(ops / 495e12)  # 6.78 ms
    assert scoring_gemm.match("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x256_8x4_nt_align1>")
    assert scoring_gemm.match("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8")
    assert not scoring_gemm.match("(anonymous namespace)::membership_slab_kernel(int const*)")


def test_slab_and_light_bounds_are_their_bytes():
    w = {"U": 1000, "N": 2000, "B": 300, "heavy_index_postings": 50, "entries": 7,
         "light_postings": 11}
    assert membership_slab.seconds(w) == pytest.approx((4 * 1000 * 2300 + 8 * 50 + 8 * 7) / 3.35e12)
    assert light_add_topk.seconds(w) == pytest.approx((4 * 2000 * 300 + 8 * 11) / 3.35e12)


def test_batch_work_and_its_least_time():
    # two queries: {1, 2} and {2, 3}; df 10, 100, 5; split at df 20
    df = np.zeros(8, np.int64)
    df[[1, 2, 3]] = [10, 100, 5]
    w = retrieve_batch.batch_work(np.array([0, 0, 1, 1]), np.array([1, 2, 2, 3]), np.ones(4), df,
                                  20, batch=2, num_docs=200, k=5)
    assert (w["U"], w["entries"], w["pairs"]) == (1, 4, 215)
    assert (w["union_postings"], w["light_postings"], w["heavy_index_postings"]) == (115, 15, 100)
    assert retrieve_batch.least(w) == pytest.approx((8 * 115 + 8 * 4 + 8 * 2 * 5) / 3.35e12)


def test_model_flops_of_real_tokens():
    w = verdict_model.work(ROBERTA, [10])
    per_token = 2 * 12 * (4 * 768 ** 2 + 2 * 768 * 3072)  # 169,869,312
    assert verdict_model.forward_flops(w) == per_token * 10 + 4 * 12 * 768 * 100 + 2 * (768 ** 2 + 768 * 2)


def test_flash_bounds():
    w = verdict_model.work(ROBERTA, [512])  # one row, all real: 512^2 pairs a head
    w["layers"] = 1
    ops = 2 * 2 * 64 * 12 * 512 ** 2
    nbytes = 4 * 4 * 512 * 768 + 2 * 4 * 512
    assert flash_fwd.seconds(w) == pytest.approx(max(ops / 495e12, nbytes / 3.35e12))
    w = verdict_model.work(ROBERTA, [100, 412])  # pads attend pads: 100^2 + 412^2 a row
    assert verdict_model.live_pairs(w) == 2 * (100 ** 2 + 412 ** 2)
    ops = 7 * 2 * 64 * 12 * 2 * (100 ** 2 + 412 ** 2)
    nbytes = 7 * 4 * 2 * 512 * 768 + 3 * 4 * 2 * 512 * 12
    assert flash_bwd.seconds(w) == pytest.approx(12 * max(ops / 495e12, nbytes / 3.35e12))
    assert flash_bwd.match("(anonymous namespace)::flash_attention_dq_kernel(float const*)")
    assert not flash_fwd.match("(anonymous namespace)::flash_attention_dkv_kernel(float const*)")


def test_least_seconds_takes_the_slower_bound():
    assert peaks.least_seconds(495e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def _run(**kw):
    run = types.SimpleNamespace(trace_summary=None, traced=range(0), work={}, requests=[],
                                window_s=1.0)
    run.__dict__.update(kw)
    return run


def test_shares_read_nothing_without_a_trace_and_never_zero():
    assert harness.roofline_share(_run(), scoring_gemm) is None
    s = harness.TraceSummary(1.0, 2.0, {"membership_slab_kernel": 0.5}, {}, {})
    run = _run(trace_summary=s, traced=range(2), work={0: {}, 1: {}})
    assert harness.roofline_share(run, scoring_gemm) is None  # no GEMM in the trace
    assert harness.idle_share(run) == pytest.approx(50.0)
    w = {"U": 10, "N": 100, "B": 10, "heavy_index_postings": 0, "entries": 0}
    run = _run(trace_summary=s, traced=range(2), work={0: w, 1: w})
    assert harness.roofline_share(run, membership_slab) == pytest.approx(
        100 * 2 * membership_slab.seconds(w) / 0.5)


def test_step_mfu_is_least_time_over_the_window():
    req = [harness.Request(0, 1, 4)] * 3
    run = _run(requests=req, window_s=2.0, work={i: {"x": 0.1} for i in range(3)})
    assert harness.step_mfu(run, lambda w: w["x"]) == pytest.approx(100 * 0.3 / 2.0)
    run.work.pop(2)
    assert harness.step_mfu(run, lambda w: w["x"]) is None


def test_reduce_trace_busy_window_and_idle_by_host():
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [x("kernel", "a", 0, 10), x("kernel", "b", 5, 15), x("kernel", "a", 30, 10),
              x("gpu_memcpy", "Memcpy HtoD", 45, 5), x("user_annotation", "bench.traced", 0, 60),
              x("user_annotation", "bench.vectorize", 18, 17), x("cuda_runtime", "cudaMemcpyAsync", 38, 8),
              x("gpu_user_annotation", "bench.vectorize", 0, 50)]
    s = harness.reduce_trace(events)
    assert s.busy_s == pytest.approx(35e-6) and s.window_s == pytest.approx(50e-6)
    assert s.kernel_s["a"] == pytest.approx(20e-6) and s.launches["a"] == 2
    assert s.idle_by_host == pytest.approx({"bench.vectorize": 10e-6, "cudaMemcpyAsync": 5e-6})
    assert harness.reduce_trace([x("cpu_op", "aten::mm", 0, 5)]) is None
    b = harness.breakdown(s)
    assert b["device_ops"][0] == ["a", pytest.approx(20e-6)] and len(b["idle_gaps"]) == 2
