"""The Moonlight verdict cell (``traffic/verify_moe.py``) at a tiny size on
the CPU, through the harness: the program is correct, and the control and
each planted fault (``moonlight_faults.py``) are not."""

from __future__ import annotations

import copy
import os

import pytest

from benchmark import harness, moonlight_faults
from benchmark.rooflines import expert_gemm, moonlight_model

ROOT = harness.ROOT
PER_LAYER = ["device_ms_per_batch.moonlight", "expert_gemm_ms.moonlight",
             "expert_gemm_roofline.moonlight", "expert_load_max_over_mean.moonlight",
             "mfu.moonlight", "idle_share.moonlight"]


def _cell() -> harness.Cell:
    cfg = harness.load_json(os.path.join(ROOT, "configs", "moonlight16b.json"))
    cfg.update(vocab_size=1024, hidden_size=64, num_hidden_layers=3, intermediate_size=128,
               num_attention_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
               kv_lora_rank=32, n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=1,
               moe_intermediate_size=32)
    cfg["assumed_init"] = {"init_std": 0.08, "bias_std": 0.05}
    cfg["corpus"]["num_docs"] = 300
    cfg["verdict"]["max_length"] = 64
    cfg["wordpiece"]["vocab_size"] = 600
    mix = harness.load_json(os.path.join(ROOT, "workloads", "verify_moe_pairs32.json"))
    mix.update(batch=4, pool_requests=4, vocab_docs=100)
    # at this size the program equals the reference
    mix["limits"] = {"prob_gap_p25": 2e-3, "prob_gap_p50": 2e-3, "prob_gap_p90": 2e-3}
    return harness.Cell("tiny.moonlight", copy.deepcopy(cfg), mix, 1,
                        [{"name": n, "unit": "u"} for n in
                         ("setup_s", "verify_claims_per_s", "request_p95_ms")],
                        [{"name": n, "unit": "u"} for n in PER_LAYER])


def _run(seed=2 ** 31 + 11, **kw):
    return harness.run_cell(_cell(), seed, 0.4, kw.pop("trace", False), "cpu", **kw)


def test_cell_runs_and_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"prob_gap_p25", "prob_gap_p50", "prob_gap_p90"}
    assert max(c["value"] for c in out["checks"].values()) < 1e-3
    assert set(out["metrics"]) == {"setup_s", "verify_claims_per_s", "request_p95_ms"}


def test_traced_run_reads_the_program_counters():
    out = _run(trace=True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    # no device on the CPU: the device readers find nothing and stay out
    assert set(m) == {"expert_load_max_over_mean.moonlight", "mfu.moonlight"}
    assert 1.0 <= m["expert_load_max_over_mean.moonlight"]["value"] <= 8


def test_control_is_not_correct():
    out = _run(control=True)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", moonlight_faults.FAULTS)
def test_each_fault_is_not_correct(fault):
    undo = moonlight_faults.plant(fault)
    try:
        out = _run()
    finally:
        undo()
    assert not out["correct"], (fault, out["checks"])


def test_expert_gemm_bound_and_model_flops():
    cfg = harness.load_json(os.path.join(ROOT, "configs", "moonlight16b.json"))
    w = moonlight_model.work(cfg, [100, 412])
    rows = 6 * 512
    ops = 26 * rows * 2 * 3 * 2048 * 1408
    nbytes = 26 * 2 * 64 * 3 * 1408 * 2048
    assert expert_gemm.seconds(w) == pytest.approx(max(ops / 989e12, nbytes / 3.35e12))
    assert expert_gemm.match("void (anonymous namespace)::moe_grouped_gemm_kernel<true>(x)")
    attn = 16 * 192 * 2048 + 576 * 2048 + 16 * 256 * 512 + 2048 * 2048
    per_token = 2 * (27 * attn + 3 * 2048 * 11264 + 26 * (64 * 2048 + 8 * 3 * 2048 * 1408))
    pairs = 100 * 101 / 2 + 412 * 413 / 2
    want = per_token * 512 + 2 * 27 * 16 * 320 * pairs + 2 * 2 * 2048 * 2
    assert moonlight_model.forward_flops(w) == pytest.approx(want)
