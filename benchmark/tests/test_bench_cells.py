"""Every traffic kind end to end at a tiny size on the CPU; the control and
each fault a cell can have come out not correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import faults, harness
from benchmark.reference import roberta
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def staged_past_a_few_docs(monkeypatch):
    """The synthetic-postings cell takes the staged engine, as at 1M docs."""
    from ircl_tpu_torch.index.ranker import TfidfRanker

    monkeypatch.setattr(TfidfRanker, "FUSED_LIGHT_MAX_DOCS", 1000)


def _tf32_gemm(monkeypatch):
    """The card's TF32 scoring GEMM on the CPU: operands rounded to TF32."""
    import ircl_tpu_torch.ops.hybrid as hybrid

    plain = hybrid.scores_matmul

    def gemm(a, b, tf32=False):
        if tf32:
            a, b = roberta._round_tf32(a), roberta._round_tf32(b)
        return plain(a, b, tf32=False)

    monkeypatch.setattr(hybrid, "scores_matmul", gemm)


@pytest.mark.parametrize("kind", tiny.KINDS)
def test_cell_runs_and_is_correct(kind):
    out = tiny.run(kind)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == set(tiny.E2E[tiny.cell(kind).mix["kind"]])
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("kind", tiny.KINDS)
def test_traced_run_reports_per_layer_metrics(kind):
    out = tiny.run(kind, trace=True)
    assert out["correct"], out["checks"]
    # no device on the CPU: the device readers find nothing and stay out
    assert "busy_s" in out["device"] and "window_s" in out["device"]
    assert all(not k.startswith(("idle_share", "device_ms")) for k in out["metrics"])
    assert any(k.startswith("mfu") for k in out["metrics"])


@pytest.mark.parametrize("kind", tiny.KINDS)
def test_control_is_not_correct(kind, monkeypatch):
    _tf32_gemm(monkeypatch)
    out = tiny.run(kind, control=True)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("kind", tiny.KINDS)
def test_fault_is_not_correct(kind, fault):
    undo = faults.plant(tiny.cell(kind).mix["kind"], fault)
    try:
        out = tiny.run(kind)
    finally:
        undo()
    assert not out["correct"], out["checks"]


def test_finetune_state_unchanged_after_set_up_is_not_correct():
    """Set-up's steps are sound and compare well; from the window's first
    step on the update is withheld, and the window's compared step fails."""
    cell = tiny.cell("finetune")
    undo = faults.plant("finetune", "unchanged", after=cell.mix["check_steps"])
    try:
        out = tiny.run("finetune")
    finally:
        undo()
    checks = out["checks"]
    assert all(checks[n]["value"] <= checks[n]["limit"] for n in ("loss_gap", "grad_gap", "update_gap"))
    assert checks["step_update_gap"]["value"] > checks["step_update_gap"]["limit"]
    assert not out["correct"]


def test_finetune_nonfinite_window_loss_is_not_correct(monkeypatch):
    from benchmark.traffic import finetune

    step = finetune.ProgramTrainer.step
    calls = [0]

    def late_nan(self, *a):
        calls[0] += 1
        loss = step(self, *a)
        return loss * float("nan") if calls[0] == tiny.cell("finetune").mix["check_steps"] + 1 else loss

    monkeypatch.setattr(finetune.ProgramTrainer, "step", late_nan)
    out = tiny.run("finetune")
    assert out["checks"]["nonfinite_losses"]["value"] >= 1
    assert not out["correct"]


def test_same_seed_same_answers_other_seed_other_inputs():
    a, b = tiny.run("retrieve_claims"), tiny.run("retrieve_claims")
    c = tiny.run("retrieve_claims", seed=7)
    assert a["checks"] == b["checks"]
    assert a["checks"] != c["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in harness.load_json(
    harness.REPO + "/BENCHMARK.json")["workloads"]])
def test_cell_on_card(name):
    """Each cell at its own size for a short window, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.find_cell(name, harness.load_json(harness.REPO + "/BENCHMARK.json"))
    out = harness.run_cell(cell, int(np.random.default_rng().integers(2 ** 40)), 3.0, False, "cuda")
    assert out["correct"], out["checks"]
