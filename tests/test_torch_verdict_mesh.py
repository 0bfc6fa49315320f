"""``train_verdict(mesh=)`` of the port on an 8-rank gloo group, against the
reference's ``train_verdict``.

Mirrors ``tests/test_verdict_mesh.py``'s meshes without a ``"stage"`` axis:
TP(4) x DP(2), DP(8) alone, and the MoE encoder (4 experts, top-2, capacity
factor 2) on EP(2) x TP(2) x DP(2). Its data (64 seeded examples, L=16),
epochs (2), batch (8), validation split (10%) and seed (7) go through the
port's loop over the ranks, from the reference's initial parameters
(``init_verdict_params(PRNGKey(7))``, which the reference's loop draws from
that seed) carried across: the histories meet the reference's single-device
histories and the port's single-device ones (train loss rtol 2e-5, as the
reference's test holds its mesh to its single device; validation macro-F1
equal), the returned parameters are whole and equal on every rank and meet
the single-device run's (rtol 5e-4, atol 5e-6). The TP x DP run also writes
its checkpoint and metrics from rank 0, read back here. The pipeline cases
(``tests/test_verdict_mesh.py:79-131``) run in the same launch: PP(2) x
DP(2) and PP(2) over the MoE encoder (``pp_micro`` 4) meet the same
histories and return the standard layout, and a ``("stage", "model")``
mesh is refused with ``ValueError``, as the reference refuses it.
"""

import jax
import numpy as np
import pytest

import _torch_ranks
from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.verdict.train import train_verdict as j_train_verdict
from ircl_tpu_torch.parallel.launch import launch
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.verdict import infer as t_infer
from ircl_tpu_torch.verdict.train import train_verdict as t_train_verdict
from test_torch_tp import (
    PARAM_TOL,
    RANKS,
    TIMEOUT,
    assert_trees_close,
    configs,
    j_params,
)

MOE = dict(num_experts=4, top_k=2, capacity_factor=2.0)
KW = dict(epochs=2, batch_size=8, val_fraction=0.1, seed=7)
CASES = {  # name: (MoE, mesh shape)
    "tp_dp": (False, dict(data=2, model=4)),
    "dp_only": (False, dict(data=8, model=1)),
    "moe_3axis": (True, dict(data=2, expert=2, model=2)),
}
PP_CASES = {  # the pipeline's: (MoE, mesh shape)
    "pp_dp": (False, dict(stage=2, data=2)),
    "pp_moe": (True, dict(stage=2, data=1)),
}


def _data(n=64, L=16, seed=0):
    """``tests/test_verdict_mesh.py``'s examples."""
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 64, size=(n, L)).astype(np.int32),
        np.ones((n, L), np.float32),
        np.zeros((n, L), np.int32),
        rng.integers(0, 2, size=(n,)).astype(np.int32),
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    assert len(jax.devices()) == RANKS
    data, cases, refs = _data(), {}, {}
    for moe in (False, True):
        j_cfg, t_cfg = configs(**({"moe": MOE} if moe else {}))
        p0 = j_params(j_cfg, 7)
        _, j_hist = j_train_verdict(j_cfg, *data, mesh=None, **KW)
        t_params, t_hist = t_train_verdict(
            t_cfg, *data, init_params=convert.verdict_params_from_numpy(p0, "cpu"),
            device="cpu", **KW)
        refs[moe] = dict(jax=j_hist, port=t_hist, params=_torch_ranks._np(t_params))
        for name, (is_moe, shape) in {**CASES, **PP_CASES}.items():
            if is_moe == moe:
                cases[name] = (t_cfg, p0, shape, {"save": name == "tp_dp"})
    out_dir = str(tmp_path_factory.mktemp("verdict_mesh"))
    got = launch(_torch_ranks.train_verdict_runs, RANKS, cases, data, out_dir,
                 device="cpu", timeout=TIMEOUT)
    return refs, got, out_dir


@pytest.mark.parametrize("case", list(CASES))
def test_train_verdict_mesh_matches_single_device(runs, case):
    """``tests/test_verdict_mesh.py::test_train_verdict_tp_dp_mesh_...``,
    ``::..._dp_only_mesh_...`` and ``::..._3axis_moe_mesh_matches_single_
    device`` on the port."""
    refs, got, _ = runs
    ref, run = refs[CASES[case][0]], got[case]
    assert len(run["history"]) == 2 and run["same_on_every_rank"]
    for want in (ref["jax"], ref["port"]):
        for r, g in zip(want, run["history"]):
            np.testing.assert_allclose(g["train_loss"], r["train_loss"], rtol=2e-5)
            assert g["val_macro_f1"] == r["val_macro_f1"]
    assert_trees_close(run["params"], ref["params"], **PARAM_TOL)


def test_train_verdict_mesh_writes_from_rank_0(runs):
    """The TP x DP run's checkpoint holds the returned (whole) parameters,
    and its metrics log one loss and one F1 an epoch."""
    _, got, out_dir = runs
    _, params, _ = t_infer.load_verdict_checkpoint(f"{out_dir}/tp_dp/ckpt", "cpu")
    assert_trees_close(_torch_ranks._np(params), got["tp_dp"]["params"], rtol=0, atol=0)
    lines = open(f"{out_dir}/tp_dp/log/verdict.jsonl").read().splitlines()
    assert sum("qa_train_loss" in r for r in lines) == 2
    assert sum("qa_val_macro_f1" in r for r in lines) == 2


def _check_pp(runs, case):
    refs, got, _ = runs
    ref, run = refs[PP_CASES[case][0]], got[case]
    assert len(run["history"]) == 2 and run["same_on_every_rank"]
    for want in (ref["jax"], ref["port"]):
        for r, g in zip(want, run["history"]):
            np.testing.assert_allclose(g["train_loss"], r["train_loss"], rtol=2e-5)
            assert g["val_macro_f1"] == r["val_macro_f1"]
    assert_trees_close(run["params"], ref["params"], **PARAM_TOL)


def test_train_verdict_stage_mesh_waits_for_item_12(runs):
    """Once a raise naming ROADMAP.md queue 1 item 12, now
    ``tests/test_verdict_mesh.py::test_train_verdict_pp_dp_mesh_matches_
    single_device``: the same loop runs the GPipe schedule on PP(2) x
    DP(2); the histories (loss and validation F1) and the returned
    parameters, in the standard layout, meet the single device's."""
    _check_pp(runs, "pp_dp")


def test_train_verdict_pp_moe_mesh_matches_single_device(runs):
    """PP(2) over MoE blocks through the loop (the aux from routing sums
    added over microbatches), in the standard layout."""
    _check_pp(runs, "pp_moe")


def test_train_verdict_rejects_pp_tp_mesh(runs):
    _, got, _ = runs
    assert "('stage', 'model')" in got["stage_model"]
