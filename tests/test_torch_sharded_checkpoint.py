"""The port's sharded checkpoints (``utils/checkpoint.py::save_sharded`` and
``restore_sharded``) on an 8-rank gloo group, against the reference's run.

Mirrors ``tests/test_sharded_checkpoint.py::
test_sharded_save_restore_resumes_training``: TP(4) x DP(2) trains two
steps, saves without a gather (each rank writes its own shards through
``torch.distributed.checkpoint``), and one more step from the restored
state, on the same layout, equals three uninterrupted steps (rtol 1e-6,
atol 1e-8); the same checkpoint restored onto TP(2) x DP(4), and onto
replicated DP(8) parameters, resumes to the same result within the
reference's cross-layout tolerances (loss rtol 2e-5, parameters rtol 5e-4,
atol 5e-6). The uninterrupted run is also held to the reference's
single-device steps. In the same launch, ``test_pp_sharded_save_restore_
resumes_training``: PP(2) x DP(2) saves its stage-stacked shards after two
steps and resumes to the uninterrupted result (rtol 1e-6, atol 1e-8), its
restored tree restacks onto one stage with every layer's bits kept
(``restack_pp_params``), and the uninterrupted run meets the reference's
single-device steps.
"""

import jax
import numpy as np
import pytest

import _torch_ranks
from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu_torch.parallel.launch import launch
from test_torch_tp import (
    LOSS_TOL,
    PARAM_TOL,
    RANKS,
    TIMEOUT,
    assert_trees_close,
    batch,
    configs,
    j_params,
    j_train,
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    assert len(jax.devices()) == RANKS
    j_cfg, t_cfg = configs()
    p0, batches = j_params(j_cfg, 0), [batch(s) for s in range(3)]
    root = tmp_path_factory.mktemp("sharded")
    pp_case = dict(params0=j_params(j_cfg, 4), batches=[batch(s + 20) for s in range(3)],
                   path=str(root / "ppckpt"))
    got = launch(_torch_ranks.sharded_checkpoint, RANKS, t_cfg, p0, batches,
                 str(root / "ckpt"), pp_case, device="cpu", timeout=TIMEOUT)
    return got, j_train(j_cfg, p0, batches), j_train(j_cfg, pp_case["params0"],
                                                    pp_case["batches"])


def test_sharded_save_restore_resumes_training(runs):
    got, (j_losses, j_params_3), _ = runs
    full = got["uninterrupted"]
    np.testing.assert_allclose(full["loss"], j_losses[-1], **LOSS_TOL)
    assert_trees_close(full["params"], j_params_3, **PARAM_TOL)
    same = got["same"]
    assert same["ff1_w"] == full["ff1_w"] == (16, 8)  # 32 / model(4)
    assert same["restored_count"] == 2 and same["count"] == full["count"] == 3
    np.testing.assert_allclose(same["loss"], full["loss"], rtol=1e-6)
    assert_trees_close(same["params"], full["params"], rtol=1e-6, atol=1e-8)
    # elastic resume: the same checkpoint onto other layouts
    assert got["tp2_dp4"]["ff1_w"] == (16, 16) and got["dp8"]["ff1_w"] == (16, 32)
    for name in ("tp2_dp4", "dp8"):
        assert got[name]["restored_count"] == 2
        np.testing.assert_allclose(got[name]["loss"], full["loss"], rtol=2e-5)
        assert_trees_close(got[name]["params"], full["params"], **PARAM_TOL)


def test_pp_sharded_save_restore_resumes_training(runs):
    """PP(2) x DP(2): the stage-stacked parameters and Adam state save
    sharded (each rank its stage's shard) and resume to the uninterrupted
    result; ``restack_pp_params`` re-cuts the restored tree onto one stage
    with the layer order kept."""
    got, _, (j_losses, j_params_3) = runs
    run = got["pp"]
    np.testing.assert_allclose(run["loss_full"], j_losses[-1], **LOSS_TOL)
    assert_trees_close(run["params_full"], j_params_3, **PARAM_TOL)
    assert run["local"] == (1, 1, 16, 32)  # [2, 1, 16, 32] over 2 stages
    assert run["restacked"] == (1, 2, 16, 32) and run["layers_kept"]
    assert run["restored_count"] == 2 and run["count"] == run["full_count"] == 3
    np.testing.assert_allclose(run["loss"], run["loss_full"], rtol=1e-6)
    assert_trees_close(run["params"], run["params_full"], rtol=1e-6, atol=1e-8)
