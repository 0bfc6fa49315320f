"""The port's expert parallelism on an 8-rank gloo group against
``ircl_tpu.parallel.ep`` on the 8-device virtual mesh (``tests/conftest.py``).

Mirrors ``tests/test_ep.py``'s parallel tests on its config (4 experts,
top-2, capacity factor 2, 2 layers, hidden 16, L=16, B=8):
``test_ep_dp_matches_single_device`` (EP(4) x DP(2), three steps),
``test_ep_params_actually_sharded`` (the local expert shards and their
moments) and ``test_ep_tp_dp_matches_single_device`` (EP(2) x TP(2) x
DP(2)). The reference's hook pins the expert slabs for GSPMD's
all-to-all; the port's runs the explicit path (``parallel/ep.py``), one
launch of 8 CPU ranks for every case. Tolerances are the reference's:
losses rtol 2e-5 (atol 2e-6), parameters rtol 5e-4 (atol 5e-6).

Beyond the reference's tests: the first step's gradients against the
port's single device (``test_torch_tp.py``'s GRAD_TOL), and the MoE aux
under data parallelism with data shards of unequal real-token counts (the
aux is a product of means over the whole batch: the ranks' routing sums are
summed before it is formed), on parameters drawn away from zero so that
``ff2.b``, added on model rank 0 alone, is not a zero.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_ranks
from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.parallel import ep as j_ep
from ircl_tpu.verdict import model as j_model
from ircl_tpu_torch.models import moe as t_moe
from ircl_tpu_torch.parallel.launch import launch
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.verdict import model as t_model
from test_torch_tp import (
    GRAD_TOL,
    LOSS_TOL,
    PARAM_TOL,
    RANKS,
    TIMEOUT,
    _off_zero,
    assert_layout,
    assert_trees_close,
    batch,
    configs,
    j_params,
    j_train,
    t_single,
)

MOE = dict(num_experts=4, top_k=2, capacity_factor=2.0)


def _unequal_mask():
    """Data rank 0's rows (0-3) end in pads of several lengths; rank 1's
    are whole: the ranks route other numbers of real tokens."""
    mask = np.ones((8, 16), np.float32)
    for row, n in enumerate((3, 9, 12, 6)):
        mask[row, n:] = 0.0
    return mask


@pytest.fixture(scope="module")
def runs():
    assert len(jax.devices()) == RANKS
    j_cfg, t_cfg = configs(moe=MOE)
    layouts = {
        "ep_dp": (dict(data=2, expert=4), "ep", j_ep.make_ep_mesh(expert=4, data=2),
                  j_params(j_cfg, 0), [batch(s) for s in range(3)]),
        "ep_tp_dp": (dict(data=2, expert=2, model=2), "ep_tp",
                     j_ep.make_ep_tp_mesh(expert=2, model=2, data=2),
                     j_params(j_cfg, 9), [batch(s + 60) for s in range(3)]),
        "aux_unequal": (dict(data=2, expert=2, model=2), "ep_tp", None,
                        _off_zero(j_params(j_cfg, 3), 4),
                        [batch(70 + s, mask=_unequal_mask()) for s in range(2)]),
    }
    cases, refs = {}, {}
    for name, (shape, kind, mesh, p0, batches) in layouts.items():
        cases[name] = ("verdict_sharded_steps", dict(
            cfg=t_cfg, params0=p0, batches=batches, shape=shape, kind=kind, grads=True))
        refs[name] = dict(single=j_train(j_cfg, p0, batches),
                          port=t_single(t_cfg, p0, batches))
        if mesh is not None:
            specs = j_ep.moe_verdict_param_specs(p0, tp=kind == "ep_tp")
            refs[name]["mesh"] = j_train(j_cfg, p0, batches, mesh, specs,
                                         ep_constrain=j_ep.make_ep_constrainer(mesh))
    # sequence parallelism over the three-axis layout: the MoE layer takes
    # the whole sequence, every block the TP/SP collectives
    p0, batches = layouts["aux_unequal"][3], layouts["aux_unequal"][4]
    cases["ep_tp_sp"] = ("verdict_sharded_steps", dict(
        cfg=t_cfg, params0=p0, batches=batches, shape=dict(data=2, expert=2, model=2),
        kind="ep_tp", sp=True, grads=True))
    p0, (ids, mask, types, _) = layouts["aux_unequal"][3], layouts["aux_unequal"][4][0]
    cases["aux_forward"] = ("verdict_sharded_forward", dict(
        cfg=t_cfg, params0=p0, arrays=(ids, mask, types), shape=dict(data=2, expert=2,
                                                                     model=2),
        kind="ep_tp", what="apply"))
    refs["aux_forward"] = jax.jit(j_model.verdict_apply_with_aux, static_argnums=1)(
        p0, j_cfg, ids, mask, types)
    for name, shape, kind in (("shapes_ep", dict(data=2, expert=4), "ep"),
                              ("shapes_ep_tp", dict(data=2, expert=2, model=2), "ep_tp")):
        cases[name] = ("verdict_local_shapes", dict(cfg=t_cfg, params0=j_params(j_cfg, 1),
                                                    shape=shape, kind=kind))
    got = launch(_torch_ranks.parallel_runs, RANKS, cases, device="cpu", timeout=TIMEOUT)
    return refs, got


@pytest.mark.parametrize("case", ["ep_dp", "ep_tp_dp"])
def test_ep_matches_single_device(runs, case):
    """``tests/test_ep.py::test_ep_dp_matches_single_device`` (EP(4) x DP(2))
    and ``::test_ep_tp_dp_matches_single_device`` (EP(2) x TP(2) x DP(2)):
    losses and parameters against the reference's single device and its
    GSPMD mesh, and against the port's single device; the first step's
    gradients against the port's."""
    refs, got = runs
    got, ref = got[case], refs[case]
    for losses, params in (ref["single"], ref["mesh"], ref["port"][1:]):
        np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL)
        assert_trees_close(got["params"], params, **PARAM_TOL)
    assert_trees_close(got["grads"], ref["port"][0], **GRAD_TOL)
    assert_layout(got["layout"])


def test_ep_params_actually_sharded(runs):
    """``tests/test_ep.py::test_ep_params_actually_sharded``, and the local
    shards of ``test_ep_tp_dp_matches_single_device``: experts 4 / ep, each
    expert's ff1 columns 32 / tp, and the moments alike."""
    _, got = runs
    moe = got["shapes_ep"]["params"]["body"]["layers"][0]["moe"]
    assert moe["ff1"]["w"] == (1, 16, 32) and moe["router"]["w"] == (16, 4)
    assert got["shapes_ep"]["mu"]["body"]["layers"][0]["moe"]["ff1"]["w"] == (1, 16, 32)
    layer = got["shapes_ep_tp"]["params"]["body"]["layers"][0]
    assert layer["moe"]["ff1"]["w"] == (2, 16, 16)
    assert layer["moe"]["ff2"]["w"] == (2, 16, 16) and layer["moe"]["ff2"]["b"] == (2, 16)
    assert layer["q"]["w"] == (16, 8)


def test_ep_aux_with_unequal_real_tokens_matches_single_device(runs):
    """The load-balance aux of a batch whose data shards hold 30 and 64 real
    tokens: the whole batch's aux on every rank (the reference's, which a
    mean of the ranks' auxes would miss), the logits, two training steps and
    the first step's gradients, against the reference's and the port's
    single device."""
    refs, got = runs
    logits, aux = refs["aux_forward"]
    fwd = got["aux_forward"]
    np.testing.assert_allclose(fwd["logits"], np.asarray(logits), **LOSS_TOL)
    np.testing.assert_allclose(fwd["aux"], float(aux), rtol=1e-6)
    run, ref = got["aux_unequal"], refs["aux_unequal"]
    for losses, params in (ref["single"], ref["port"][1:]):
        np.testing.assert_allclose(run["losses"], losses, **LOSS_TOL)
        assert_trees_close(run["params"], params, **PARAM_TOL)
    assert_trees_close(run["grads"], ref["port"][0], **GRAD_TOL)
    assert_layout(run["layout"])


def test_ep_tp_with_sequence_parallelism_matches_single_device(runs):
    """``make_sp_constrainer`` on the EP(2) x TP(2) x DP(2) layout of the MoE
    encoder (the reference's SP annotation composes with its MoE layer):
    the MoE layer routes the whole sequence gathered from the ranks' rows,
    and the losses, parameters and first gradients meet the single device's
    (unequal real tokens, parameters off zero)."""
    refs, got = runs
    run, ref = got["ep_tp_sp"], refs["aux_unequal"]
    for losses, params in (ref["single"], ref["port"][1:]):
        np.testing.assert_allclose(run["losses"], losses, **LOSS_TOL)
        assert_trees_close(run["params"], params, **PARAM_TOL)
    assert_trees_close(run["grads"], ref["port"][0], **GRAD_TOL)
    assert_layout(run["layout"])


def test_explicit_axes_and_ep_constrain_are_exclusive():
    """The reference's ``ValueError``, before any collective."""
    x = torch.zeros(1, 4, 16)
    p = t_moe.init_moe_ffn_params(torch.Generator().manual_seed(0), 16, 32, 4, "cpu")
    for axis in ("expert_axis", "model_axis"):
        with pytest.raises(ValueError, match="exclusive"):
            t_moe.moe_ffn(x, p, t_moe.MoEConfig(num_experts=4), ep_constrain=lambda t: t,
                          **{axis: "x"})


def test_a_callable_ep_constrain_is_applied_to_the_slabs():
    """Any other callable is applied to the expert slabs as the reference
    applies it: the identity leaves the layer as it is."""
    _, t_cfg = configs(moe=MOE)
    params = convert.verdict_params_from_numpy(j_params(configs(moe=MOE)[0], 2), "cpu")
    ids, mask, types, _ = (torch.as_tensor(a) for a in batch(5))
    seen = []
    want = t_model.verdict_apply(params, t_cfg, ids.long(), mask, types.long())
    got, aux = t_model.verdict_apply_with_aux(
        params, t_cfg, ids.long(), mask, types.long(),
        ep_constrain=lambda t: seen.append(t.shape) or t)
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
    assert seen == [(4, 8, 16, 16)] * 4  # [E, B, C, h], ein and eout of 2 layers
