"""Expert parallelism (EP) for the MoE transformer (``models/moe.py``).

Counterpart of ``ircl_tpu/parallel/ep.py``. Expert weights carry a leading
``[E, ...]`` axis, sharded ``P("expert")`` over a ``("data", "expert")``
mesh, so each rank holds ``E / ep`` experts and their Adam moments; on a
``("data", "expert", "model")`` mesh each expert's FFN is Megatron-sharded
over ``model`` too, and the attention takes the TP layout.

The reference's ``make_ep_constrainer`` pins the ``[E, B, C, h]`` expert
slabs to ``P("expert", "data")`` and lets GSPMD lower the dispatch into an
all-to-all. The port realizes the hook as the reference's explicit path
(``moe_ffn``'s ``expert_axis``/``model_axis``, which ``parallel/pp.py``
uses): routing runs on every rank over its replicated tokens, each rank
slices the dispatch and combine tensors to its own experts (an expert's
slots are its own, so the local combine is a partial sum), adds ``ff2.b``
on model rank 0 only, and one sum over ``(expert, model)`` completes the
layer. It is the same function as the all-to-all form; the data crosses
the group as one ``[B, S, h]`` all-reduce a layer instead of two
all-to-alls.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ircl_tpu_torch.parallel.mesh import check_mesh, group_size, make_mesh
from ircl_tpu_torch.parallel.tp import P


def make_ep_mesh(expert: Optional[int] = None, data: Optional[int] = None,
                 device=None):
    """``("data", "expert")`` mesh; defaults to expert = every rank, data = 1."""
    n = group_size(device)
    if expert is None:
        expert = n if data is None else n // data
    if data is None:
        data = n // expert
    assert data * expert == n, (data, expert, n)
    return make_mesh(("data", "expert"), (data, expert), device)


def make_ep_tp_mesh(expert: int, model: int, data: Optional[int] = None,
                    device=None):
    """``("data", "expert", "model")`` mesh for the three-axis DP x EP x TP
    layout."""
    n = group_size(device)
    if data is None:
        data = n // (expert * model)
    assert data * expert * model == n, (data, expert, model, n)
    return make_mesh(("data", "expert", "model"), (data, expert, model), device)


def moe_layer_specs(tp: bool = False) -> Dict[str, Any]:
    """Specs for one ``init_moe_ffn_params`` tree: experts sharded on the
    leading axis, the router replicated. ``tp=True`` also Megatron-shards
    each expert's FFN over ``model``: ff1 column-parallel, ff2 row-parallel."""
    if tp:
        return {
            "router": {"w": P()},
            "ff1": {"w": P("expert", None, "model"), "b": P("expert", "model")},
            "ff2": {"w": P("expert", "model", None), "b": P("expert", None)},
        }
    return {
        "router": {"w": P()},
        "ff1": {"w": P("expert", None, None), "b": P("expert", None)},
        "ff2": {"w": P("expert", None, None), "b": P("expert", None)},
    }


def moe_transformer_param_specs(params: Dict[str, Any], tp: bool = False
                                ) -> Dict[str, Any]:
    """Spec tree of an MoE ``init_transformer_params`` layout: expert weights
    ``P("expert")``; with ``tp=True`` the attention takes the Megatron
    layout over ``model`` and each expert's FFN is TP-sharded too."""
    rep = P()
    ln = {"scale": rep, "bias": rep}
    if tp:
        att_col = {"w": P(None, "model"), "b": P("model")}
        att_row = {"w": P("model", None), "b": rep}
    else:
        att_col = att_row = {"w": rep, "b": rep}
    layer = {
        "q": att_col, "k": att_col, "v": att_col, "o": att_row,
        "attn_ln": ln,
        "moe": moe_layer_specs(tp),
        "ff_ln": ln,
    }
    return {
        "tok_emb": rep,
        "pos_emb": rep,
        "type_emb": rep,
        "emb_ln": ln,
        "layers": [layer for _ in params["layers"]],
    }


def moe_verdict_param_specs(params: Dict[str, Any], tp: bool = False
                            ) -> Dict[str, Any]:
    """Specs for ``init_verdict_params`` over an MoE encoder."""
    rep_dense = {"w": P(), "b": P()}
    return {
        "body": moe_transformer_param_specs(params["body"], tp),
        "head_dense": rep_dense,
        "head_out": rep_dense,
    }


class ExpertParallel:
    """The hook ``make_ep_constrainer`` returns: the mesh whose ``expert``
    axis (and ``model`` axis, where the experts' FFNs shard over it) the
    MoE layer's explicit path runs on. ``moe_ffn`` and the transformer read
    it; it is not called on tensors."""

    def __init__(self, mesh, expert_axis: str = "expert"):
        check_mesh(mesh, expert_axis)
        self.mesh, self.expert_axis = mesh, expert_axis


def make_ep_constrainer(mesh) -> ExpertParallel:
    """Hook for ``moe_ffn(..., ep_constrain=...)`` and the verdict step: EP
    over the mesh's ``expert`` axis, as the explicit path (see the module's
    docstring for why this is the reference's all-to-all function)."""
    return ExpertParallel(mesh)
