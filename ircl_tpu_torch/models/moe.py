"""Mixture-of-Experts FFN (GShard's dense dispatch) for the transformer.

Which router each path uses: this module is the encoder's MoE
(``TransformerConfig.moe``, its verdict and contrastive models and their
expert parallelism): softmax top-k with a capacity limit and dropped tokens,
one-hot dispatch and combine, GELU experts. The Moonlight decoder
(``models/mla_moe.py``) uses ``models/moe_dropless.py`` instead: sigmoid
scores with a correction bias, no capacity and no dropped token, the routed
rows sorted by expert into a grouped GEMM.

Counterpart of ``ircl_tpu/models/moe.py``: top-k routing with a capacity
limit, written as GShard's one-hot dispatch and combine tensors
``[B, S, E, C]`` (group = batch row, or ``group_size`` tokens; S tokens a
group, E experts, C slots an expert) and batched products over an
expert-leading ``[E, ...]`` weight axis. Tokens past an expert's capacity
are dropped: their FFN delta is zero and the residual passes them through.
The router runs in f32; the expert products take their operands at the
input's dtype and accumulate in f32, as the dense FFN does. The aux loss is
Switch's load-balance term, ``E * sum_e f_e * P_e`` over the top-1
assignment fractions and the mean router probabilities (1.0 balanced).

Every function runs under autograd and on the device of its inputs. The
routing follows the reference step for step: ``argmax`` takes the first
maximum; slot positions are an f32 ``cumsum``, exact below 2^24 tokens a
group; a slot index past C selects nothing (``jax.nn.one_hot`` gives zeros
there, so the index is clamped and multiplied by ``keep``); pads select no
expert, use no capacity and stay out of the statistics.

``init_moe_ffn_params`` draws from a ``torch.Generator``, so one seed gives
other bits than the reference's JAX key.

Expert and tensor parallelism run the reference's explicit path
(``expert_axis``, ``model_axis``) on the process groups of a mesh that the
caller names (``mesh=``; explicit SPMD has no global arrays to carry it), or
that ``ep_constrain = parallel.ep.make_ep_constrainer(mesh)`` carries: the
reference's all-to-all hook becomes that same explicit path
(``parallel/ep.py`` says why it is the same function). Any other callable
``ep_constrain`` is applied to the expert slabs as the reference applies it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ircl_tpu_torch.parallel.common import copy_to_group, reduce_from_group
from ircl_tpu_torch.parallel.ep import ExpertParallel
from ircl_tpu_torch.parallel.mesh import axis_groups, axis_rank
from ircl_tpu_torch.utils.convert import to_device
from ircl_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    # per-expert slots C = ceil(capacity_factor * top_k * g / E), g the
    # routing-group length (group_size, or the whole sequence if None)
    capacity_factor: float = 1.25
    # route in groups of this many tokens instead of whole batch rows: the
    # dispatch and combine tensors are [G, g, E, C] with C proportional to
    # g. Must divide the sequence length. None = one group a batch row.
    group_size: Optional[int] = None

    def __post_init__(self):
        if not 1 <= self.top_k <= self.num_experts:
            raise ValueError(
                f"top_k={self.top_k} must be in [1, num_experts="
                f"{self.num_experts}] — re-selecting an exhausted expert "
                "would double-book its capacity slots"
            )


def moe_capacity(group_len: int, ecfg: MoEConfig) -> int:
    """Static per-expert slot count for a given routing-group length."""
    return max(
        1,
        math.ceil(ecfg.capacity_factor * ecfg.top_k * group_len / ecfg.num_experts),
    )


def init_moe_ffn_params(gen: torch.Generator, hidden: int, intermediate: int,
                        num_experts: int, device=None):
    """``{"router", "ff1", "ff2"}`` with expert-leading ``[E, ...]`` weights,
    N(0, 0.02) drawn from ``gen`` on the CPU (router, ff1, ff2, in the
    reference's order) and zero biases, moved to ``device`` (by default the
    card)."""
    device = resolve_device(device)
    E, h, i = num_experts, hidden, intermediate

    def init(shape):
        return 0.02 * torch.randn(shape, generator=gen)

    p = {
        "router": {"w": init((h, E))},
        "ff1": {"w": init((E, h, i)), "b": torch.zeros((E, i))},
        "ff2": {"w": init((E, i, h)), "b": torch.zeros((E, h))},
    }
    return to_device(p, device)


def moe_aux_from_stats(stats) -> torch.Tensor:
    """Switch load-balance aux from raw routing sums: ``f_sum`` [..., E]
    top-1 assignment counts, ``p_sum`` [..., E] summed router
    probabilities, ``n`` [...] the real-token count. The sums of disjoint
    token sets add, so summed stats give the aux of one routing pass."""
    n = torch.clamp(stats["n"], min=1.0)[..., None]
    E = stats["f_sum"].shape[-1]
    return E * torch.sum((stats["f_sum"] / n) * (stats["p_sum"] / n), dim=-1)


def moe_route(
    logits: torch.Tensor,  # [B, S, E] f32
    ecfg: MoEConfig,
    capacity: int,
    mask: Optional[torch.Tensor] = None,  # [B, S], 1 = real token
    return_stats: bool = False,
):
    """Router logits -> ``(dispatch, combine, aux)``, or the raw routing
    sums of ``moe_aux_from_stats`` in place of ``aux`` with
    ``return_stats``. ``dispatch`` [B, S, E, C] is the one-hot token-to-slot
    assignment; ``combine`` is it scaled by the normalized top-k gate. All
    rank-0 picks fill an expert's slots before rank-1 picks, each in token
    order; picks past C are dropped."""
    B, S, E = logits.shape
    C = capacity
    probs = torch.softmax(logits, dim=-1)
    m = None if mask is None else mask.to(probs.dtype)[..., None]  # [B, S, 1]
    remaining = probs
    sels, gates = [], []
    for _ in range(ecfg.top_k):
        idx = torch.argmax(remaining, dim=-1)  # the first maximum, as JAX's
        onehot = F.one_hot(idx, E).to(probs.dtype)
        if m is not None:
            onehot = onehot * m  # pads select nothing
        sels.append(onehot)
        gates.append(torch.sum(probs * onehot, dim=-1))  # [B, S]
        remaining = remaining * (1.0 - onehot)
    denom = sum(gates) + 1e-9

    counts = torch.zeros((B, 1, E), dtype=probs.dtype, device=probs.device)
    dispatch = torch.zeros((B, S, E, C), dtype=probs.dtype, device=probs.device)
    combine = torch.zeros_like(dispatch)
    for onehot, gate in zip(sels, gates):
        # each pick's place in its expert's slot list (pads advance none)
        pos = torch.cumsum(onehot, dim=1) - onehot + counts  # [B, S, E]
        keep = onehot * (pos < C)
        # a place past C selects nothing, as jax.nn.one_hot's zeros there
        slot = F.one_hot(pos.long().clamp(max=C - 1), C).to(probs.dtype) * keep[..., None]
        dispatch = dispatch + slot
        combine = combine + slot * (gate / denom)[..., None, None]
        counts = counts + torch.sum(keep, dim=1, keepdim=True)

    if m is None:
        n_real = torch.tensor(float(B * S), dtype=probs.dtype, device=probs.device)
        p_sum = torch.sum(probs, dim=(0, 1))
    else:
        n_real = torch.sum(m)
        p_sum = torch.sum(probs * m, dim=(0, 1))
    stats = {"f_sum": torch.sum(sels[0], dim=(0, 1)), "p_sum": p_sum, "n": n_real}
    if return_stats:
        return dispatch, combine, stats
    return dispatch, combine, moe_aux_from_stats(stats)


def _product(eq: str, a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``einsum`` of operands at their dtype, multiplied and summed in f32
    and rounded to ``dtype``: the reference's ``preferred_element_type=f32``."""
    return torch.einsum(eq, a.float(), b.float()).to(dtype)


def moe_ffn(
    x: torch.Tensor,  # [B, S, h]
    p,
    ecfg: MoEConfig,
    ep_constrain=None,
    mask: Optional[torch.Tensor] = None,  # [B, S], 1 = real token
    return_stats: bool = False,
    model_axis: Optional[str] = None,
    expert_axis: Optional[str] = None,
    *,
    mesh=None,
):
    """MoE FFN sublayer: ``[B, S, h] -> ([B, S, h], aux)``; with
    ``return_stats`` the routing sums in place of the aux scalar. ``mask``
    keeps pads out of the routing.

    ``expert_axis`` / ``model_axis`` (on ``mesh``), or ``ep_constrain``
    from ``make_ep_constrainer``: the explicit EP/TP path. The expert
    weights arrive sharded ``[E / ep, ...]`` on their leading axis (and
    Megatron-sharded on ff1's columns and ff2's rows under ``model_axis``);
    ``x`` is replicated over those axes. Routing runs on every rank, each
    rank dispatches to and runs its own experts only (a slice of the
    dispatch and combine tensors), ``ff2.b`` is added on model rank 0
    only, and one sum over the expert and model groups restores the whole
    combine. The gradients of ``x`` and of the combine weights that the
    local experts see are partial, and are summed over the same groups
    (Megatron's f). Explicit axes and ``ep_constrain`` are exclusive."""
    if (model_axis or expert_axis) and ep_constrain is not None:
        raise ValueError("explicit axes and ep_constrain are exclusive")
    if isinstance(ep_constrain, ExpertParallel):
        # on a mesh with a "model" axis the experts' FFNs shard over it too
        # (parallel/ep.py::moe_layer_specs(tp=True), as train_verdict lays
        # them out)
        mesh, expert_axis, ep_constrain = ep_constrain.mesh, ep_constrain.expert_axis, None
        if "model" in (mesh.mesh_dim_names or ()):
            model_axis = "model"
    Bo, So, h = x.shape
    if ecfg.group_size is not None and ecfg.group_size < So:
        g = ecfg.group_size
        if So % g:
            raise ValueError(f"group_size={g} must divide the sequence length {So}")
        x = x.reshape(Bo * (So // g), g, h)
        if mask is not None:
            mask = mask.reshape(Bo * (So // g), g)
    S = x.shape[1]  # G groups of g tokens (batch rows if ungrouped)
    dtype = x.dtype
    logits = x.float() @ p["router"]["w"].float()  # [B, S, E], f32
    dispatch, combine, aux = moe_route(
        logits, ecfg, moe_capacity(S, ecfg), mask, return_stats=return_stats
    )
    joint = axis_groups(mesh, expert_axis, model_axis)
    x_in, combine = copy_to_group(x, joint), copy_to_group(combine, joint)
    if expert_axis is not None:  # this rank's experts: a partial combine
        e_loc = p["ff1"]["w"].shape[0]
        e0 = axis_rank(mesh, expert_axis) * e_loc
        dispatch = dispatch[:, :, e0 : e0 + e_loc]
        combine = combine[:, :, e0 : e0 + e_loc]
    ein = _product("bsec,bsh->ebch", dispatch.to(dtype), x_in, dtype)  # expert slabs
    if ep_constrain is not None:
        ein = ep_constrain(ein)
    h1 = F.gelu(  # exact (erf) GELU
        _product("ebch,ehi->ebci", ein, p["ff1"]["w"].to(dtype), dtype)
        + p["ff1"]["b"][:, None, None, :]
    )
    eout = _product("ebci,eih->ebch", h1, p["ff2"]["w"].to(dtype), dtype)
    ff2_b = p["ff2"]["b"]
    if model_axis is not None:
        # ff2's rows are sharded, eout is a partial sum: the bias is added on
        # model rank 0 alone, so that the sum below adds it once; its
        # gradient (rank 0's, zeros elsewhere) is summed over the axis
        first = float(axis_rank(mesh, model_axis) == 0)
        ff2_b = copy_to_group(ff2_b, axis_groups(mesh, model_axis)) * first
    eout = eout + ff2_b[:, None, None, :]
    if ep_constrain is not None:
        eout = ep_constrain(eout)
    y = _product("bsec,ebch->bsh", combine.to(dtype), eout, dtype)
    y = reduce_from_group(y, joint)
    return y.reshape(Bo, So, h), aux
