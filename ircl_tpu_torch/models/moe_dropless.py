"""Dropless MoE with DeepSeek-V3's sigmoid router: route, sort, grouped GEMM.

The Moonlight decoder's expert layer (``models/mla_moe.py``); GShard's
capacity-limited softmax router in ``models/moe.py`` stays the encoder's.

Routing (``route``, the published ``noaux_tc`` gate with one group): router
logits ``x W_g^T`` in f32, scores ``s = sigmoid(logits)``, the top k experts
of ``s + e_score_correction_bias`` picked (best first), weighted by their
unbiased scores normalised to sum to 1 and times ``routed_scaling_factor``.
No token is dropped, and pads route nowhere.

Dispatch (``dispatch``): the ``T * k`` picks get the key of their expert,
pads the key ``E``; a stable sort by key lays the routed rows out expert by
expert, in token order within an expert, and ``offsets [E + 1]`` (int32, by
a search of the sorted keys) bounds each expert's run, ``offsets[E]`` the
number of routed rows. Every shape is fixed by ``T`` and ``k``: nothing is
read back to the host, so the forward never waits for the card.

Experts (``experts``): the rows gathered into one ``[T * k, h]`` buffer go
through two grouped GEMMs (``ops/moe_grouped_gemm_cuda.py``): gate and up
in one, with ``silu(g) * u`` in its epilogue, then down.

Combine (``combine``): each token gathers its k output rows in pick order
and sums them weighted, in f32, then rounds to bf16; no atomic adds, so the
result does not depend on the order the card runs in.
"""

from __future__ import annotations

import torch

from ircl_tpu_torch.ops.moe_grouped_gemm_cuda import grouped_gemm


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, top_k: int,
          scaling: float, normalize: bool = True):
    """``x [T, h]`` (bf16), ``router [E, h]``, ``bias [E]`` (f32) ->
    (expert ids ``[T, top_k]`` best biased score first, weights
    ``[T, top_k]`` f32)."""
    scores = torch.sigmoid(x.float() @ router.float().T)
    _, idx = torch.topk(scores + bias.float(), top_k, dim=-1)
    weight = scores.gather(-1, idx)
    if normalize and top_k > 1:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    return idx, weight * scaling


def dispatch(idx: torch.Tensor, real: torch.Tensor, num_experts: int):
    """(``order [T * k]``: the pick behind each sorted row, ``offsets
    [E + 1]`` int32) of ``idx [T, k]`` with pads (``real`` false) routed
    nowhere, past ``offsets[E]``."""
    key = torch.where(real[:, None], idx, num_experts).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(num_experts + 1, device=key.device, dtype=sorted_key.dtype)
    offsets = torch.searchsorted(sorted_key, bounds).to(torch.int32)
    return order, offsets


def experts(x: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor, w13: torch.Tensor,
            down: torch.Tensor, top_k: int) -> torch.Tensor:
    """The routed rows' expert outputs ``[T * k, h]`` in sorted order: the
    token of each sorted row gathered from ``x [T, h]``, then
    ``down(silu(gate) * up)`` by its expert (``w13 [E, 2I, h]`` interleaved,
    ``down [E, h, I]``)."""
    rows = x.index_select(0, order // top_k)
    hidden = grouped_gemm(rows, w13, offsets, swiglu=True)
    return grouped_gemm(hidden, down, offsets)


def combine(out: torch.Tensor, order: torch.Tensor, weight: torch.Tensor,
            real: torch.Tensor) -> torch.Tensor:
    """``[T, h]`` bf16: each real token's k expert rows (``out`` in sorted
    order) weighted and summed in f32; pads get zeros."""
    T, k = weight.shape
    place = torch.empty_like(order)
    place[order] = torch.arange(order.numel(), device=order.device)
    mine = out.index_select(0, place).view(T, k, -1).float()
    y = (mine * weight[..., None]).sum(1)
    return torch.where(real[:, None], y, 0.0).to(out.dtype)
