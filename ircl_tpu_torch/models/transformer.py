"""BERT-compatible transformer encoder on tensors.

Counterpart of ``ircl_tpu/models/transformer.py``, which stands in for the
reference's HuggingFace ``BertModel`` featurizer
(``src/contrastor/contrastive_module.py:32-41``): learned word / position /
token-type embeddings and post-LN encoder blocks (MHA -> Add&LN -> exact
GELU FFN -> Add&LN). Parameters are a plain dict of tensors with the JAX
package's layout (dense weights ``[in, out]``), so ``utils/convert.py``
carries them across unchanged.

Ported: the dense model and the MoE FFN (``models/moe.py``, in place of
``ff1``/``ff2`` in every block) on both attention paths, in float32 and in
bfloat16. ``"xla"`` adds a -1e9 pad bias and takes a plain softmax;
``"flash"`` (the verdict model's) gives pads segment 0 and real tokens
segment 1 and calls ``ops/flash_attention_cuda.py::flash_attention``, which
launches CUDA kernels on the card, forward and backward. Every function here
runs under autograd: verdict training differentiates the whole body, the
matrix products and LayerNorms through autograd and the flash attention
through its own backward kernels. LayerNorm is the population variance with
``layernorm_eps`` (1e-12), as ``_ln`` computes it. The embedding gathers
clamp their indices into range, as JAX's gather does: the verdict model has
one token type while the pair encoder writes type 1 after the first
``[SEP]``, and the reference then reads row 0. Like the transpose of JAX's
gather, the gradient of a clamped read is dropped, not added to the row it
read.

``dtype=torch.bfloat16`` rounds where the reference rounds, and nowhere
else. The reference's LayerNorm multiplies by an f32 scale, so every
LayerNorm returns f32 and every projection of q, k, v, the FFN and the head
run in f32; the flash kernels always receive f32 q, k and v. The roundings
to bf16 are: the embedding sum; the embedding LayerNorm's normalize step
(mean and variance in f32 rounded to bf16, then the subtraction, ``+ eps``,
``rsqrt`` and their product in bf16); the pad bias (-1e9 becomes
-998244352); the softmax's probabilities; the attention context (``probs @
v`` or the flash output, taken in f32); and the o-projection, whose bf16
operands are multiplied in f32 before the result is rounded.

Tensor and expert parallelism (``parallel/tp.py``, ``parallel/ep.py``) run
the reference's explicit ``model_axis``/``expert_axis`` path on the process
groups of ``mesh=``: each rank holds its slices of the weights, the local
head count comes from the local q width, Megatron's f goes before q/k/v
and ff1, g after o and ff2 (the o-projection rounded to ``dtype`` before
its sum, as the reference rounds it), and ``o.b`` and ``ff2.b`` are added
after the sum. With ``attention="flash"`` every rank calls the flash
kernels on its own heads, as the reference's GSPMD path runs flash on its
sharded heads (its explicit path alone refuses flash). The ``constrain``
hook of ``parallel.tp.make_sp_constrainer`` turns on sequence parallelism;
any other callable is applied to the activations as the reference applies
it.

Context parallelism (``parallel/cp.py``) runs the reference's ``seq_axis``
path: ``x`` and the pad bias hold this rank's block of the sequence,
``transformer_embed(pos_start=)`` gives the block its global positions, and
the attention is ``ops/ring_attention.py``'s ring over the axis (the
position-wise LayerNorms and FFN need no collective). As in the reference
it refuses ``attention="flash"`` and MoE blocks.

``from_huggingface`` maps a local HuggingFace BERT or RoBERTa checkpoint
(read by ``models/hf_checkpoint.py``, without ``transformers``) onto this
parameter tree, as the reference maps ``AutoModel``'s state dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ircl_tpu_torch.models.moe import (
    MoEConfig,
    init_moe_ffn_params,
    moe_aux_from_stats,
    moe_ffn,
)
from ircl_tpu_torch.ops.flash_attention_cuda import SegmentIds, flash_attention
from ircl_tpu_torch.ops.ring_attention import ring_attention
from ircl_tpu_torch.parallel.common import (
    copy_to_group,
    gather_data_rows,
    gather_seq,
    reduce_from_group,
    reduce_scatter_seq,
    scatter_seq,
)
from ircl_tpu_torch.parallel.ep import ExpertParallel
from ircl_tpu_torch.parallel.mesh import axis_groups, axis_size, check_mesh
from ircl_tpu_torch.parallel.tp import SequenceParallel
from ircl_tpu_torch.utils.convert import to_device
from ircl_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 512
    type_vocab: int = 2
    layernorm_eps: float = 1e-12
    # roberta uses padding_idx-offset position ids (first real position = 2)
    position_offset: int = 0
    dtype: Any = torch.float32
    # "xla" (a plain softmax) or "flash" (the CUDA flash-attention kernel;
    # pads are kept apart by segment ids)
    attention: str = "xla"
    # Mixture-of-Experts FFN in every block (models/moe.py); None = dense.
    # When set, transformer_block returns (x, aux) and training uses
    # transformer_apply_with_aux for the load-balance loss.
    moe: Optional[MoEConfig] = None

    def __post_init__(self):
        if self.attention not in ("xla", "flash"):
            raise ValueError(f"unknown attention {self.attention!r}")


def _dense_init(gen, shape, scale=0.02):
    return scale * torch.randn(shape, generator=gen)


def init_transformer_params(
    gen: torch.Generator, cfg: TransformerConfig, device=None
) -> Dict:
    """N(0, 0.02) weights, zero biases, unit LayerNorm scales, drawn from
    ``gen`` on the CPU in the reference's order and moved to ``device`` (by
    default the card)."""
    device = resolve_device(device)
    h, i = cfg.hidden, cfg.intermediate

    def ln():
        return {"scale": torch.ones(h), "bias": torch.zeros(h)}

    p: Dict[str, Any] = {
        "tok_emb": _dense_init(gen, (cfg.vocab_size, h)),
        "pos_emb": _dense_init(gen, (cfg.max_positions + cfg.position_offset, h)),
        "type_emb": _dense_init(gen, (cfg.type_vocab, h)),
        "emb_ln": ln(),
        "layers": [],
    }
    for _ in range(cfg.layers):
        lp = {
            name: {"w": _dense_init(gen, (h, h)), "b": torch.zeros(h)}
            for name in ("q", "k", "v", "o")
        }
        lp["attn_ln"] = ln()
        lp["ff_ln"] = ln()
        if cfg.moe is not None:
            lp["moe"] = init_moe_ffn_params(gen, h, i, cfg.moe.num_experts, "cpu")
        else:
            lp["ff1"] = {"w": _dense_init(gen, (h, i)), "b": torch.zeros(i)}
            lp["ff2"] = {"w": _dense_init(gen, (i, h)), "b": torch.zeros(h)}
        p["layers"].append(lp)
    return to_device(p, device)


class _LowPrecisionLayerNorm(torch.autograd.Function):
    """LayerNorm of a bf16 (or other low-precision) ``x`` with the
    reference's roundings, forward and backward. Forward: mean and
    population variance in f32, each rounded to ``x``'s dtype; ``x - mu``,
    ``+ eps``, ``rsqrt`` and the product at that dtype; the f32 scale and
    bias make the result f32. Backward: the steps of ``jax.vjp`` through the
    reference's ``_ln``, rounding where it rounds: the cotangent reaches
    ``x``'s dtype before the normalize step, the products and row sums there
    stay at that dtype, the variance's and the mean's branches run in f32 and
    are rounded before they are added in."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        dt, n = x.dtype, x.shape[-1]
        xf = x.float()
        mu = xf.sum(dim=-1, keepdim=True) / n
        t = xf - mu
        var = t.square().sum(dim=-1, keepdim=True) / n
        d = x - mu.to(dt)
        e = var.to(dt) + torch.tensor(eps, dtype=dt, device=x.device)
        r = torch.rsqrt(e.float()).to(dt)  # f32 rsqrt, rounded once
        y = (d * r).float()
        ctx.save_for_backward(d, e, r, t, y, scale)
        return y * scale + bias

    @staticmethod
    def backward(ctx, g):
        d, e, r, t, y, scale = ctx.saved_tensors
        dt, n = d.dtype, d.shape[-1]
        gy = (g * scale).to(dt)
        g_d = gy * r
        g_e = (d * gy).sum(dim=-1, keepdim=True) * ((r.float() / e.float()).to(dt) * -0.5)
        g_t = (g_e.float() / n) * (2.0 * t)  # the variance's branch, in f32
        g_t = g_t + (-g_t).sum(dim=-1, keepdim=True) / n
        g_mu = (-g_d).sum(dim=-1, keepdim=True)
        g_x = (g_d + g_t.to(dt)) + (g_mu.float() / n).to(dt)
        lead = tuple(range(g.dim() - 1))
        return g_x, (y * g).sum(dim=lead), g.sum(dim=lead), None


def _ln(x, p, eps):
    """LayerNorm, population variance. A float32 ``x`` takes
    ``F.layer_norm``; any other dtype is normalized as the reference's
    ``jnp`` code rounds it (``_LowPrecisionLayerNorm``), and the f32 scale
    and bias make the result f32."""
    if x.dtype == torch.float32:
        return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)
    return _LowPrecisionLayerNorm.apply(x, p["scale"], p["bias"], eps)


def _matmul(a, b, dtype):
    """``a @ b`` with the operands at their dtype multiplied and summed in
    f32, rounded to ``dtype``: the reference's ``preferred_element_type=f32``
    (exact products of bf16 operands; the identity in float32)."""
    return (a.float() @ b.float()).to(dtype)


def _dense(x, p):
    return _matmul(x, p["w"].to(x.dtype), x.dtype) + p["b"]


def transformer_embed(
    params: Dict,
    cfg: TransformerConfig,
    ids: torch.Tensor,  # [B, L] int
    type_ids: Optional[torch.Tensor] = None,
    pos_start: int = 0,  # the first position: a context-parallel rank's
    #   block starts at seq_rank * L_local
) -> torch.Tensor:
    """Embedding sum + embedding layernorm -> [B, L, hidden]. Every gather
    index is clamped into its table, as JAX's gather clamps it; an index
    that was out of range passes no gradient to the row it read, as the
    transpose of JAX's gather drops it."""

    def rows(table, idx):
        n = table.shape[0]
        out = table[idx.clamp(0, n - 1)]
        if not (torch.is_grad_enabled() and table.requires_grad):
            return out
        in_range = ((idx >= 0) & (idx < n))[..., None]
        return torch.where(in_range, out, out.detach())

    L = ids.shape[1]
    pos = torch.arange(L, device=ids.device) + cfg.position_offset + pos_start
    types = (
        rows(params["type_emb"], type_ids)
        if type_ids is not None
        else params["type_emb"][0][None, None, :]
    )
    x = (
        rows(params["tok_emb"], ids)
        + rows(params["pos_emb"], pos)[None, :, :]
        + types
    ).to(cfg.dtype)
    return _ln(x, params["emb_ln"], cfg.layernorm_eps)


def attention_mask_inputs(cfg: TransformerConfig, mask: torch.Tensor):
    """Per-batch attention context: an additive pad bias [B, 1, 1, L] (0 on
    real tokens, -1e9 on pads) for "xla", ``SegmentIds`` for "flash"."""
    if cfg.attention == "flash":
        # pads get segment 0 and real tokens segment 1: every real query
        # row sees the real keys only, as under the pad bias; pad rows
        # attend to the pads, and pooling never reads them
        seg = mask.to(torch.int32)
        return SegmentIds(q=seg, kv=seg)
    neg = torch.tensor(-1e9, dtype=cfg.dtype, device=mask.device)
    return (1.0 - mask[:, None, None, :].to(cfg.dtype)) * neg


def _column_input(x, groups, sp_group):
    """The replicated input of a column-parallel product: the whole
    sequence gathered under sequence parallelism, else ``x`` under f."""
    return gather_seq(x, sp_group) if sp_group is not None else copy_to_group(x, groups)


def _row_output(partial, groups, sp_group):
    """A row-parallel product's partial sums, summed: reduce-scattered along
    the sequence under sequence parallelism, else all-reduced (g)."""
    if sp_group is not None:
        return reduce_scatter_seq(partial, sp_group)
    return reduce_from_group(partial, groups)


def _on_rows(tree, groups, sp_group):
    """Replicated parameters used on a rank's rows of the sequence: their
    gradients are partial and are summed over the axis (f)."""
    if sp_group is None:
        return tree
    return {k: copy_to_group(v, groups) for k, v in tree.items()}


def attention_sublayer(
    x: torch.Tensor,  # [B, L, hidden] ([B, L / m, hidden] under SP)
    lp: Dict,  # one entry of params["layers"]
    cfg: TransformerConfig,
    attn_ctx,  # attention_mask_inputs(cfg, mask)
    model_axis: Optional[str] = None,
    seq_axis: Optional[str] = None,
    *,
    mesh=None,
    sequence_parallel: bool = False,
) -> torch.Tensor:
    """MHA -> Add&LN (the first half of a post-LN block). ``model_axis``:
    the q/k/v/o weights arrive column/row-sharded over that axis of
    ``mesh``, the head count is the local q width's, and the o-projection's
    partial sums are summed over the axis; ``sequence_parallel``: ``x``
    holds this rank's rows of the sequence (``make_sp_constrainer``).
    ``seq_axis``: ``x`` and ``attn_ctx`` hold this rank's block of the
    sequence over that axis of ``mesh`` and the attention runs as ring
    attention (``ops/ring_attention.py``)."""
    if seq_axis is not None and cfg.attention == "flash":
        raise ValueError("ring-attention CP supports the XLA path")
    groups = axis_groups(mesh, model_axis)
    sp_group = groups[0] if sequence_parallel and groups else None
    xin = _column_input(x, groups, sp_group)
    B, L, _ = xin.shape
    hd = cfg.hidden // cfg.heads
    nh = lp["q"]["w"].shape[-1] // hd  # local heads (cfg.heads unsharded)

    def heads(p):
        return _dense(xin, p).reshape(B, L, nh, hd).transpose(1, 2)

    q, k, v = heads(lp["q"]), heads(lp["k"]), heads(lp["v"])
    if seq_axis is not None:
        ctx = ring_attention(q, k, v, attn_ctx, seq_axis, mesh=mesh)
    elif cfg.attention == "flash":
        ctx = flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), segment_ids=attn_ctx,
            causal=False, sm_scale=1.0 / math.sqrt(hd),
        ).to(cfg.dtype)
    else:
        logits = _matmul(q, k.transpose(-1, -2), torch.float32) / math.sqrt(hd) + attn_ctx
        probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
        ctx = _matmul(probs, v, cfg.dtype)
    ctx = ctx.transpose(1, 2).reshape(B, L, nh * hd)
    proj = _row_output(_matmul(ctx, lp["o"]["w"].to(cfg.dtype), cfg.dtype), groups, sp_group)
    rows = _on_rows({"b": lp["o"]["b"], **lp["attn_ln"]}, groups, sp_group)
    return _ln(x + (proj + rows.pop("b")), rows, cfg.layernorm_eps)


def transformer_block(
    x: torch.Tensor,  # [B, L, hidden] ([B, L / m, hidden] under SP)
    lp: Dict,
    cfg: TransformerConfig,
    attn_ctx,
    ep_constrain=None,
    moe_mask: Optional[torch.Tensor] = None,  # [B, L] 1 = real token
    moe_stats: bool = False,
    model_axis: Optional[str] = None,
    expert_axis: Optional[str] = None,
    seq_axis: Optional[str] = None,
    *,
    mesh=None,
    sequence_parallel: bool = False,
):
    """One post-LN encoder block (MHA -> Add&LN -> FFN -> Add&LN). With
    ``cfg.moe`` the FFN is the MoE layer and the block returns ``(x, aux)``;
    ``moe_mask`` keeps pads out of the routing, and ``moe_stats`` returns
    the routing sums (``models.moe.moe_aux_from_stats``) in place of aux.
    ``model_axis``/``expert_axis``: the explicit TP/EP path over those axes
    of ``mesh`` (the sums the reference's ``lax.psum`` takes, each with its
    backward); ``sequence_parallel`` and ``seq_axis`` as in
    ``attention_sublayer``. Context parallelism refuses MoE blocks, as the
    reference does."""
    if seq_axis is not None and cfg.moe is not None:
        raise ValueError(
            "context parallelism does not compose with MoE blocks: local "
            "routing capacity would differ from the global routing"
        )
    x = attention_sublayer(x, lp, cfg, attn_ctx, model_axis, seq_axis, mesh=mesh,
                           sequence_parallel=sequence_parallel)
    groups = axis_groups(mesh, model_axis)
    sp_group = groups[0] if sequence_parallel and groups else None
    ln = _on_rows(lp["ff_ln"], groups, sp_group)
    if cfg.moe is not None:
        # the MoE layer routes every token on every rank and sums its own
        # gradients over the axes: under SP it takes the whole sequence,
        # whose gradient is then whole on every rank
        xm = x if sp_group is None else gather_seq(x, sp_group, reduce_grad=False)
        y, aux = moe_ffn(xm, lp["moe"], cfg.moe, ep_constrain, moe_mask,
                         return_stats=moe_stats, model_axis=model_axis,
                         expert_axis=expert_axis, mesh=mesh)
        if sp_group is not None:
            y = scatter_seq(y, sp_group)
        return _ln(x + y, ln, cfg.layernorm_eps), aux
    h1 = F.gelu(_dense(_column_input(x, groups, sp_group), lp["ff1"]))  # exact GELU
    ff = _row_output(_matmul(h1, lp["ff2"]["w"].to(h1.dtype), h1.dtype), groups, sp_group)
    b = lp["ff2"]["b"] if sp_group is None else copy_to_group(lp["ff2"]["b"], groups)
    return _ln(x + (ff + b), ln, cfg.layernorm_eps)


def _sharded_axis(mesh, axis, local: int, whole: int, what: str) -> Optional[str]:
    """``axis`` if ``mesh`` has it and the local width is the whole one
    divided over it; ``None`` if the width is whole; ``ValueError`` for any
    other width."""
    if local == whole:
        return None
    names = () if mesh is None else (mesh.mesh_dim_names or ())
    if axis not in names or local * axis_size(mesh, axis) != whole:
        raise ValueError(f"{what} is {local} wide of {whole}: not a shard over "
                         f"the mesh's {axis!r} axis {names}")
    return axis


def _parallel_layout(params: Dict, cfg: TransformerConfig, mesh=None, constrain=None,
                    ep_constrain=None):
    """Which axes of the mesh shard ``params``, read from the local shapes as
    the reference's explicit path reads its head count: ``(mesh,
    model_axis, expert_axis, data_groups, sequence_parallel)``. The mesh
    may come from ``mesh=`` or from a hook that carries one."""
    for hook in (constrain, ep_constrain):
        if mesh is None and isinstance(hook, (SequenceParallel, ExpertParallel)):
            mesh = hook.mesh
    if mesh is not None:
        check_mesh(mesh)
    layers = params["layers"]
    model_axis = expert_axis = None
    if layers:
        model_axis = _sharded_axis(mesh, "model", layers[0]["q"]["w"].shape[-1],
                                   cfg.hidden, "the q projection")
        if cfg.moe is not None:
            moe = layers[0]["moe"]
            expert_axis = _sharded_axis(mesh, "expert", moe["ff1"]["w"].shape[0],
                                        cfg.moe.num_experts, "the expert axis")
            if _sharded_axis(mesh, "model", moe["ff1"]["w"].shape[-1],
                             cfg.intermediate, "the experts' ff1") != model_axis:
                raise ValueError("the experts' FFNs must shard over 'model' as the "
                                 "attention does (parallel/ep.py::moe_layer_specs)")
    if model_axis is not None and cfg.heads % axis_size(mesh, model_axis):
        raise ValueError(f"{cfg.heads} heads do not divide over the "
                         f"{axis_size(mesh, model_axis)} ranks of {model_axis!r}: each "
                         "rank must hold whole heads")
    sp = isinstance(constrain, SequenceParallel)
    if sp and model_axis is None:
        raise ValueError("sequence parallelism needs the attention sharded over "
                         "the mesh's 'model' axis (parallel/tp.py)")
    data = () if mesh is None or "data" not in (mesh.mesh_dim_names or ()) else (
        axis_groups(mesh, "data"))
    return mesh, model_axis, expert_axis, data, sp


def _reduce_stats(stats, groups):
    """Routing sums of this rank's tokens -> those of every data rank's
    (differentiable; the gradient passes through, each rank's own share)."""
    E = stats["f_sum"].shape[-1]
    flat = reduce_from_group(torch.cat([stats["f_sum"], stats["p_sum"],
                                        stats["n"].reshape(1)]), groups)
    return {"f_sum": flat[:E], "p_sum": flat[E : 2 * E], "n": flat[2 * E]}


def transformer_apply_with_aux(
    params: Dict,
    cfg: TransformerConfig,
    ids: torch.Tensor,  # [B, L] int
    mask: torch.Tensor,  # [B, L] f32 (1 = real token)
    type_ids: Optional[torch.Tensor] = None,
    constrain=None,
    ep_constrain=None,
    *,
    mesh=None,
):
    """(last hidden state [B, L, hidden], the MoE aux loss averaged over the
    layers: 0 for the dense model).

    ``mesh``: sharded parameters (``parallel/tp.py``, ``parallel/ep.py``);
    the step or forward that gets them must learn its mesh, since explicit
    SPMD has no global arrays to carry it. ``ids``, ``mask`` and
    ``type_ids`` are then this rank's rows of the batch (``shard_batch``),
    the hidden state is returned for those rows, and the aux loss is that
    of the whole batch: each layer's routing sums are summed over ``data``
    before ``moe_aux_from_stats`` (a product of means is not the mean of
    the ranks' products). ``constrain``: ``parallel.tp.make_sp_constrainer``
    (sequence parallelism, which needs ``L`` to divide over ``model``), or
    a callable applied to the activations after the embedding LayerNorm
    and after every block. ``ep_constrain``: ``make_ep_constrainer`` (the
    explicit EP path), or a callable applied to the MoE expert slabs."""
    mesh, model_axis, expert_axis, data, sp = _parallel_layout(
        params, cfg, mesh, constrain, ep_constrain)
    if isinstance(ep_constrain, ExpertParallel):
        ep_constrain = None  # the layout above carries it
    sp_group = None
    if sp:
        sp_group = mesh.get_group(model_axis)
        m = axis_size(mesh, model_axis)
        if ids.shape[1] % m:
            raise ValueError(f"sequence parallelism splits the length {ids.shape[1]} "
                             f"over {m} ranks of 'model': it must divide")
        if m == 1:
            sp_group = None
        constrain = None
    x = transformer_embed(params, cfg, ids, type_ids)
    x = scatter_seq(x, sp_group) if sp_group is not None else x
    if constrain is not None:
        x = constrain(x)
    attn_ctx = attention_mask_inputs(cfg, mask)
    kw = dict(model_axis=model_axis, expert_axis=expert_axis, mesh=mesh,
              sequence_parallel=sp_group is not None)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        if cfg.moe is not None:
            x, aux = transformer_block(x, lp, cfg, attn_ctx, ep_constrain, moe_mask=mask,
                                       moe_stats=bool(data), **kw)
            aux_total = aux_total + (moe_aux_from_stats(_reduce_stats(aux, data))
                                     if data else aux)
        else:
            x = transformer_block(x, lp, cfg, attn_ctx, **kw)
        if constrain is not None:
            x = constrain(x)
    if sp_group is not None:
        x = gather_seq(x, sp_group, reduce_grad=False)
    return x, aux_total / max(len(params["layers"]), 1)


def transformer_apply(
    params: Dict,
    cfg: TransformerConfig,
    ids: torch.Tensor,  # [B, L] int
    mask: torch.Tensor,  # [B, L] f32 (1 = real token)
    type_ids: Optional[torch.Tensor] = None,
    constrain=None,
    ep_constrain=None,
    *,
    mesh=None,
) -> torch.Tensor:
    """Last hidden state [B, L, hidden] (the aux loss discarded): the
    inference path. With ``mesh`` the inputs are this rank's rows
    (``shard_batch``) and the result is the whole batch's, on every rank,
    as the reference returns a global array."""
    x = transformer_apply_with_aux(params, cfg, ids, mask, type_ids, constrain,
                                   ep_constrain, mesh=mesh)[0]
    return gather_data_rows(x, mesh)


def from_huggingface(name: str = "bert-base-uncased"):
    """``(TransformerConfig, params)`` of a local HuggingFace BERT or RoBERTa
    checkpoint: a directory, or a name in the hub cache
    (``hf_checkpoint.resolve_checkpoint``; nothing is downloaded). Dense
    weights are transposed to ``[in, out]``; RoBERTa's position table keeps
    its two leading rows (``position_offset=2``, ``max_positions =
    max_position_embeddings - 2``). Float32 tensors on the CPU."""
    from ircl_tpu_torch.models.hf_checkpoint import (
        read_config,
        read_weights,
        resolve_checkpoint,
    )
    from ircl_tpu_torch.utils.convert import transformer_params_from_numpy

    path = resolve_checkpoint(name)
    hc = read_config(path)
    sd = read_weights(path)
    is_roberta = "roberta" in hc["model_type"]
    cfg = TransformerConfig(
        vocab_size=hc["vocab_size"],
        hidden=hc["hidden_size"],
        layers=hc["num_hidden_layers"],
        heads=hc["num_attention_heads"],
        intermediate=hc["intermediate_size"],
        max_positions=hc["max_position_embeddings"] - (2 if is_roberta else 0),
        type_vocab=hc["type_vocab_size"],
        layernorm_eps=hc["layer_norm_eps"],
        position_offset=2 if is_roberta else 0,
    )

    def t(key, transpose=False):
        if key not in sd:
            raise KeyError(f"{path}: the checkpoint has no tensor {key!r}")
        return (sd[key].T.contiguous() if transpose else sd[key]).numpy()

    def dense(key):
        return {"w": t(key + ".weight", transpose=True), "b": t(key + ".bias")}

    def ln(key):
        return {"scale": t(key + ".weight"), "bias": t(key + ".bias")}

    layers = []
    for layer in range(cfg.layers):
        b = f"encoder.layer.{layer}."
        layers.append({
            "q": dense(b + "attention.self.query"),
            "k": dense(b + "attention.self.key"),
            "v": dense(b + "attention.self.value"),
            "o": dense(b + "attention.output.dense"),
            "attn_ln": ln(b + "attention.output.LayerNorm"),
            "ff1": dense(b + "intermediate.dense"),
            "ff2": dense(b + "output.dense"),
            "ff_ln": ln(b + "output.LayerNorm"),
        })
    params = transformer_params_from_numpy({
        "tok_emb": t("embeddings.word_embeddings.weight"),
        "pos_emb": t("embeddings.position_embeddings.weight"),
        "type_emb": t("embeddings.token_type_embeddings.weight"),
        "emb_ln": ln("embeddings.LayerNorm"),
        "layers": layers,
    }, device="cpu")
    return cfg, params
