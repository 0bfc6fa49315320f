"""Pipeline parallelism (the GPipe schedule) for the transformer models.

Counterpart of ``ircl_tpu/parallel/pp.py``. The encoder's L blocks split
into S equal stages over the ``"stage"`` axis of a ``("data", "stage"[,
"expert"][, "model"])`` mesh:

- the per-layer parameter trees are stacked onto a leading ``[S, L/S,
  ...]`` axis (``stack_layer_params``, layer ``l = s * per + j``) and
  sharded ``P("stage")``, so each rank holds its own stage's blocks and
  their Adam moments; the embeddings and the head are replicated;
- each data rank splits its rows of the batch into ``n_micro``
  microbatches. Stage 0 embeds them and feeds them in; every stage runs its
  blocks (``transformer_block``, the single-device code) on each
  microbatch and sends the activations and the mask to stage + 1, point to
  point; the last stage keeps the outputs and runs the head and the loss;
- under a ``"model"`` or ``"expert"`` axis each stage runs the explicit
  Megatron TP and EP paths of ``parallel/tp.py`` and ``parallel/ep.py``
  (``model_axis``, ``expert_axis``), as the reference's stages do.

The reference runs the schedule as one traced ``lax.scan`` and lets
``jax.grad`` derive the reverse pipeline. Here the reverse pipeline is
written out, GPipe's: every forward first, then every backward. Each stage
calls backward on its microbatches' outputs with the gradients received
from stage + 1, last microbatch first, and sends the gradients of its
inputs to stage - 1; stage 0 ends with one backward through the embedding.
The embeddings' gradients arise on stage 0 and the head's on the last stage,
so they are summed over ``stage``, and every gradient over ``data``: every
rank updates its replicated leaves alike. ``remat=True`` recomputes each
stage application in its backward (``torch.utils.checkpoint``).

MoE blocks pipeline too: batch rows never meet inside a block (routing
groups subdivide rows), so microbatching leaves the routes alone. Each stage
sums its layers' routing statistics over the microbatches and over
``data`` (the sum's backward is the identity: each rank's tokens carry
their own share) and forms its own part of the load-balance aux
(``moe_aux_from_stats``), whose gradient joins that stage's backward.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint

from ircl_tpu_torch.models.moe import moe_aux_from_stats
from ircl_tpu_torch.models.transformer import (
    TransformerConfig,
    attention_mask_inputs,
    transformer_block,
    transformer_embed,
)
from ircl_tpu_torch.parallel.common import (
    isend_to,
    recv_from,
    reduce_from_group,
    wait_sends,
)
from ircl_tpu_torch.parallel.mesh import (
    axis_groups,
    axis_rank,
    axis_size,
    check_mesh,
    group_size,
    make_mesh,
    mesh_device,
)
from ircl_tpu_torch.parallel.tp import P
from ircl_tpu_torch.utils.precision import float32_precision
from ircl_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten
from ircl_tpu_torch.verdict.model import make_verdict_optimizer, verdict_head

_EMBED = ("tok_emb", "pos_emb", "type_emb", "emb_ln")


def make_pp_mesh(stages: Optional[int] = None, data: int = 1, model: int = 1,
                 expert: int = 1, device=None):
    """``("data", "stage"[, "expert"][, "model"])`` mesh; defaults to data
    = 1 and stages = every rank. ``data > 1`` runs one pipeline a data rank,
    each over its rows; ``model > 1`` runs every stage Megatron-TP and
    ``expert > 1`` shards an MoE stage's experts. A mesh of fewer ranks than
    the group runs as replicas (``parallel/mesh.py::make_mesh``)."""
    if stages is None:
        stages = group_size(device) // (data * model * expert)
    axes = [("data", data), ("stage", stages)]
    if expert > 1:
        axes.append(("expert", expert))
    if model > 1:
        axes.append(("model", model))
    return make_mesh(tuple(n for n, _ in axes), tuple(s for _, s in axes), device)


def stack_layer_params(layers: List[Dict], n_stages: int):
    """A list of per-layer trees -> one tree with leaves ``[S, L/S, ...]``."""
    n = len(layers)
    if n % n_stages != 0:
        raise ValueError(f"{n} layers not divisible into {n_stages} stages")
    per = n // n_stages
    return tree_map(lambda *xs: torch.stack(xs).reshape((n_stages, per) + xs[0].shape),
                    layers[0], *layers[1:])


def unstack_layer_params(stacked) -> List[Dict]:
    """The inverse of ``stack_layer_params``."""
    s, per = tree_leaves(stacked)[0].shape[:2]
    flat = tree_map(lambda a: a.reshape((s * per,) + a.shape[2:]), stacked)
    return [tree_map(lambda a: a[i], flat) for i in range(s * per)]


def stage_specs(stacked):
    """``P("stage")`` on every leaf's leading axis."""
    return tree_map(lambda _: P("stage"), stacked)


def stacked_stage_specs(moe: bool = False, tp: bool = False, ep: bool = False):
    """The spec tree of one stacked-layer dict (leaves ``[S, per, ...]``):
    ``tp`` puts the Megatron layout on the trailing weight dimensions over
    ``model`` (``tp.transformer_param_specs`` shifted right by the
    stacking), ``ep`` the MoE experts over ``expert``."""
    st = "stage"
    m = "model" if tp else None
    col = {"w": P(st, None, None, m), "b": P(st, None, m)}
    row = {"w": P(st, None, m, None), "b": P(st)}
    ln = {"scale": P(st), "bias": P(st)}
    layer = {"q": col, "k": col, "v": col, "o": row, "attn_ln": ln, "ff_ln": ln}
    if moe:
        e = "expert" if ep else None
        layer["moe"] = {
            "router": {"w": P(st)},
            "ff1": {"w": P(st, None, e, None, m), "b": P(st, None, e, m)},
            "ff2": {"w": P(st, None, e, m, None), "b": P(st, None, e)},
        }
    else:
        layer["ff1"] = col
        layer["ff2"] = row
    return layer


def _axis(mesh, name) -> Optional[str]:
    names = mesh.mesh_dim_names or ()
    return name if name in names and axis_size(mesh, name) > 1 else None


def check_pp_mesh(mesh) -> None:
    """``ValueError`` unless ``mesh`` has ``make_pp_mesh``'s axes, in its
    order."""
    check_mesh(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    allowed = [("data", "stage") + e + m for e in ((), ("expert",)) for m in ((), ("model",))]
    if names not in allowed:
        raise ValueError(f"a pipeline mesh has the axes ('data', 'stage'[, 'expert'][, "
                         f"'model']), as make_pp_mesh lays them out; got {names}")


class _Pipeline:
    """This rank's place in the GPipe schedule of ``cfg``'s blocks over
    ``mesh``, and the stage's forward."""

    def __init__(self, cfg: TransformerConfig, mesh, n_micro: int, remat: bool):
        if cfg.attention != "xla":
            raise ValueError("pipeline stages support the XLA attention path")
        check_pp_mesh(mesh)
        self.cfg, self.mesh, self.M, self.remat = cfg, mesh, n_micro, remat
        self.moe = cfg.moe is not None
        self.model_axis, self.expert_axis = _axis(mesh, "model"), _axis(mesh, "expert")
        if self.model_axis:
            tp_size = axis_size(mesh, "model")
            if cfg.heads % tp_size:
                raise ValueError(f"heads {cfg.heads} not divisible by TP {tp_size}")
            if cfg.intermediate % tp_size:
                raise ValueError(
                    f"intermediate {cfg.intermediate} not divisible by TP {tp_size}")
        if self.expert_axis:
            ep_size = axis_size(mesh, "expert")
            if not self.moe:
                raise ValueError("mesh has an 'expert' axis but cfg.moe is None")
            if cfg.moe.num_experts % ep_size:
                raise ValueError(
                    f"experts {cfg.moe.num_experts} not divisible by EP {ep_size}")
        self.S, self.s = axis_size(mesh, "stage"), axis_rank(mesh, "stage")
        self.first, self.last = self.s == 0, self.s == self.S - 1
        self.group = mesh.get_group("stage")
        self.data = axis_groups(mesh, "data")
        self.n_data = axis_size(mesh, "data")
        self.device = mesh_device(mesh)

    def inputs(self, ids, mask, type_ids, *rest):
        """This rank's rows as tensors on its device, checked to divide into
        the microbatches (the messages name the global batch)."""
        B = ids.shape[0] * self.n_data
        if B % self.M:
            raise ValueError(f"batch {B} not divisible into {self.M} microbatches")
        if (B // self.M) % self.n_data:
            raise ValueError(
                f"microbatch {B // self.M} not divisible over data axis {self.n_data}")
        dev = self.device
        out = [torch.as_tensor(ids, device=dev).long(),
               torch.as_tensor(mask, device=dev).float(),
               None if type_ids is None else torch.as_tensor(type_ids, device=dev).long()]
        return out + [torch.as_tensor(r, device=dev).long() for r in rest]

    def _stage_fn(self, stacked):
        """``(x, mask) -> (y, stats)``: this stage's blocks, ``stats`` the
        routing sums stacked over its layers (MoE) or ``None``."""
        cfg, mesh = self.cfg, self.mesh
        per = tree_leaves(stacked)[0].shape[1]
        blocks = [tree_map(lambda a, j=j: a[0, j], stacked) for j in range(per)]
        kw = dict(model_axis=self.model_axis, mesh=mesh)

        def run(x, mask):
            bias = attention_mask_inputs(cfg, mask)
            if not self.moe:
                for lp in blocks:
                    x = transformer_block(x, lp, cfg, bias, **kw)
                return x, None
            stats = []
            for lp in blocks:
                x, st = transformer_block(x, lp, cfg, bias, moe_mask=mask, moe_stats=True,
                                          expert_axis=self.expert_axis, **kw)
                stats.append(st)
            return x, {k: torch.stack([st[k] for st in stats]) for k in stats[0]}

        if not self.remat:
            return run
        return lambda x, mask: torch.utils.checkpoint.checkpoint(
            run, x, mask, use_reentrant=False)

    def forward(self, embed, stacked, ids, mask, type_ids, grad: bool):
        """The forward half of the schedule on this rank. Returns ``(kept,
        x_emb)``: per microbatch ``(x_in, y, stats, mask)``, and stage 0's
        embedding output (``None`` elsewhere). With ``grad`` each ``x_in``
        is a leaf whose gradient the backward fills."""
        cfg, M = self.cfg, self.M
        stage = self._stage_fn(stacked)
        mb, L, h = ids.shape[0] // M, ids.shape[1], cfg.hidden
        masks = mask.chunk(M)
        x_emb = feeds = None
        if self.first:
            x_emb = transformer_embed(embed, cfg, ids, type_ids)
            feeds = x_emb.detach().chunk(M) if grad else x_emb.chunk(M)
        kept, sends = [], []
        for m in range(M):
            if self.first:
                x_in, mk = feeds[m], masks[m]
            else:  # the activations and the mask, packed in one message
                buf = recv_from((mb * L * (h + 1),), torch.float32, self.device,
                                self.s - 1, self.group)
                x_in, mk = buf[: mb * L * h].view(mb, L, h), buf[mb * L * h:].view(mb, L)
            if grad:
                x_in = x_in.detach().requires_grad_()
            y, stats = stage(x_in, mk)
            if not self.last:
                sends.append(isend_to(torch.cat([y.detach().float().reshape(-1),
                                                 mk.float().reshape(-1)]),
                                      self.s + 1, self.group))
            kept.append((x_in, y, stats, mk))
        wait_sends(sends)
        return kept, x_emb

    def global_stats(self, kept):
        """The stage's routing sums over its microbatches and over ``data``,
        as leaves of their own (the gradient the aux sends back to each
        microbatch is the same): ``(leaves, summed)``."""
        leaves = {k: sum(st[k] for _, _, st, _ in kept).detach().requires_grad_()
                  for k in kept[0][2]}
        per, E = leaves["f_sum"].shape
        flat = torch.cat([leaves["f_sum"].reshape(-1), leaves["p_sum"].reshape(-1),
                          leaves["n"]])
        flat = reduce_from_group(flat, self.data)
        return leaves, {"f_sum": flat[: per * E].view(per, E),
                        "p_sum": flat[per * E: 2 * per * E].view(per, E),
                        "n": flat[2 * per * E:]}

    def stage_aux(self, summed):
        """This stage's share of the layer-mean aux: its layers' aux over
        the ``S * per`` layers of the model."""
        per = summed["n"].shape[0]
        return moe_aux_from_stats(summed).sum() / float(self.S * per)

    def broadcast_last(self, t):
        """The last stage's ``t`` on every rank of the stage axis."""
        if self.S > 1:
            t = t.contiguous()
            dist.broadcast(t, src=dist.get_global_rank(self.group, self.S - 1),
                           group=self.group)
        return t


def make_pp_transformer_apply(cfg: TransformerConfig, mesh, n_micro: int,
                              remat: bool = False):
    """``(embed_params, stacked_layers, ids, mask, type_ids) -> the last
    hidden state [B_l, L, hidden]`` of this rank's rows (``shard_batch``),
    with the blocks run as an S-stage pipeline over ``mesh``'s ``"stage"``
    axis in ``n_micro`` microbatches, on every rank of the stage axis; the
    inference half of the schedule, without autograd.

    ``embed_params``: the non-layer entries of ``init_transformer_params``,
    replicated. ``stacked_layers``: this rank's shard of
    ``stack_layer_params(params["layers"], S)`` under
    ``stacked_stage_specs(moe, tp, ep)``. With ``cfg.moe`` the return is
    ``(hidden, aux)``, the aux of the whole batch from the routing sums
    added over microbatches, ``data`` and ``stage``."""
    pipe = _Pipeline(cfg, mesh, n_micro, remat)

    @torch.no_grad()
    def apply(embed_params, stacked_layers, ids, mask, type_ids=None):
        ids, mask, type_ids = pipe.inputs(ids, mask, type_ids)
        with float32_precision():
            kept, _ = pipe.forward(embed_params, stacked_layers, ids, mask, type_ids,
                                   grad=False)
        out = torch.cat([y for _, y, _, _ in kept]) if pipe.last else torch.empty(
            ids.shape + (cfg.hidden,), device=pipe.device)
        out = pipe.broadcast_last(out)
        if not pipe.moe:
            return out
        aux = pipe.stage_aux(pipe.global_stats(kept)[1]).reshape(1)
        if pipe.S > 1:
            dist.all_reduce(aux, group=pipe.group)
        return out, aux[0]

    return apply


# ---------------------------------------------------------------------------
# Pipeline-parallel verdict training
# ---------------------------------------------------------------------------


def pp_verdict_params(params: Dict[str, Any], n_stages: int):
    """``init_verdict_params``' tree -> the pipeline layout: the embeddings
    and the head replicated, the blocks stacked ``[S, L/S, ...]``."""
    body = params["body"]
    return {
        "embed": {k: body[k] for k in _EMBED},
        "stages": stack_layer_params(body["layers"], n_stages),
        "head_dense": params["head_dense"],
        "head_out": params["head_out"],
    }


def verdict_params_from_pp(pp_params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``pp_verdict_params``: the standard tree (for
    validation, prediction and checkpoints, whatever the mesh). The stage
    leaves must be whole (``tp.gather_tree``)."""
    body = dict(pp_params["embed"])
    body["layers"] = unstack_layer_params(pp_params["stages"])
    return {"body": body, "head_dense": pp_params["head_dense"],
            "head_out": pp_params["head_out"]}


def restack_pp_params(pp_params: Dict[str, Any], n_stages: int):
    """The pipeline layout of whole parameters re-cut into ``n_stages``
    stages (a PP(4) checkpoint resumed by a PP(2) job), the layer order
    kept; shard the result with ``pp_verdict_specs`` on the new mesh."""
    return pp_verdict_params(verdict_params_from_pp(pp_params), n_stages)


def pp_verdict_specs(pp_params, mesh=None) -> Dict[str, Any]:
    """The spec tree of ``pp_verdict_params``' layout. With the mesh, its
    ``model`` and ``expert`` axes shard the stage weights as the schedule
    reads them."""
    tp = mesh is not None and _axis(mesh, "model") is not None
    ep = mesh is not None and _axis(mesh, "expert") is not None
    moe = "moe" in pp_params["stages"]
    stages = (stacked_stage_specs(moe=moe, tp=tp, ep=ep) if tp or ep
              else stage_specs(pp_params["stages"]))
    rep = lambda t: tree_map(lambda _: P(), t)  # noqa: E731
    return {"embed": rep(pp_params["embed"]), "stages": stages,
            "head_dense": rep(pp_params["head_dense"]), "head_out": rep(pp_params["head_out"])}


def make_pp_verdict_grad_fn(cfg, mesh, n_micro: int, remat: bool = False):
    """``fn(params, ids, mask, type_ids, labels) -> (loss, preds, grads)``
    on the pipeline layout: this rank's shards and rows in, the whole
    batch's loss (cross-entropy plus ``moe_aux_weight`` times the aux),
    the labels of this rank's rows and this rank's gradients out, every
    gradient summed over ``data`` and the replicated leaves' over
    ``stage``."""
    pipe = _Pipeline(cfg.encoder, mesh, n_micro, remat)

    def fn(params, ids, mask, type_ids, labels):
        ids, mask, type_ids, labels = pipe.inputs(ids, mask, type_ids, labels)
        views = tree_map(lambda t: t.detach().requires_grad_(), params)
        with torch.enable_grad(), float32_precision():
            return _grads(pipe, cfg, views, ids, mask, type_ids, labels)

    return fn


def _grads(pipe: _Pipeline, cfg, views, ids, mask, type_ids, labels):
    M, group = pipe.M, pipe.group
    kept, x_emb = pipe.forward(views["embed"], views["stages"], ids, mask, type_ids,
                               grad=True)
    zero = torch.zeros((), device=pipe.device)
    ce, aux, cls = zero, zero, None
    logits = torch.zeros(ids.shape[0], cfg.num_labels, device=pipe.device)
    if pipe.last:  # the head and the loss of this rank's rows
        cls = torch.cat([y[:, 0, :] for _, y, _, _ in kept]).detach().requires_grad_()
        out = verdict_head(views, cls)
        ce = F.cross_entropy(out, labels) / pipe.n_data
        ce.backward()
        logits, ce = out.detach(), ce.detach()
    g_stats = {}
    if pipe.moe:  # the stage's aux, and its gradient for each routing sum
        leaves, summed = pipe.global_stats(kept)
        aux = pipe.stage_aux(summed)
        (cfg.moe_aux_weight * aux).backward()
        g_stats = {k: v.grad for k, v in leaves.items() if v.grad is not None}
        aux = aux.detach()
    sends, x_grads, mb = [], [None] * M, ids.shape[0] // M
    for m in reversed(range(M)):  # the reverse pipeline, last microbatch first
        x_in, y, stats, _ = kept[m]
        kept[m] = None  # the microbatch's graph is spent after this backward
        if pipe.last:
            g = torch.zeros_like(y)
            g[:, 0, :] = cls.grad[m * mb:(m + 1) * mb]
        else:
            g = recv_from(y.shape, y.dtype, pipe.device, pipe.s + 1, group)
        roots, cots = [y], [g]
        for k, gk in g_stats.items():
            if stats[k].requires_grad:
                roots.append(stats[k])
                cots.append(gk)
        torch.autograd.backward(roots, cots)
        x_grads[m] = x_in.grad
        if not pipe.first:
            sends.append(isend_to(x_in.grad, pipe.s - 1, group))
    if pipe.first:  # one backward through the embedding
        torch.autograd.backward(x_emb, torch.cat(x_grads))
    wait_sends(sends)
    return _reduce(pipe, cfg, views, ce, aux, logits)


def _flat_sum(tensors, groups):
    """The tensors summed over ``groups``, through one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for group in groups:
        dist.all_reduce(flat, group=group)
    return [o.view_as(t) for o, t in zip(torch.split(flat, [t.numel() for t in tensors]),
                                          tensors)]


def _reduce(pipe: _Pipeline, cfg, views, ce, aux, logits):
    """Every gradient summed over ``data``, the replicated leaves' and the
    loss's parts over ``stage``: ``(loss, preds, grads)``."""
    grads = tree_map(lambda v: v.grad if v.grad is not None else torch.zeros_like(v),
                     views)
    leaves = tree_leaves(grads)
    if pipe.data:
        *leaves, ce = _flat_sum(leaves + [ce], pipe.data)
        grads = tree_unflatten(grads, leaves)
    rep = {k: grads[k] for k in ("embed", "head_dense", "head_out")}
    if pipe.S > 1:
        *summed, ce, aux, logits = _flat_sum(tree_leaves(rep) + [ce, aux, logits],
                                             (pipe.group,))
        grads.update(tree_unflatten(rep, summed))
    loss = ce + cfg.moe_aux_weight * aux if pipe.moe else ce
    return loss, torch.argmax(logits, dim=-1), grads


def make_pp_verdict_train_step(cfg, mesh, n_micro: int, remat: bool = False):
    """The pipeline's twin of ``verdict.model.make_verdict_train_step``:
    ``(step, tx)``, the same loss, AdamW and body freeze, with the blocks
    run as an S-stage GPipe pipeline and its reverse written out.
    ``step(params, opt_state, step_idx, ids, mask, type_ids, labels) ->
    (params, opt_state, loss, preds)`` takes this rank's shards of the
    pipeline layout (``pp_verdict_params``, ``pp_verdict_specs``) and rows
    of the batch (``tp.shard_batch``), updates them in place, and returns
    the whole batch's loss. AdamW is elementwise, so each rank updates its
    shards as one device would. While the body is frozen its gradients
    count as zero and its updates are withheld (the embeddings and the
    stages), as the reference gates both."""
    tx = make_verdict_optimizer(cfg)
    grad_fn = make_pp_verdict_grad_fn(cfg, mesh, n_micro, remat)

    def step(params, opt_state, step_idx, ids, mask, type_ids, labels):
        loss, preds, grads = grad_fn(params, ids, mask, type_ids, labels)
        body_on = not cfg.freeze_body_until_warmup or int(step_idx) >= cfg.warmup_steps
        tx.update_(params, grads, opt_state, body_on, body=("embed", "stages"))
        return params, opt_state, loss, preds

    return step, tx
