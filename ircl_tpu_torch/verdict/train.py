"""Verdict training loop: epochs over encoded examples, val split, macro-F1.

Counterpart of ``ircl_tpu/verdict/train.py``, the host equivalent of the
reference ``src/QA/train.py:31-148``: AdamW + linear warmup schedule (in the
optimizer, ``verdict/model.py``), shuffled epochs, 1% validation split with
per-epoch loss + macro-F1, checkpointing of params. The numpy generators
are the reference's, drawn in its order, so one seed gives the same split
and the same batches in both packages; the initial weights differ (a
``torch.Generator`` here) unless ``init_params`` carries them across.

Ported: the loop for every encoder ``verdict/model.py`` trains (float32 or
bfloat16, dense or MoE), on one device or on every mesh the reference's
takes, in its layouts: data parallelism alone (replicated parameters), TP x
DP (``verdict_param_specs``), EP x DP and EP x TP x DP for an MoE encoder
(``moe_verdict_param_specs`` with ``make_ep_constrainer``), replicated
parameters for an MoE encoder on a mesh without an ``expert`` axis, and a
``"stage"`` mesh (``parallel/pp.py``): the pipeline layout
(``pp_verdict_params``, ``pp_verdict_specs``) and ``pp_micro``
microbatches a step. Every rank draws the same split and batches and takes
its rows of each batch; validation runs on every rank, through the sharded
forward or, on a ``"stage"`` mesh, on the whole parameters in the standard
layout; only rank 0 writes metrics and ``save_path``. ``save_path`` writes
the port's checkpoint directory (``verdict/infer.py::
save_verdict_checkpoint``), not an orbax tree, and needs the tokenizer for
it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ircl_tpu_torch.parallel import ep, pp, tp
from ircl_tpu_torch.parallel.mesh import axis_size, check_mesh, mesh_device
from ircl_tpu_torch.utils.convert import to_device
from ircl_tpu_torch.utils.device import resolve_device
from ircl_tpu_torch.utils.metrics import MetricsLogger
from ircl_tpu_torch.utils.tree import tree_map
from ircl_tpu_torch.verdict.evaluate import classification_report
from ircl_tpu_torch.verdict.infer import save_verdict_checkpoint
from ircl_tpu_torch.verdict.model import (
    VerdictConfig,
    init_verdict_params,
    make_verdict_train_step,
    verdict_predict,
)


def predict_in_batches(params, cfg, ids, mask, types, batch_size=32, *, device=None,
                       mesh=None):
    """Predicted labels ``[n]`` int64 for numpy ``ids``, ``mask``, ``types``
    ``[n, L]``. Every device call has exactly ``batch_size`` rows, the tail
    padded with empty rows that are dropped from the result. ``params`` are
    moved to ``device`` (by default the card) once. With ``mesh`` they are
    this rank's shards, ``batch_size`` is rounded up to a multiple of the
    data ranks, and each rank runs its rows of every batch
    (``verdict_predict(mesh=)``); every rank returns every label."""
    if mesh is not None:
        device = mesh_device(mesh)
        if "data" in (mesh.mesh_dim_names or ()):
            n_data = axis_size(mesh, "data")
            batch_size = -(-batch_size // n_data) * n_data
        place = lambda *a: tp.shard_batch(mesh, *a)  # noqa: E731
    else:
        device = resolve_device(device)
        params = to_device(params, device)
        place = lambda *a: tuple(torch.as_tensor(x, device=device) for x in a)  # noqa: E731
    preds = []
    n = len(ids)
    pending = None  # 1-deep pipeline: host pad/encode overlaps device run
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        pad = batch_size - (hi - lo)
        sl = slice(lo, hi)
        i = np.pad(ids[sl], ((0, pad), (0, 0)))
        m = np.pad(mask[sl], ((0, pad), (0, 0))).astype(np.float32)
        t = np.pad(types[sl], ((0, pad), (0, 0)))
        i, m, t = place(i, m, t)
        # enqueued, not waited for: the card runs this batch while the host
        # pads the next one and only then reads the previous result
        p_d = verdict_predict(params, cfg, i.long(), m, t.long(), mesh=mesh)
        if pending is not None:
            preds.append(pending[0].cpu().numpy()[: pending[1]])
        pending = (p_d, hi - lo)
    if pending is not None:
        preds.append(pending[0].cpu().numpy()[: pending[1]])
    return np.concatenate(preds) if preds else np.empty(0, np.int64)


def train_verdict(
    cfg: VerdictConfig,
    ids: np.ndarray,
    mask: np.ndarray,
    types: np.ndarray,
    labels: np.ndarray,
    epochs: int = 3,
    batch_size: int = 8,
    val_fraction: float = 0.01,
    seed: int = 1009,  # reference QA seed (config.yaml:139)
    logdir: Optional[str] = None,
    save_path: Optional[str] = None,  # a checkpoint directory; needs `tokenizer`
    init_params=None,  # warm start (curriculum phases share one model)
    stop_at_val_f1: Optional[float] = None,  # early exit once val reaches
    #   the criterion ("train to target": epoch counts are run-to-run
    #   unstable for random-init tiny transformers)
    keep_best: bool = False,  # return the best-val-F1 epoch's params
    #   instead of the last (fine-tune phases peak mid-run then forget)
    split_seed: Optional[int] = None,  # train/val split seed; defaults to
    #   ``seed``. Pass a FIXED value when comparing val F1 across seed
    #   restarts — otherwise each restart is scored on a different val
    #   split and the max over restarts is upward-biased split noise
    mesh=None,  # a DeviceMesh: run the same loop over its ranks. Axis
    #   names select the layout: "data" -> DP (each rank takes its rows,
    #   gradients summed), "model" -> Megatron TP (parallel/tp.py),
    #   "expert" -> EP for MoE encoders (parallel/ep.py); they compose, e.g.
    #   ("data", "expert", "model"). "stage" -> the GPipe pipeline
    #   (parallel/pp.py), on make_pp_mesh's ("data", "stage") mesh
    pp_micro: int = 4,  # microbatches a step on a "stage" mesh; batch_size
    #   must divide into them
    *,
    device=None,  # by default the card; with a mesh, the mesh's
    tokenizer=None,  # the WordPiece tokenizer that ``save_path`` writes out
):
    """Returns ``(params on device, history)``; ``history`` has one
    ``{"epoch", "train_loss", "val_macro_f1"}`` per epoch run. With a mesh
    every rank returns the whole parameters and the same history."""
    staged = False
    if mesh is not None:
        check_mesh(mesh)
        staged = "stage" in (mesh.mesh_dim_names or ())
        if staged:
            pp.check_pp_mesh(mesh)
            if batch_size % pp_micro:
                raise ValueError(f"batch_size={batch_size} not divisible into "
                                 f"pp_micro={pp_micro} microbatches")
        device = mesh_device(mesh)
    if save_path and tokenizer is None:
        raise ValueError(
            "save_path writes verdict_config.json, verdict_vocab.txt and "
            "verdict_params.pt: pass the tokenizer the examples were encoded with"
        )
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = len(ids)
    order = np.random.default_rng(
        seed if split_seed is None else split_seed
    ).permutation(n)
    # val_fraction=0 genuinely disables validation (tiny golden-fixture
    # runs need every example for training); otherwise at least 1 example
    n_val = (
        0 if val_fraction <= 0 or n <= 1 else max(1, int(n * val_fraction))
    )
    val_idx, train_idx = order[:n_val], order[n_val:]

    # the step updates in place: a warm start is copied, never written to
    params = (
        tree_map(lambda t: t.detach().to(device, copy=True), init_params)
        if init_params is not None
        else init_verdict_params(torch.Generator().manual_seed(seed), cfg, device)
    )
    rank0 = True
    to_std = lambda p: p  # noqa: E731  the standard layout, for validation and saving
    if staged:
        params = pp.pp_verdict_params(params, axis_size(mesh, "stage"))
        specs = pp.pp_verdict_specs(params, mesh)
        step_fn, tx = pp.make_pp_verdict_train_step(cfg, mesh, n_micro=pp_micro)
        params = tp.shard_tree(params, specs, mesh)
        opt_state = tp.init_sharded_opt_state(tx, params, mesh, specs)
        rank0 = mesh.get_rank() == 0

        def place(*arrays):
            return tp.shard_batch(mesh, *arrays)

        def whole(p):
            return pp.verdict_params_from_pp(tp.gather_tree(p, specs, mesh))

        to_std, val_mesh = whole, None
    elif mesh is not None:
        names = mesh.mesh_dim_names
        has_model = "model" in names
        ep_constrain = None
        if cfg.encoder.moe is not None and "expert" in names:
            specs = ep.moe_verdict_param_specs(params, tp=has_model)
            ep_constrain = ep.make_ep_constrainer(mesh)
        elif cfg.encoder.moe is None and has_model:
            specs = tp.verdict_param_specs(params)
        else:  # DP alone, or MoE without an expert axis: replicated params
            specs = tp.replicated_specs(params)
        step_fn, tx = make_verdict_train_step(cfg, ep_constrain=ep_constrain, mesh=mesh)
        params = tp.shard_tree(params, specs, mesh)
        opt_state = tp.init_sharded_opt_state(tx, params, mesh, specs)
        rank0 = mesh.get_rank() == 0

        def place(*arrays):
            return tp.shard_batch(mesh, *arrays)

        def whole(p):
            return tp.gather_tree(p, specs, mesh)

        val_mesh = mesh
    else:
        step_fn, tx = make_verdict_train_step(cfg, device=device)
        opt_state = tx.init(params)

        def place(*arrays):
            return arrays

        def whole(p):
            return p

        val_mesh = None
    metrics = MetricsLogger(logdir, "verdict") if logdir and rank0 else None

    step = 0
    history = []
    best_f1, best_params = -1.0, None
    for epoch in range(epochs):
        ep_order = rng.permutation(train_idx)
        losses = []
        for lo in range(0, len(ep_order) - batch_size + 1, batch_size):
            sel = ep_order[lo : lo + batch_size]
            params, opt_state, loss, _ = step_fn(
                params, opt_state, step,
                *place(ids[sel], mask[sel], types[sel], labels[sel]),
            )
            # device tensor, not float(): keep dispatch async within the
            # epoch (one sync at the epoch-end mean below)
            losses.append(loss)
            step += 1

        rep = None
        if len(val_idx):
            preds = predict_in_batches(
                to_std(params), cfg, ids[val_idx], mask[val_idx], types[val_idx],
                device=device, mesh=val_mesh,
            )
            rep = classification_report(labels[val_idx], preds)
        history.append(
            {
                "epoch": epoch,
                "train_loss": (
                    float(torch.stack(losses).mean()) if losses else None
                ),
                "val_macro_f1": rep["macro_f1"] if rep else None,
            }
        )
        if metrics:
            metrics.scalar("qa_train_loss", history[-1]["train_loss"] or 0.0, step)
            if rep:
                metrics.scalar("qa_val_macro_f1", rep["macro_f1"], step)
        if keep_best and rep is not None and rep["macro_f1"] > best_f1:
            best_f1 = rep["macro_f1"]
            best_params = tree_map(lambda t: t.to("cpu", copy=True), whole(params))
        if (
            stop_at_val_f1 is not None
            and rep is not None
            and rep["macro_f1"] >= stop_at_val_f1
        ):
            break

    # the whole parameters, on every rank: a layout-stable result
    params = (to_device(best_params, device) if keep_best and best_params is not None
              else whole(params))
    if metrics:
        metrics.close()

    if save_path and rank0:
        save_verdict_checkpoint(save_path, cfg, params, tokenizer)
    return params, history
