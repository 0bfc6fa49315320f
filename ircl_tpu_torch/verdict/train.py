"""Verdict training loop: epochs over encoded examples, val split, macro-F1.

Counterpart of ``ircl_tpu/verdict/train.py``, the host equivalent of the
reference ``src/QA/train.py:31-148``: AdamW + linear warmup schedule (in the
optimizer, ``verdict/model.py``), shuffled epochs, 1% validation split with
per-epoch loss + macro-F1, checkpointing of params. The numpy generators
are the reference's, drawn in its order, so one seed gives the same split
and the same batches in both packages; the initial weights differ (a
``torch.Generator`` here) unless ``init_params`` carries them across.

Ported: the single-device loop in float32. ``mesh`` (data, tensor, expert
and pipeline parallelism) waits for ROADMAP.md queue 1 item 12.
``save_path`` writes the port's checkpoint directory
(``verdict/infer.py::save_verdict_checkpoint``), not an orbax tree, and
needs the tokenizer for it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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


def predict_in_batches(params, cfg, ids, mask, types, batch_size=32, *, device=None):
    """Predicted labels ``[n]`` int64 for numpy ``ids``, ``mask``, ``types``
    ``[n, L]``. Every device call has exactly ``batch_size`` rows, the tail
    padded with empty rows that are dropped from the result. ``params`` are
    moved to ``device`` (by default the card) once."""
    device = resolve_device(device)
    params = to_device(params, device)
    preds = []
    n = len(ids)
    pending = None  # 1-deep pipeline: host pad/encode overlaps device run
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        pad = batch_size - (hi - lo)
        sl = slice(lo, hi)
        i = np.pad(ids[sl], ((0, pad), (0, 0)))
        m = np.pad(mask[sl], ((0, pad), (0, 0)))
        t = np.pad(types[sl], ((0, pad), (0, 0)))
        # enqueued, not waited for: the card runs this batch while the host
        # pads the next one and only then reads the previous result
        p_d = verdict_predict(
            params, cfg,
            torch.as_tensor(i, device=device).long(),
            torch.as_tensor(m, dtype=torch.float32, device=device),
            torch.as_tensor(t, device=device).long(),
        )
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
    mesh=None,  # multi-chip layouts are not ported (ROADMAP.md queue 1 item 12)
    pp_micro: int = 4,
    *,
    device=None,  # by default the card
    tokenizer=None,  # the WordPiece tokenizer that ``save_path`` writes out
):
    """Returns ``(params on device, history)``; ``history`` has one
    ``{"epoch", "train_loss", "val_macro_f1"}`` per epoch run."""
    if mesh is not None:
        raise NotImplementedError(
            "train_verdict(mesh=...) and pp_micro are not ported yet "
            "(ROADMAP.md queue 1 item 12)"
        )
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
    step_fn, tx = make_verdict_train_step(cfg, device=device)
    opt_state = tx.init(params)

    metrics = MetricsLogger(logdir, "verdict") if logdir else None

    step = 0
    history = []
    best_f1, best_params = -1.0, None
    for epoch in range(epochs):
        ep_order = rng.permutation(train_idx)
        losses = []
        for lo in range(0, len(ep_order) - batch_size + 1, batch_size):
            sel = ep_order[lo : lo + batch_size]
            params, opt_state, loss, _ = step_fn(
                params, opt_state, step, ids[sel], mask[sel], types[sel], labels[sel]
            )
            # device tensor, not float(): keep dispatch async within the
            # epoch (one sync at the epoch-end mean below)
            losses.append(loss)
            step += 1

        rep = None
        if len(val_idx):
            preds = predict_in_batches(
                params, cfg, ids[val_idx], mask[val_idx], types[val_idx],
                device=device,
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
            best_params = tree_map(lambda t: t.to("cpu", copy=True), params)
        if (
            stop_at_val_f1 is not None
            and rep is not None
            and rep["macro_f1"] >= stop_at_val_f1
        ):
            break

    if keep_best and best_params is not None:
        params = to_device(best_params, device)
    if metrics:
        metrics.close()

    if save_path:
        save_verdict_checkpoint(save_path, cfg, params, tokenizer)
    return params, history
