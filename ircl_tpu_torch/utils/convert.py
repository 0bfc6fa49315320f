"""Parameters carried across from the JAX package, and moved between devices.

The JAX package keeps parameters as nested dicts and lists of arrays; the
port keeps the same trees of tensors with the same layouts. These helpers
take the JAX side's trees after ``np.asarray`` on every leaf (this module
never imports JAX), so both packages compute the same function from the
same weights. Each converter puts the tensors on ``device``, by default the
card (``utils/device.py``):

- ``encoder_params_from_numpy``: the BiLSTM layers, ``proj_w``, ``proj_b``;
- ``transformer_params_from_numpy``: embeddings, LayerNorms, the dense
  layers (``[in, out]`` weights);
- ``hash_featurizer_params_from_numpy``: the hash featurizer's ``table``
  and ``pos``;
- ``verdict_params_from_numpy``: the verdict model's ``body`` (a
  transformer tree), ``head_dense`` and ``head_out``;
- ``verdict_opt_state_from_numpy``: the reference's optax AdamW state
  (its step count and both moment trees) as the port's optimizer state, so
  that both packages resume training from the same point;
- ``train_state_from_numpy``: the JAX package's contrastive ``TrainState``
  (both encoders, the queue, its pointer, the step, and the optimizer's
  count with Adam's moments or SGD's momentum trace) as the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from ircl_tpu_torch.utils.device import resolve_device
from ircl_tpu_torch.utils.tree import tree_map


def to_device(tree, device):
    """The same tree with every tensor moved to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def _from_numpy(tree, device):
    device = resolve_device(device)
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), device=device), tree
    )


def _require(tree, keys, what):
    missing = [k for k in keys if k not in tree]
    if missing:
        raise KeyError(f"{what} lacks {missing}")


def encoder_params_from_numpy(params, device=None):
    """``{"lstm": [{"fwd": {w_ih, w_hh, b}, "bwd": ...}, ...], "proj_w",
    "proj_b"}`` of numpy arrays -> the same tree of f32 tensors."""
    _require(params, ("lstm", "proj_w", "proj_b"), "encoder params")
    for layer in params["lstm"]:
        for d in layer.values():
            _require(d, ("w_ih", "w_hh", "b"), "a BiLSTM direction")
    return _from_numpy(params, device)


def transformer_params_from_numpy(params, device=None):
    """``init_transformer_params``' tree of numpy arrays -> f32 tensors."""
    _require(params, ("tok_emb", "pos_emb", "type_emb", "emb_ln", "layers"),
             "transformer params")
    for lp in params["layers"]:
        _require(lp, ("q", "k", "v", "o", "attn_ln", "ff_ln", "ff1", "ff2"),
                 "a transformer layer")
    return _from_numpy(params, device)


def hash_featurizer_params_from_numpy(params, device=None):
    """``HashEmbedFeaturizer.params`` (``{"table", "pos"}``) -> tensors."""
    _require(params, ("table", "pos"), "hash featurizer params")
    return _from_numpy({"table": params["table"], "pos": params["pos"]}, device)


def verdict_params_from_numpy(params, device=None):
    """``init_verdict_params``' tree (``body``, ``head_dense``,
    ``head_out``) of numpy arrays -> f32 tensors."""
    _require(params, ("body", "head_dense", "head_out"), "verdict params")
    for name in ("head_dense", "head_out"):
        _require(params[name], ("w", "b"), f"the verdict {name}")
    return {
        "body": transformer_params_from_numpy(params["body"], device),
        "head_dense": _from_numpy(params["head_dense"], device),
        "head_out": _from_numpy(params["head_out"], device),
    }


def verdict_opt_state_from_numpy(count, mu, nu, device=None):
    """The state of ``optax.adamw`` as ``make_verdict_optimizer`` keeps it:
    ``count`` (the one step count that optax's Adam and its schedule share,
    an int), ``mu`` and ``nu`` (the moment trees over ``init_verdict_params``'
    structure, numpy arrays) -> ``{"count", "mu", "nu"}`` with f32 tensors."""
    return {
        "count": int(count),
        "mu": verdict_params_from_numpy(mu, device),
        "nu": verdict_params_from_numpy(nu, device),
    }


def train_state_from_numpy(params_q, params_k, queue, queue_ptr, step, *, count,
                           mu=None, nu=None, trace=None, device=None):
    """The JAX package's contrastive ``TrainState`` after ``np.asarray`` on
    every leaf -> the port's ``TrainState`` on ``device``. The optimizer's
    state is given explicitly, as optax keeps it: for Adam ``count`` (the
    step count of ``scale_by_adam``), ``mu`` and ``nu``; for SGD ``count``
    (the step count of the cosine schedule) and ``trace`` (the momentum)."""
    from ircl_tpu_torch.contrastive.state import TrainState

    if (trace is None) == (mu is None or nu is None):
        raise ValueError("give mu and nu (Adam) or trace (SGD)")
    moments = ({"mu": encoder_params_from_numpy(mu, device),
                "nu": encoder_params_from_numpy(nu, device)} if trace is None
               else {"trace": encoder_params_from_numpy(trace, device)})
    return TrainState(
        params_q=encoder_params_from_numpy(params_q, device),
        params_k=encoder_params_from_numpy(params_k, device),
        opt_state={"count": int(count), **moments},
        queue=torch.tensor(np.asarray(queue, np.float32), device=resolve_device(device)),
        queue_ptr=int(queue_ptr),
        step=int(step),
    )
