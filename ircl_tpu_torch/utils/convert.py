"""Parameters carried across from the JAX package, and moved between devices.

The JAX package keeps parameters as nested dicts and lists of arrays; the
port keeps the same trees of tensors with the same layouts. These helpers
take the JAX side's trees after ``np.asarray`` on every leaf (this module
never imports JAX), so both packages compute the same function from the
same weights:

- ``encoder_params_from_numpy``: the BiLSTM layers, ``proj_w``, ``proj_b``;
- ``transformer_params_from_numpy``: embeddings, LayerNorms, the dense
  layers (``[in, out]`` weights);
- ``hash_featurizer_params_from_numpy``: the hash featurizer's ``table``
  and ``pos``;
- ``verdict_params_from_numpy``: the verdict model's ``body`` (a
  transformer tree), ``head_dense`` and ``head_out``.
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(tree, device):
    """The same tree with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def _from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def _require(tree, keys, what):
    missing = [k for k in keys if k not in tree]
    if missing:
        raise KeyError(f"{what} lacks {missing}")


def encoder_params_from_numpy(params, device="cpu"):
    """``{"lstm": [{"fwd": {w_ih, w_hh, b}, "bwd": ...}, ...], "proj_w",
    "proj_b"}`` of numpy arrays -> the same tree of f32 tensors."""
    _require(params, ("lstm", "proj_w", "proj_b"), "encoder params")
    for layer in params["lstm"]:
        for d in layer.values():
            _require(d, ("w_ih", "w_hh", "b"), "a BiLSTM direction")
    return _from_numpy(params, device)


def transformer_params_from_numpy(params, device="cpu"):
    """``init_transformer_params``' tree of numpy arrays -> f32 tensors."""
    _require(params, ("tok_emb", "pos_emb", "type_emb", "emb_ln", "layers"),
             "transformer params")
    for lp in params["layers"]:
        _require(lp, ("q", "k", "v", "o", "attn_ln", "ff_ln", "ff1", "ff2"),
                 "a transformer layer")
    return _from_numpy(params, device)


def hash_featurizer_params_from_numpy(params, device="cpu"):
    """``HashEmbedFeaturizer.params`` (``{"table", "pos"}``) -> tensors."""
    _require(params, ("table", "pos"), "hash featurizer params")
    return _from_numpy({"table": params["table"], "pos": params["pos"]}, device)


def verdict_params_from_numpy(params, device="cpu"):
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
