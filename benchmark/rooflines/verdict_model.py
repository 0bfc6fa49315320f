"""The verdict classifier's model FLOPs and attention work of one batch.

``work`` records a batch's real lengths at its pinned length with the
widths of the configuration's roberta; ``forward_flops`` counts what the
real tokens need: 2 operations a non-embedding matrix parameter a token
(q, k, v, o and the FFN of every layer; the head on the first token), plus
the two attention products over the pairs of real tokens.
"""

from __future__ import annotations

import numpy as np


def work(cfg: dict, lengths) -> dict:
    r, v = cfg["roberta"], cfg["verdict"]
    return {"L": v["max_length"], "lengths": np.asarray(lengths, np.int64),
            "hidden": r["hidden_size"], "inter": r["intermediate_size"],
            "layers": r["num_hidden_layers"], "heads": r["num_attention_heads"],
            "labels": r["num_labels"]}


def forward_flops(w: dict) -> float:
    n = w["lengths"].astype(np.float64)
    h, layers = w["hidden"], w["layers"]
    per_token = 2.0 * layers * (4 * h * h + 2 * h * w["inter"])
    attention = 4.0 * layers * h * float((n * n).sum())
    head = 2.0 * len(n) * (h * h + h * w["labels"])
    return per_token * float(n.sum()) + attention + head


def live_pairs(w: dict) -> float:
    """Pairs the flash kernels' segment ids leave, a head and a layer:
    real tokens attend real tokens, pads attend pads."""
    n = w["lengths"].astype(np.float64)
    return float((n * n + (w["L"] - n) ** 2).sum())


def head_elements(w: dict) -> float:
    """Elements of one [B, heads, L, head_dim] tensor of a layer."""
    return float(len(w["lengths"]) * w["L"] * w["hidden"])
