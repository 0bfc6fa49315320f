"""The Moonlight verdict model's FLOPs and routed rows of one batch.

``work`` records a batch's real lengths at its pinned length with the
configuration's widths; ``forward_flops`` counts what the real tokens need:
2 operations a matrix parameter a token is multiplied by (q, kv_a, kv_b and
o in every layer; the dense SwiGLU in the first layers; in the MoE layers
the router, the k routed experts and the shared experts), the two attention
products over each token's causal keys (q.k over nope + rope dims, p.v over
v dims, every head), and the score head on each row's last token.
"""

from __future__ import annotations

import numpy as np


def work(cfg: dict, lengths) -> dict:
    return {"L": cfg["verdict"]["max_length"], "lengths": np.asarray(lengths, np.int64),
            "hidden": cfg["hidden_size"], "layers": cfg["num_hidden_layers"],
            "dense_layers": cfg["first_k_dense_replace"], "inter": cfg["intermediate_size"],
            "heads": cfg["num_attention_heads"], "nope": cfg["qk_nope_head_dim"],
            "rope": cfg["qk_rope_head_dim"], "v": cfg["v_head_dim"],
            "rank": cfg["kv_lora_rank"], "experts": cfg["n_routed_experts"],
            "k": cfg["num_experts_per_tok"], "expert_width": cfg["moe_intermediate_size"],
            "shared": cfg["n_shared_experts"], "labels": cfg["verdict"]["num_labels"]}


def moe_layers(w: dict) -> int:
    return w["layers"] - w["dense_layers"]


def routed_rows(w: dict) -> float:
    """Rows an MoE layer routes: k a real token."""
    return float(w["k"] * w["lengths"].sum())


def forward_flops(w: dict) -> float:
    n = w["lengths"].astype(np.float64)
    h, nh, ie = w["hidden"], w["heads"], w["expert_width"]
    attn_params = (nh * (w["nope"] + w["rope"]) * h + (w["rank"] + w["rope"]) * h
                   + nh * (w["nope"] + w["v"]) * w["rank"] + h * nh * w["v"])
    dense = 3 * h * w["inter"]
    moe = w["experts"] * h + (w["k"] + w["shared"]) * 3 * h * ie
    per_token = 2.0 * (w["layers"] * attn_params + w["dense_layers"] * dense
                       + moe_layers(w) * moe)
    causal_pairs = float((n * (n + 1) / 2).sum())
    attention = 2.0 * w["layers"] * nh * (w["nope"] + w["rope"] + w["v"]) * causal_pairs
    head = 2.0 * len(n) * h * w["labels"]
    return per_token * float(n.sum()) + attention + head
