"""Moonlight-16B-A3B, DeepSeek-V3's decoder block, as a causal verdict body.

A pre-norm decoder in bf16: token embedding, then ``layers`` blocks of
``x + MLA(RMSNorm(x))`` and ``+ FFN(RMSNorm(.))``, where the FFN is a SwiGLU
of width ``intermediate`` in the first ``first_dense`` blocks and the
dropless MoE of ``models/moe_dropless.py`` after them (``experts`` routed
SwiGLU experts of width ``expert_width``, ``experts_per_token`` a token, plus
``shared_experts`` of them fused into one SwiGLU on every token); a final
RMSNorm; the hidden state at each row's last real token. ``verdict/model.py``
puts a linear ``score`` head (no bias) on it, as HuggingFace's
``*ForSequenceClassification`` decoders do.

Latent attention (MLA) without a query LoRA, as the published
``modeling_deepseek.py`` writes it: q = ``x W_q^T`` per head, ``nope`` and
``rope`` dims; the compressed kv ``x W_kva^T`` split into the latent (RMSNorm
at eps 1e-6, the published ``kv_a_layernorm``'s default) and one rope key
shared by the heads; the latent expanded per head into k_nope and v by
``W_kvb``. The rope dims are rotated by the published interleaved RoPE (pairs
de-interleaved, then rotate-half, at ``rope_theta`` without scaling), scores
scaled by ``1 / sqrt(nope + rope)``, and a causal mask is combined with the
pad mask. Attention is the plain path: products and an f32 softmax.

Rounding, as the published model rounds in bf16: every product takes bf16
operands, sums in f32 and rounds its output to bf16 (``_linear``; on the
card cuBLAS with reduced-precision reductions off); RMSNorm normalises in f32
and rounds before its weight; the router, the attention softmax and the
weighted sum of a token's expert outputs run in f32; elementwise steps
(RoPE, the score scale, silu, residual adds) round after each operation.

Parameters (``init_mla_moe_params``) are drawn leaf by leaf from
``(seed, leaf index)`` on the target device (``leaf_specs`` gives the order),
so that a reference can draw the same values again without the program:
N(0, ``init_std``) in f32 rounded to bf16 for matrices and tables, ones for
norm weights, N(0, ``bias_std``) in f32 for ``e_score_correction_bias``. The
program's layout fuses the dense and shared SwiGLUs' gate and up rows
(``gate_up``) and interleaves each routed expert's (``w13``,
``ops/moe_grouped_gemm_cuda.py::interleave_gate_up``).

Tracing: each layer's attention is the span ``attention.mla`` and each MoE
layer's steps ``moe.route``, ``moe.experts`` and ``moe.combine``
(``utils/profiling.py``). ``mla_moe_forward`` can hand back every MoE
layer's expert offsets, on the device; ``ExpertCounters`` reads them once
they reach the host with the probabilities.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ircl_tpu_torch.models import moe_dropless
from ircl_tpu_torch.ops.moe_grouped_gemm_cuda import interleave_gate_up
from ircl_tpu_torch.utils.device import resolve_device
from ircl_tpu_torch.utils.profiling import span

_BF16 = torch.bfloat16
KV_NORM_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class MLAMoEConfig:
    vocab_size: int = 163840
    hidden: int = 2048
    layers: int = 27
    first_dense: int = 1
    intermediate: int = 11264
    heads: int = 16
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128
    kv_rank: int = 512
    experts: int = 64
    experts_per_token: int = 6
    shared_experts: int = 2
    expert_width: int = 1408
    routed_scaling: float = 2.446
    norm_topk: bool = True
    rms_eps: float = 1e-5
    rope_theta: float = 50000.0
    num_labels: int = 2
    init_std: float = 0.02
    bias_std: float = 0.03

    @property
    def softmax_scale(self) -> float:
        return 1.0 / math.sqrt(self.qk_nope + self.qk_rope)

    @classmethod
    def from_hf(cls, c: dict, num_labels: int = 2, **kw) -> "MLAMoEConfig":
        """The body of a published ``deepseek_v3`` ``config.json``. Refuses
        what this body does not implement: another router, expert groups, a
        query LoRA, rope scaling, biased attention, or MoE layers not every
        layer."""
        want = {"scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
                "topk_group": 1, "q_lora_rank": None, "hidden_act": "silu",
                "moe_layer_freq": 1, "attention_bias": False, "rope_scaling": None}
        bad = {k: c.get(k) for k, v in want.items() if c.get(k, v) != v}
        if bad:
            raise ValueError(f"not implemented by this body: {bad}")
        return cls(
            vocab_size=c["vocab_size"], hidden=c["hidden_size"], layers=c["num_hidden_layers"],
            first_dense=c["first_k_dense_replace"], intermediate=c["intermediate_size"],
            heads=c["num_attention_heads"], qk_nope=c["qk_nope_head_dim"],
            qk_rope=c["qk_rope_head_dim"], v_head=c["v_head_dim"], kv_rank=c["kv_lora_rank"],
            experts=c["n_routed_experts"], experts_per_token=c["num_experts_per_tok"],
            shared_experts=c["n_shared_experts"], expert_width=c["moe_intermediate_size"],
            routed_scaling=c["routed_scaling_factor"], norm_topk=c["norm_topk_prob"],
            rms_eps=c["rms_norm_eps"], rope_theta=float(c["rope_theta"]),
            num_labels=num_labels, **kw)


def leaf_specs(cfg: MLAMoEConfig) -> List[tuple]:
    """``(path, shape, kind)`` of every drawn leaf in draw order; ``kind``
    is ``"w"`` (a bf16 matrix or table), ``"one"`` (a norm weight) or
    ``"bias"`` (the router's f32 correction bias). Paths follow the
    published names: ``attn.{q, kv_a, kv_norm, kv_b, o}``, ``mlp.{gate,
    up, down}``, ``moe.{router, bias, gate, up, down}`` and
    ``moe.shared.{gate, up, down}``."""
    h, nh = cfg.hidden, cfg.heads
    specs = [(("embed",), (cfg.vocab_size, h), "w")]
    for n in range(cfg.layers):
        p = ("layers", n)
        specs += [
            (p + ("input_norm",), (h,), "one"),
            (p + ("attn", "q"), (nh * (cfg.qk_nope + cfg.qk_rope), h), "w"),
            (p + ("attn", "kv_a"), (cfg.kv_rank + cfg.qk_rope, h), "w"),
            (p + ("attn", "kv_norm"), (cfg.kv_rank,), "one"),
            (p + ("attn", "kv_b"), (nh * (cfg.qk_nope + cfg.v_head), cfg.kv_rank), "w"),
            (p + ("attn", "o"), (h, nh * cfg.v_head), "w"),
            (p + ("post_norm",), (h,), "one"),
        ]
        if n < cfg.first_dense:
            i = cfg.intermediate
            specs += [(p + ("mlp", "gate"), (i, h), "w"), (p + ("mlp", "up"), (i, h), "w"),
                      (p + ("mlp", "down"), (h, i), "w")]
        else:
            E, i, s = cfg.experts, cfg.expert_width, cfg.shared_experts * cfg.expert_width
            specs += [
                (p + ("moe", "router"), (E, h), "w"), (p + ("moe", "bias"), (E,), "bias"),
                (p + ("moe", "gate"), (E, i, h), "w"), (p + ("moe", "up"), (E, i, h), "w"),
                (p + ("moe", "down"), (E, h, i), "w"),
                (p + ("moe", "shared", "gate"), (s, h), "w"),
                (p + ("moe", "shared", "up"), (s, h), "w"),
                (p + ("moe", "shared", "down"), (h, s), "w"),
            ]
    specs += [(("norm",), (h,), "one"), (("score",), (cfg.num_labels, h), "w")]
    return specs


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` of a model drawn from ``seed``."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def draw_leaf(cfg: MLAMoEConfig, seed: int, index: int, shape, kind: str, device):
    if kind == "one":
        return torch.ones(shape, dtype=_BF16, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    if kind == "bias":
        return x.mul_(cfg.bias_std)
    return x.mul_(cfg.init_std).to(_BF16)


def init_mla_moe_params(cfg: MLAMoEConfig, seed: int, device=None):
    """The body and its ``score`` head in the program's layout, drawn on
    ``device`` (by default the card) leaf by leaf (``leaf_specs``,
    ``draw_leaf``); gate and up rows fused as they are drawn, so the largest
    transient is one layer's experts."""
    device = resolve_device(device)
    params = {"layers": [{} for _ in range(cfg.layers)]}
    held = {}
    for index, (path, shape, kind) in enumerate(leaf_specs(cfg)):
        leaf = draw_leaf(cfg, seed, index, shape, kind, device)
        if len(path) == 1:
            params[path[0]] = leaf
            continue
        layer = params["layers"][path[1]]
        rest = path[2:]
        if len(rest) == 1:
            layer[rest[0]] = leaf
        elif rest[0] == "attn":
            layer.setdefault("attn", {})[rest[1]] = leaf
        else:  # the FFN: gate and up wait for each other, then fuse
            node = layer.setdefault(rest[0], {})
            if len(rest) == 3:
                node = node.setdefault("shared", {})
            name = rest[-1]
            if name == "gate":
                held[path[:-1]] = leaf
            elif name == "up":
                gate = held.pop(path[:-1])
                if rest == ("moe", "up"):
                    node["w13"] = interleave_gate_up(gate, leaf).contiguous()
                else:
                    node["gate_up"] = torch.cat([gate, leaf])
                del gate, leaf
            else:
                node[name] = leaf
    return params


@contextlib.contextmanager
def bf16_products():
    """cuBLAS's bf16 products sum in f32 inside the block (PyTorch lets it
    reduce in bf16 by default); the caller's setting is restored after."""
    m = torch.backends.cuda.matmul
    prev = m.allow_bf16_reduced_precision_reduction, m.allow_tf32
    m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = False, False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = prev


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands, summed in f32, rounded to bf16; on the
    CPU through f32, whose products of bf16 values are exact."""
    if a.device.type == "cpu":
        return (a.float() @ b.float()).to(_BF16)
    return a @ b


def _linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _mm(x, w.T)



def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return w * y.to(x.dtype)


def rope_tables(cfg: MLAMoEConfig, length: int, device):
    """bf16 ``(cos, sin) [length, qk_rope]`` of positions ``0 .. length - 1``,
    computed in f32 as the published rotary embedding computes them."""
    d = cfg.qk_rope
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, d, 2, device=device).float() / d))
    t = torch.arange(length, device=device, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos().to(_BF16), emb.sin().to(_BF16)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The published interleaved RoPE on ``x [..., L, d]``: the pairs
    ``(x0, x1), (x2, x3) ..`` de-interleaved into halves, then rotate-half;
    each step in bf16."""
    *lead, L, d = x.shape
    x = x.reshape(*lead, L, d // 2, 2).transpose(-1, -2).reshape(*lead, L, d)
    rot = torch.cat((-x[..., d // 2:], x[..., : d // 2]), dim=-1)
    return x * cos + rot * sin


def attention_mask(real: torch.Tensor) -> torch.Tensor:
    """``[B, 1, L, L]`` true where query i may see key j: ``j <= i`` and key
    j a real token."""
    L = real.shape[1]
    causal = torch.ones((L, L), dtype=torch.bool, device=real.device).tril()
    return causal[None, None] & real[:, None, None, :]


def mla_attention(x, p, cfg: MLAMoEConfig, cos, sin, allowed) -> torch.Tensor:
    """Latent attention of ``x [B, L, hidden]`` (the normed input): ``[B, L,
    hidden]``."""
    B, L, _ = x.shape
    nh, dn, dr, dv, r = cfg.heads, cfg.qk_nope, cfg.qk_rope, cfg.v_head, cfg.kv_rank
    q = _linear(x, p["q"]).view(B, L, nh, dn + dr).transpose(1, 2)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    latent, k_pe = _linear(x, p["kv_a"]).split([r, dr], dim=-1)
    kv = _linear(rms_norm(latent, p["kv_norm"], KV_NORM_EPS), p["kv_b"])
    k_nope, v = kv.view(B, L, nh, dn + dv).transpose(1, 2).split([dn, dv], dim=-1)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe.view(B, 1, L, dr), cos, sin)
    qs = torch.cat((q_nope, q_pe), dim=-1)
    ks = torch.cat((k_nope, k_pe.expand(B, nh, L, dr)), dim=-1)
    scores = _mm(qs, ks.transpose(-1, -2)).mul_(cfg.softmax_scale)
    scores.masked_fill_(~allowed, float("-inf"))
    probs = torch.softmax(scores, dim=-1, dtype=torch.float32).to(_BF16)
    ctx = _mm(probs, v).transpose(1, 2).reshape(B, L, nh * dv)
    return _linear(ctx, p["o"])


def swiglu(x: torch.Tensor, p) -> torch.Tensor:
    """``down(silu(gate(x)) * up(x))`` with gate and up fused in ``gate_up``."""
    g, u = _linear(x, p["gate_up"]).chunk(2, dim=-1)
    return _linear(F.silu(g) * u, p["down"])


def shared_experts(x: torch.Tensor, p) -> torch.Tensor:
    """The shared experts, one SwiGLU of their summed width, on every token."""
    return swiglu(x, p)


def moe_layer(x: torch.Tensor, p, cfg: MLAMoEConfig, real: torch.Tensor):
    """The MoE FFN of ``x [T, hidden]`` (``real [T]``): (``[T, hidden]``,
    the expert offsets ``[E + 1]``)."""
    with span("moe.route"):
        idx, weight = moe_dropless.route(x, p["router"], p["bias"], cfg.experts_per_token,
                                         cfg.routed_scaling, cfg.norm_topk)
        order, offsets = moe_dropless.dispatch(idx, real, cfg.experts)
    with span("moe.experts"):
        out = moe_dropless.experts(x, order, offsets, p["w13"], p["down"], idx.shape[1])
        shared = shared_experts(x, p["shared"])
    with span("moe.combine"):
        y = moe_dropless.combine(out, order, weight, real)
    return y + shared, offsets


def mla_moe_forward(params, cfg: MLAMoEConfig, ids: torch.Tensor, mask: torch.Tensor,
                    offsets_out: Optional[list] = None) -> torch.Tensor:
    """The final-normed hidden state ``[B, hidden]`` (bf16) at each row's
    last real token of ``ids [B, L]`` (``mask`` 1 on real tokens, which come
    first in a row). With ``offsets_out`` a list, the MoE layers' expert
    offsets ``[moe layers, E + 1]`` (int32, on the device) are appended to
    it. Makes no device-to-host copy."""
    B, L = ids.shape
    real = mask > 0
    cos, sin = rope_tables(cfg, L, ids.device)
    allowed = attention_mask(real)
    real_rows = real.reshape(-1)
    x = params["embed"][ids]
    offsets = []
    with bf16_products():
        for lp in params["layers"]:
            with span("attention.mla"):
                a = mla_attention(rms_norm(x, lp["input_norm"], cfg.rms_eps), lp["attn"], cfg,
                                  cos, sin, allowed)
            x = x + a
            h = rms_norm(x, lp["post_norm"], cfg.rms_eps)
            if "mlp" in lp:
                f = swiglu(h, lp["mlp"])
            else:
                f, off = moe_layer(h.reshape(B * L, -1), lp["moe"], cfg, real_rows)
                f = f.view(B, L, -1)
                offsets.append(off)
            x = x + f
        x = rms_norm(x, params["norm"], cfg.rms_eps)
    if offsets_out is not None:
        offsets_out.append(torch.stack(offsets))
    return x[torch.arange(B, device=ids.device), last_token(mask)]


def last_token(mask: torch.Tensor) -> torch.Tensor:
    """The position of each row's last real token (``mask [B, L]``, real
    tokens first; 0 for an empty row)."""
    return (mask.sum(1).long() - 1).clamp(min=0)


def score_logits(params, cfg: MLAMoEConfig, ids, mask, offsets_out=None) -> torch.Tensor:
    """The ``score`` head on the pooled hidden state: ``[B, num_labels]``
    logits (bf16 values, as f32)."""
    pooled = mla_moe_forward(params, cfg, ids, mask, offsets_out)
    with bf16_products():
        return _linear(pooled, params["score"]).float()


@dataclasses.dataclass
class ExpertCounters:
    """Counts of the MoE layers' routing, from offsets read back on the host:
    batches, routed rows (experts_per_token times the real tokens, summed
    over batches; every layer routes the same rows) and, summed over
    batches, the mean over layers of the busiest expert's rows over the
    mean expert's."""

    batches: int = 0
    routed_rows: int = 0
    load_max_over_mean: float = 0.0

    def add(self, offsets: np.ndarray) -> None:
        counts = np.diff(np.asarray(offsets, np.int64), axis=1)  # [layers, E]
        self.batches += 1
        self.routed_rows += int(counts[0].sum())
        mean = counts.mean(axis=1)
        self.load_max_over_mean += float(np.mean(counts.max(axis=1) / np.maximum(mean, 1e-9)))
