"""Plain reference of the Moonlight-16B-A3B verdict model: float32 ``torch``,
TF32 off, with activations rounded to bf16 where the configuration rounds.

The model is the published ``deepseek_v3`` decoder (``modeling_deepseek.py``
of moonshotai/Moonlight-16B-A3B) with a linear ``score`` head of
``hidden -> num_labels`` and no bias on the final-normed hidden state of each
pair's last token, as HuggingFace's ``*ForSequenceClassification``
decoders pool. Each layer: ``x + MLA(RMSNorm(x))``, then ``+ SwiGLU`` (the
first ``first_k_dense_replace`` layers) or ``+ MoE`` (the others).

- RMSNorm: ``w * bf16(x * rsqrt(mean(x^2) + eps))`` normalised in f32; the
  attention's ``kv_a_layernorm`` at eps 1e-6, the published class's default.
- MLA without a query LoRA: q per head (``qk_nope_head_dim`` +
  ``qk_rope_head_dim``), the compressed kv split into the normed latent
  (expanded per head into k_nope and v by ``kv_b``) and one shared rope key;
  interleaved RoPE (pairs de-interleaved, then rotate-half) at ``rope_theta``
  without scaling, cos and sin rounded to bf16; scores scaled by
  ``1 / sqrt(qk_nope + qk_rope)`` in bf16; a causal softmax in f32, its
  probabilities rounded to bf16 for the product with v.
- MoE: ``sigmoid(x W_g^T)`` in f32, the top ``num_experts_per_tok`` of the
  scores plus ``e_score_correction_bias`` picked, weighted by the unbiased
  scores over their sum times ``routed_scaling_factor``; the weighted sum of
  the expert outputs in f32, then the shared experts' SwiGLU of width
  ``n_shared_experts * moe_intermediate_size`` added in bf16.

Every matrix product takes bf16-valued operands, sums in f32 (exact
products) and is rounded to bf16; elementwise steps round after each
operation, as bf16 tensors do; residual adds round to bf16.

Departures from the published forward, none of which changes the function:
the pairs run at their real lengths, each pair's attention alone (no pads,
so the causal mask is the whole mask); the token-wise steps run on all the
pairs' tokens at once; the experts run as a loop over the experts, each
over the (token, pick) places that chose it, their outputs then summed per
token in pick order (best biased score first).

Weights are drawn as the program draws them, leaf by leaf from ``(seed, leaf
index)`` (``leaf_specs``), one layer at a time: N(0, ``init_std``) rounded to
bf16 for matrices and the embedding, ones for norm weights, N(0,
``bias_std``) in f32 for the correction bias. ``experts_fp8`` is the control: every expert product's
operands (routed and shared) rounded to fp8 e4m3 with a scale a row.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

BF16 = torch.bfloat16
F32 = torch.float32
KV_NORM_EPS = 1e-6


def rb(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, held in its own type (f32, or f64 in the
    witness)."""
    return x.to(BF16).to(x.dtype)


class Body:
    """The sizes of a ``deepseek_v3`` ``config.json`` (and the configuration
    file's ``verdict`` and ``assumed_init`` entries)."""

    def __init__(self, c: dict):
        self.vocab, self.h, self.layers = c["vocab_size"], c["hidden_size"], c["num_hidden_layers"]
        self.first_dense, self.inter = c["first_k_dense_replace"], c["intermediate_size"]
        self.nh, self.dn, self.dr = (c["num_attention_heads"], c["qk_nope_head_dim"],
                                     c["qk_rope_head_dim"])
        self.dv, self.rank = c["v_head_dim"], c["kv_lora_rank"]
        self.E, self.k, self.ie = (c["n_routed_experts"], c["num_experts_per_tok"],
                                   c["moe_intermediate_size"])
        self.shared = c["n_shared_experts"] * self.ie
        self.scaling, self.norm_topk = c["routed_scaling_factor"], c["norm_topk_prob"]
        self.eps, self.theta = c["rms_norm_eps"], float(c["rope_theta"])
        self.labels = c["verdict"]["num_labels"]
        self.init_std, self.bias_std = c["assumed_init"]["init_std"], c["assumed_init"]["bias_std"]


def leaf_specs(b: Body) -> List[tuple]:
    """``(path, shape, kind)`` in draw order: the embedding; per layer the
    input norm, q, kv_a, kv_norm, kv_b, o, the post norm, then the dense
    SwiGLU's gate, up, down or the MoE's router, bias, experts' gate, up,
    down and the shared experts' gate, up, down; the final norm; the score
    head."""
    out = [(("embed",), (b.vocab, b.h), "w")]
    for n in range(b.layers):
        out += [((n, "input_norm"), (b.h,), "one"),
                ((n, "q"), (b.nh * (b.dn + b.dr), b.h), "w"),
                ((n, "kv_a"), (b.rank + b.dr, b.h), "w"),
                ((n, "kv_norm"), (b.rank,), "one"),
                ((n, "kv_b"), (b.nh * (b.dn + b.dv), b.rank), "w"),
                ((n, "o"), (b.h, b.nh * b.dv), "w"),
                ((n, "post_norm"), (b.h,), "one")]
        if n < b.first_dense:
            out += [((n, "gate"), (b.inter, b.h), "w"), ((n, "up"), (b.inter, b.h), "w"),
                    ((n, "down"), (b.h, b.inter), "w")]
        else:
            out += [((n, "router"), (b.E, b.h), "w"), ((n, "bias"), (b.E,), "bias"),
                    ((n, "gate"), (b.E, b.ie, b.h), "w"), ((n, "up"), (b.E, b.ie, b.h), "w"),
                    ((n, "down"), (b.E, b.h, b.ie), "w"),
                    ((n, "shared_gate"), (b.shared, b.h), "w"),
                    ((n, "shared_up"), (b.shared, b.h), "w"),
                    ((n, "shared_down"), (b.h, b.shared), "w")]
    return out + [(("norm",), (b.h,), "one"), (("score",), (b.labels, b.h), "w")]


def leaf_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


class Weights:
    """Leaves drawn anew on demand, in f32 (bf16 values but the bias), held
    in ``dtype``."""

    def __init__(self, b: Body, seed: int, device, dtype=F32):
        self.b, self.seed, self.device, self.dtype = b, seed, device, dtype
        self.where = {path: (i, shape, kind) for i, (path, shape, kind) in enumerate(leaf_specs(b))}

    def __call__(self, *path) -> torch.Tensor:
        i, shape, kind = self.where[path]
        if kind == "one":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(leaf_seed(self.seed, i))
        x = torch.randn(shape, generator=gen, dtype=F32, device=self.device)
        if kind == "bias":
            return (x * self.b.bias_std).to(self.dtype)
        return rb(x * self.b.init_std).to(self.dtype)


def rms_norm(x, w, eps):
    return rb(w * rb(x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)))


def fp8_rows(t: torch.Tensor) -> torch.Tensor:
    """Each row of ``t`` rounded to fp8 e4m3 at the scale that takes its
    largest magnitude to 448."""
    scale = t.abs().amax(-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def product(x, w, fp8=False):
    """``bf16(x @ w^T)``; with ``fp8`` both operands' rows in fp8 first."""
    if fp8:
        x, w = fp8_rows(x), fp8_rows(w)
    return rb(x @ w.T)


def swiglu(x, gate, up, down, fp8=False):
    g, u = product(x, gate, fp8), product(x, up, fp8)
    return product(rb(rb(torch.nn.functional.silu(g)) * u), down, fp8)


def rope(x, cos, sin):
    """Interleaved RoPE on ``x [..., n, d]`` with bf16 ``cos, sin [n, d]``."""
    *lead, n, d = x.shape
    x = x.reshape(*lead, n, d // 2, 2).transpose(-1, -2).reshape(*lead, n, d)
    rot = torch.cat((-x[..., d // 2:], x[..., : d // 2]), dim=-1)
    return rb(rb(x * cos) + rb(rot * sin))


def attention(b: Body, W: Weights, n_layer: int, x, spans, cos, sin):
    """MLA of the normed ``x [T, h]``, each pair (``spans``: start, length)
    on its own."""
    T = x.shape[0]
    q = product(x, W(n_layer, "q")).view(T, b.nh, b.dn + b.dr)
    ckv = product(x, W(n_layer, "kv_a"))
    latent, k_pe = ckv[:, : b.rank], ckv[:, b.rank:]
    kv = product(rms_norm(latent, W(n_layer, "kv_norm"), KV_NORM_EPS), W(n_layer, "kv_b"))
    kv = kv.view(T, b.nh, b.dn + b.dv)
    ctx = torch.empty((T, b.nh * b.dv), dtype=x.dtype, device=x.device)
    scale = 1.0 / math.sqrt(b.dn + b.dr)
    for lo, n in spans:
        qp = q[lo:lo + n].transpose(0, 1)  # [nh, n, dn + dr]
        kvp = kv[lo:lo + n].transpose(0, 1)
        q_pe = rope(qp[..., b.dn:], cos[:n], sin[:n])
        k_pe_p = rope(k_pe[lo:lo + n][None], cos[:n], sin[:n]).expand(b.nh, n, b.dr)
        qs = torch.cat((qp[..., : b.dn], q_pe), dim=-1)
        ks = torch.cat((kvp[..., : b.dn], k_pe_p), dim=-1)
        s = rb(rb(qs @ ks.transpose(-1, -2)) * scale)
        causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
        p = rb(torch.softmax(torch.where(causal, s, float("-inf")), dim=-1))
        ctx[lo:lo + n] = rb(p @ kvp[..., b.dn:]).transpose(0, 1).reshape(n, b.nh * b.dv)
    return product(ctx, W(n_layer, "o"))


def moe(b: Body, W: Weights, n_layer: int, x, fp8=False):
    scores = torch.sigmoid(x @ W(n_layer, "router").T)
    _, idx = torch.topk(scores + W(n_layer, "bias"), b.k, dim=-1)
    weight = scores.gather(-1, idx)
    if b.norm_topk and b.k > 1:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    weight = weight * b.scaling
    gate, up, down = W(n_layer, "gate"), W(n_layer, "up"), W(n_layer, "down")
    out = torch.zeros((x.shape[0], b.k, b.h), dtype=x.dtype, device=x.device)
    for e in range(b.E):
        tok, pick = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            out[tok, pick] = swiglu(x[tok], gate[e], up[e], down[e], fp8)
    del gate, up, down
    y = rb((out * weight[..., None]).sum(1))
    shared = swiglu(x, W(n_layer, "shared_gate"), W(n_layer, "shared_up"),
                    W(n_layer, "shared_down"), fp8)
    return rb(y + shared)


def probabilities(c: dict, seed: int, seqs: Sequence[np.ndarray], device,
                  experts_fp8: bool = False, accumulate=F32) -> np.ndarray:
    """Label probabilities ``[len(seqs), num_labels]`` (f64) of the pairs
    whose real token ids are ``seqs``, on weights drawn from ``seed``.
    ``accumulate=torch.float64`` is the witness: every sum in f64, the
    roundings to bf16 where they are, so only the sums' errors differ."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _probabilities(Body(c), seed, seqs, torch.device(device), experts_fp8,
                                  accumulate)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _probabilities(b: Body, seed, seqs, device, fp8, dtype):
    W = Weights(b, seed, device, dtype)
    lengths = [len(s) for s in seqs]
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    spans = list(zip(starts.tolist(), lengths))
    tokens = torch.as_tensor(np.concatenate(seqs), dtype=torch.long, device=device)
    x = W("embed")[tokens]
    L = max(lengths)
    inv_freq = 1.0 / (b.theta ** (torch.arange(0, b.dr, 2, device=device).float() / b.dr))
    freqs = torch.outer(torch.arange(L, device=device, dtype=F32), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    cos, sin = rb(emb.cos()).to(dtype), rb(emb.sin()).to(dtype)
    for n in range(b.layers):
        a = attention(b, W, n, rms_norm(x, W(n, "input_norm"), b.eps), spans, cos, sin)
        x = rb(x + a)
        h = rms_norm(x, W(n, "post_norm"), b.eps)
        if n < b.first_dense:
            f = swiglu(h, W(n, "gate"), W(n, "up"), W(n, "down"))
        else:
            f = moe(b, W, n, h, fp8)
        x = rb(x + f)
    last = torch.as_tensor(starts + np.asarray(lengths) - 1, device=device)
    pooled = rms_norm(x[last], W("norm"), b.eps)
    logits = product(pooled, W("score"))
    return torch.softmax(logits.double(), dim=-1).cpu().numpy()
