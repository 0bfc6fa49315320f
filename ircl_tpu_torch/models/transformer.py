"""BERT-compatible transformer encoder on tensors.

Counterpart of ``ircl_tpu/models/transformer.py``, which stands in for the
reference's HuggingFace ``BertModel`` featurizer
(``src/contrastor/contrastive_module.py:32-41``): learned word / position /
token-type embeddings and post-LN encoder blocks (MHA -> Add&LN -> exact
GELU FFN -> Add&LN). Parameters are a plain dict of tensors with the JAX
package's layout (dense weights ``[in, out]``), so ``utils/convert.py``
carries them across unchanged.

Ported: the dense model on both attention paths. ``"xla"`` adds a -1e9
pad bias and takes a plain softmax; ``"flash"`` (the verdict model's)
gives pads segment 0 and real tokens segment 1 and calls
``ops/flash_attention_cuda.py::flash_attention``, which launches CUDA
kernels on the card, forward and backward. Every function here runs under
autograd: verdict training differentiates the whole body, the matrix
products and LayerNorms through autograd and the flash attention through
its own backward kernels. LayerNorm is the population variance with
``layernorm_eps`` (1e-12), as ``_ln`` computes it. The embedding gathers
clamp their indices into range, as JAX's gather does: the verdict model has
one token type while the pair encoder writes type 1 after the first
``[SEP]``, and the reference then reads row 0. Like the transpose of JAX's
gather, the gradient of a clamped read is dropped, not added to the row it
read. Not ported yet, and refused with ``NotImplementedError``: the MoE FFN
(ROADMAP.md queue 1 item 9), the explicit-collective axes
``model_axis``/``expert_axis``/``seq_axis`` and the sharding hooks (item
12), and ``from_huggingface``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ircl_tpu_torch.ops.flash_attention_cuda import SegmentIds, flash_attention
from ircl_tpu_torch.utils.convert import to_device
from ircl_tpu_torch.utils.device import resolve_device


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1 item {item})"
    )


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
    moe: Optional[Any] = None  # a MoE FFN is not ported (item 9)

    def __post_init__(self):
        if self.attention not in ("xla", "flash"):
            raise ValueError(f"unknown attention {self.attention!r}")
        if self.moe is not None:
            raise _not_ported("the MoE FFN (TransformerConfig.moe)", 9)


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
        lp["ff1"] = {"w": _dense_init(gen, (h, i)), "b": torch.zeros(i)}
        lp["ff2"] = {"w": _dense_init(gen, (i, h)), "b": torch.zeros(h)}
        p["layers"].append(lp)
    return to_device(p, device)


def _ln(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def _dense(x, p):
    return (x @ p["w"].to(x.dtype)).to(x.dtype) + p["b"]


def transformer_embed(
    params: Dict,
    cfg: TransformerConfig,
    ids: torch.Tensor,  # [B, L] int
    type_ids: Optional[torch.Tensor] = None,
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
    pos = torch.arange(L, device=ids.device) + cfg.position_offset
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


def attention_sublayer(
    x: torch.Tensor,  # [B, L, hidden]
    lp: Dict,  # one entry of params["layers"]
    cfg: TransformerConfig,
    attn_ctx,  # attention_mask_inputs(cfg, mask)
    model_axis: Optional[str] = None,
    seq_axis: Optional[str] = None,
) -> torch.Tensor:
    """MHA -> Add&LN (the first half of a post-LN block)."""
    if model_axis is not None or seq_axis is not None:
        raise _not_ported("model_axis/seq_axis attention", 12)
    B, L, _ = x.shape
    hd = cfg.hidden // cfg.heads
    nh = lp["q"]["w"].shape[-1] // hd

    def heads(p):
        return _dense(x, p).reshape(B, L, nh, hd).transpose(1, 2)

    q, k, v = heads(lp["q"]), heads(lp["k"]), heads(lp["v"])
    if cfg.attention == "flash":
        ctx = flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), segment_ids=attn_ctx,
            causal=False, sm_scale=1.0 / math.sqrt(hd),
        ).to(cfg.dtype)
    else:
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd) + attn_ctx
        probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
        ctx = (probs @ v).to(cfg.dtype)
    ctx = ctx.transpose(1, 2).reshape(B, L, nh * hd)
    proj = (ctx @ lp["o"]["w"].to(cfg.dtype)).to(cfg.dtype)
    return _ln(x + (proj + lp["o"]["b"]), lp["attn_ln"], cfg.layernorm_eps)


def transformer_block(
    x: torch.Tensor,  # [B, L, hidden]
    lp: Dict,
    cfg: TransformerConfig,
    attn_ctx,
    model_axis: Optional[str] = None,
    expert_axis: Optional[str] = None,
    seq_axis: Optional[str] = None,
) -> torch.Tensor:
    """One post-LN encoder block (MHA -> Add&LN -> FFN -> Add&LN)."""
    if model_axis is not None or expert_axis is not None or seq_axis is not None:
        raise _not_ported("model_axis/expert_axis/seq_axis blocks", 12)
    x = attention_sublayer(x, lp, cfg, attn_ctx)
    h1 = F.gelu(_dense(x, lp["ff1"]))  # exact (erf) GELU
    ff = (h1 @ lp["ff2"]["w"].to(h1.dtype)).to(h1.dtype) + lp["ff2"]["b"]
    return _ln(x + ff, lp["ff_ln"], cfg.layernorm_eps)


def transformer_apply_with_aux(
    params: Dict,
    cfg: TransformerConfig,
    ids: torch.Tensor,  # [B, L] int
    mask: torch.Tensor,  # [B, L] f32 (1 = real token)
    type_ids: Optional[torch.Tensor] = None,
    constrain=None,
    ep_constrain=None,
):
    """(last hidden state [B, L, hidden], mean MoE aux loss: 0 for the dense
    model, the only one ported). The reference's sharding hooks
    (``constrain``, ``ep_constrain``) and ``pos_start`` (context
    parallelism) wait for ROADMAP.md queue 1 item 12."""
    if constrain is not None or ep_constrain is not None:
        raise _not_ported("the constrain/ep_constrain sharding hooks", 12)
    x = transformer_embed(params, cfg, ids, type_ids)
    attn_ctx = attention_mask_inputs(cfg, mask)
    for lp in params["layers"]:
        x = transformer_block(x, lp, cfg, attn_ctx)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def transformer_apply(
    params: Dict,
    cfg: TransformerConfig,
    ids: torch.Tensor,  # [B, L] int
    mask: torch.Tensor,  # [B, L] f32 (1 = real token)
    type_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Last hidden state [B, L, hidden] (the aux loss discarded)."""
    return transformer_apply_with_aux(params, cfg, ids, mask, type_ids)[0]


def from_huggingface(name: str = "bert-base-uncased"):
    """Refused: HuggingFace checkpoints are read from a local cache, and the
    repository holds neither the weights nor the tokenizer files."""
    raise NotImplementedError(
        f"from_huggingface({name!r}) needs the {name} weights and tokenizer "
        "files (config.json, the model weights, vocab.txt) from a local "
        "HuggingFace cache; the repository holds none of them, so this "
        "loader waits until they are added"
    )
