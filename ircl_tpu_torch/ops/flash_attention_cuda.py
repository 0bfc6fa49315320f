"""Flash-attention forward: a CUDA kernel and its plain version.

Counterpart of the library kernel ``jax.experimental.pallas.ops.tpu.
flash_attention`` that ``ircl_tpu/models/transformer.py:194`` calls when
``TransformerConfig.attention == "flash"`` (the verdict model). Per
(b, h) and query row i:

    s_ij = (q_i . k_j) * sm_scale + (seg_q[b, i] == seg_kv[b, j] ? 0 : MASK)
    o_i  = sum_j softmax_j(s_i) v_j

with ``MASK = DEFAULT_MASK_VALUE``, added after the scale as the library
adds it. Pad query rows (segment 0) attend to the pad keys only; the
transformer's pooling reads real rows, so that differs from the "xla" path
by design and is reproduced here.

``flash_attention`` takes the library's arguments and refuses what the
library refuses, in its words: sequence lengths under 128, and a key length
that is not a multiple of 128. On CUDA tensors it launches
``csrc/flash_attention.cu`` (see the note there), which takes 64-wide
heads only and raises for others; on CPU tensors it runs
``flash_attention_ref``, the whole softmax in full fp32, at any width. Only
the forward is ported: the served path is float32 and never
differentiates, so ``causal=True``, a bias ``ab`` and bf16 inputs raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ircl_tpu_torch.utils.precision import float32_precision

DEFAULT_MASK_VALUE = -0.7 * torch.finfo(torch.float32).max
_BLOCK = 128  # the library's default block_q / block_k_major / block_k
_HEAD_DIM = 64  # the kernel's head width (csrc/flash_attention.cu)


class SegmentIds(NamedTuple):
    """Segment ids of the query and key sequences, ``[B, L]`` int32 each:
    a query attends only to keys of its own segment."""

    q: torch.Tensor
    kv: torch.Tensor


def _verify_block(block_name, dim_name, block, dim, should_divide=True):
    if block > dim:
        raise ValueError(
            f"{block_name}={block} should be smaller or equal to {dim_name}={dim}"
        )
    if should_divide and dim % block != 0:
        raise ValueError(
            f"{dim_name}={dim} should be divisible by {block_name}={block}"
        )


def _check_args(q, k, v, ab, segment_ids, causal):
    """The library's shape checks and block checks, then what the port does
    not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [batch, heads, seq_len, head_dim]")
    batch_size, num_heads, q_seq_len, d_model = q.shape
    batch_size_k, num_heads_k, kv_seq_len, d_model_k = k.shape
    batch_size_v, num_heads_v, kv_seq_len_v, d_model_v = v.shape
    if batch_size != batch_size_k or batch_size != batch_size_v:
        raise ValueError(
            f"Batch size mismatch: got {batch_size}, {batch_size_k} and"
            f" {batch_size_v} (for q, k, v respectively)"
        )
    if num_heads != num_heads_k or num_heads != num_heads_v:
        raise ValueError(
            f"Head count mismatch: got {num_heads}, {num_heads_k},"
            f" {num_heads_v} (for q, k, v respectively)"
        )
    if d_model != d_model_k:
        raise ValueError(
            f"Model dimension mismatch: got {d_model} and {d_model_k} (for q and k"
            " respectively)"
        )
    if d_model != d_model_v:
        raise NotImplementedError(
            "V model dimension unequal to KV model dimension unsupported"
        )
    if kv_seq_len != kv_seq_len_v:
        raise ValueError(
            f"KV sequence length mismatch: got {kv_seq_len} and {kv_seq_len_v}"
        )
    if segment_ids is not None:
        if tuple(segment_ids.q.shape) != (batch_size, q_seq_len):
            raise ValueError(
                f"Q segment ids shape mismatch: expected (batch_size={batch_size},"
                f" q_seq_len={q_seq_len},), got {tuple(segment_ids.q.shape)}"
            )
        if tuple(segment_ids.kv.shape) != (batch_size, kv_seq_len):
            raise ValueError(
                f"KV segment ids shape mismatch: expected (batch_size={batch_size},"
                f" kv_seq_len={kv_seq_len},), got {tuple(segment_ids.kv.shape)}"
            )
    _verify_block("block_q", "q_seq_len", _BLOCK, q_seq_len, should_divide=False)
    _verify_block("block_k_major", "kv_seq_len", _BLOCK, kv_seq_len)
    if ab is not None:
        raise NotImplementedError(
            "an attention bias ab is not ported: the reference never passes one"
        )
    if causal:
        raise NotImplementedError(
            "causal=True is not ported: the reference calls flash attention "
            "with causal=False only"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype == torch.bfloat16:
            raise NotImplementedError(
                f"bf16 {name} is not ported: the served verdict path is float32; "
                "bf16 comes with verdict training (ROADMAP.md queue 1 item 11)"
            )
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    devices = {q.device, k.device, v.device}
    if segment_ids is not None:
        devices |= {segment_ids.q.device, segment_ids.kv.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and the segment ids lie on {sorted(map(str, devices))}")


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, Lq, hd] f32
    k: torch.Tensor,  # [B, H, Lk, hd] f32
    v: torch.Tensor,  # [B, H, Lk, hd] f32
    segment_ids: SegmentIds = None,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Plain version: the whole ``[B, H, Lq, Lk]`` softmax, matrix products
    in full fp32 (TF32 off), as the library's ``mha_reference`` computes
    it. Returns ``[B, H, Lq, hd]`` f32."""
    with float32_precision():
        logits = q @ k.transpose(-1, -2)
        if sm_scale != 1.0:
            logits = logits * sm_scale
        if segment_ids is not None:
            same = segment_ids.q[:, None, :, None] == segment_ids.kv[:, None, None, :]
            logits = logits + torch.where(same, 0.0, DEFAULT_MASK_VALUE)
        m = logits.amax(dim=-1, keepdim=True)
        unnormalized = torch.exp(logits - m)
        weights = unnormalized / unnormalized.sum(dim=-1, keepdim=True)
        return weights @ v


def flash_attention(
    q: torch.Tensor,  # [B, H, Lq, hd] f32
    k: torch.Tensor,  # [B, H, Lk, hd] f32
    v: torch.Tensor,  # [B, H, Lk, hd] f32
    ab=None,
    segment_ids: SegmentIds = None,
    *,
    causal: bool = False,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Non-causal multi-head attention with segment-id masking,
    ``[B, H, Lq, hd]`` f32. CUDA tensors launch ``csrc/flash_attention.cu``;
    CPU tensors run ``flash_attention_ref``."""
    _check_args(q, k, v, ab, segment_ids, causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, segment_ids, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    from ircl_tpu_torch.utils.kernel_build import load_kernels

    B, H, Lq, hd = q.shape
    Lk = k.shape[2]
    if hd != _HEAD_DIM:
        raise NotImplementedError(
            f"head_dim={hd}: the kernel takes heads {_HEAD_DIM} wide, as every "
            "BERT and RoBERTa size has"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    seg_q = seg_kv = None
    if segment_ids is not None:
        seg_q = segment_ids.q.to(torch.int32).contiguous()
        seg_kv = segment_ids.kv.to(torch.int32).contiguous()
    kern = load_kernels()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = kern.lib.ircl_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if seg_q is None else seg_q.data_ptr(),
            0 if seg_kv is None else seg_kv.data_ptr(),
            B, H, Lq, Lk, hd, float(sm_scale), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kern.check(rc, "flash-attention launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
