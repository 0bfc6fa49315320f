"""Flash attention, forward and backward: CUDA kernels and their plain versions.

Counterpart of the library kernels ``jax.experimental.pallas.ops.tpu.
flash_attention`` that ``ircl_tpu/models/transformer.py:194`` calls when
``TransformerConfig.attention == "flash"`` (the verdict model), and that
``jax.grad`` reaches through the library's ``custom_vjp`` when that model
trains. Per (b, h) and query row i:

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
``flash_attention_ref``, the whole softmax in full fp32, at any width. The
kernel takes both matrix products on the tensor cores, every f32 operand
split into two TF32 values (``utils/precision.py::split_tf32``) and a
product taken as three: ``s = q k^T`` on ``wgmma``, ``o += p v`` on
``mma.sync``; ``flash_attention_fwd_ref(..., products="tf32x3")`` is that
arithmetic in plain PyTorch.

It is differentiable. Where autograd is on and q, k or v asks for a
gradient, the call goes through a ``torch.autograd.Function``, as the
library's goes through its ``custom_vjp``: the forward also returns the
softmax statistics of every query row (the maximum ``m`` and the sum ``l``
of ``exp(s - m)``, ``[B, H, Lq]`` f32 each) and saves q, k, v, the segment
ids, o, l and m; the backward recomputes the probabilities from them and
launches ``csrc/flash_attention_bwd.cu``'s two kernels, one for dk and dv
and one for dq (both sequence lengths multiples of 128), or on CPU tensors
runs ``flash_attention_bwd_ref``. The backward kernels take their products
the same way; ``flash_attention_bwd_ref(..., products="tf32x3")`` is their
arithmetic in plain PyTorch. Both ``products="tf32x3"`` versions serve
tests and ``chip_smoke.py``, on no path of the port. ``flash_attention.launches``,
``flash_attention_bwd_dkv.launches`` and ``flash_attention_bwd_dq.launches``
count the kernel launches. On CUDA tensors every path launches its kernel or
raises; none gives way to a plain version.

Not ported, and refused with ``NotImplementedError``: ``causal=True``, a
bias ``ab`` (the reference passes neither) and bf16 inputs (bf16 training,
ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ircl_tpu_torch.utils.precision import float32_precision, matmul_tf32x3

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
                f"bf16 {name} is not ported: serving and training run in float32; "
                "bf16 training is what is left of ROADMAP.md queue 1 item 11"
            )
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    devices = {q.device, k.device, v.device}
    if segment_ids is not None:
        devices |= {segment_ids.q.device, segment_ids.kv.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and the segment ids lie on {sorted(map(str, devices))}")


class SoftmaxStats(NamedTuple):
    """Per query row, ``[B, H, Lq]`` f32 each: ``l`` the sum of
    ``exp(s - m)`` over the keys and ``m`` the largest score."""

    l: torch.Tensor  # noqa: E741
    m: torch.Tensor


def _scores(q, k, segment_ids, sm_scale, matmul=torch.matmul):
    """``[B, H, Lq, Lk]`` scores: scaled, then masked by the segment ids."""
    logits = matmul(q, k.transpose(-1, -2))
    if sm_scale != 1.0:
        logits = logits * sm_scale
    if segment_ids is not None:
        same = segment_ids.q[:, None, :, None] == segment_ids.kv[:, None, None, :]
        logits = logits + torch.where(same, 0.0, DEFAULT_MASK_VALUE)
    return logits


def flash_attention_fwd_ref(
    q: torch.Tensor,  # [B, H, Lq, hd] f32
    k: torch.Tensor,  # [B, H, Lk, hd] f32
    v: torch.Tensor,  # [B, H, Lk, hd] f32
    segment_ids: SegmentIds = None,
    sm_scale: float = 1.0,
    products: str = "f32",
):
    """Plain version of the forward: the whole ``[B, H, Lq, Lk]`` softmax,
    matrix products in full fp32 (TF32 off), as the library's
    ``mha_reference`` computes it. Returns ``(o [B, H, Lq, hd],
    SoftmaxStats)``, the statistics as the library's forward returns them
    under differentiation.

    ``products="tf32x3"`` takes both matrix products as the kernel takes
    them on the tensor cores (``matmul_tf32x3``), as
    ``flash_attention_bwd_ref`` does; the unnormalized probabilities go into
    ``p @ v`` and the quotient by ``l`` comes after, as in the kernel. For
    tests and ``chip_smoke.py``, on no path of the port; the default is what
    the kernel is held to."""
    if products not in ("f32", "tf32x3"):
        raise ValueError(f'products must be "f32" or "tf32x3", got {products!r}')
    with float32_precision():
        if products == "f32":
            logits = _scores(q, k, segment_ids, sm_scale)
        else:
            logits = _scores(q, k, segment_ids, sm_scale, matmul_tf32x3)
        m = logits.amax(dim=-1, keepdim=True)
        unnormalized = torch.exp(logits - m)
        l = unnormalized.sum(dim=-1, keepdim=True)  # noqa: E741
        stats = SoftmaxStats(l=l[..., 0], m=m[..., 0])
        if products == "f32":
            return (unnormalized / l) @ v, stats
        return matmul_tf32x3(unnormalized, v) / l, stats


def flash_attention_ref(q, k, v, segment_ids: SegmentIds = None, sm_scale=1.0):
    """Plain version: ``flash_attention_fwd_ref``'s output ``[B, H, Lq, hd]``
    f32. A plain differentiable function."""
    return flash_attention_fwd_ref(q, k, v, segment_ids, sm_scale)[0]


def flash_attention_bwd_ref(
    q: torch.Tensor,  # [B, H, Lq, hd] f32
    k: torch.Tensor,  # [B, H, Lk, hd] f32
    v: torch.Tensor,  # [B, H, Lk, hd] f32
    segment_ids: SegmentIds,
    o: torch.Tensor,  # [B, H, Lq, hd] f32, the forward's output
    stats: SoftmaxStats,
    do: torch.Tensor,  # [B, H, Lq, hd] f32, the gradient of o
    sm_scale: float = 1.0,
    products: str = "f32",
):
    """Plain version of the two backward kernels, in the library's
    arithmetic (``_flash_attention_bwd``): the probabilities recomputed from
    the saved statistics, whole matrices in full fp32. Returns
    ``(dq, dk, dv)``.

    ``products="tf32x3"`` takes each of the five matrix products as the
    kernels take it on the tensor cores (``matmul_tf32x3``: operands split
    into TF32 halves, three products, fp32 sums), which bounds what the
    split costs without a card; the default is what the kernels are held
    to."""
    if products not in ("f32", "tf32x3"):
        raise ValueError(f'products must be "f32" or "tf32x3", got {products!r}')
    matmul = torch.matmul if products == "f32" else matmul_tf32x3
    with float32_precision():
        di = (o * do).sum(dim=-1, keepdim=True)
        p = torch.exp(_scores(q, k, segment_ids, sm_scale, matmul) - stats.m[..., None])
        p = p * (1.0 / stats.l[..., None])
        dv = matmul(p.transpose(-1, -2), do)
        dp = matmul(do, v.transpose(-1, -2))
        ds = (dp - di) * p
        if sm_scale != 1.0:
            ds = ds * sm_scale
        dk = matmul(ds.transpose(-1, -2), q)
        dq = matmul(ds, k)
        return dq, dk, dv


def _kernel_inputs(q, k, v, segment_ids):
    """What every kernel launch checks first: 64-wide heads, contiguous
    aligned tensors; the segment ids as contiguous int32 (or None, None)."""
    hd = q.shape[-1]
    if hd != _HEAD_DIM:
        raise NotImplementedError(
            f"head_dim={hd}: the kernel takes heads {_HEAD_DIM} wide, as every "
            "BERT and RoBERTa size has"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if segment_ids is None:
        return None, None
    return (segment_ids.q.to(torch.int32).contiguous(),
            segment_ids.kv.to(torch.int32).contiguous())


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _forward_cuda(q, k, v, segment_ids, sm_scale, with_stats):
    """Launch the forward kernel: ``(o, stats)``, ``stats`` None unless asked
    for."""
    from ircl_tpu_torch.utils.kernel_build import load_kernels

    seg_q, seg_kv = _kernel_inputs(q, k, v, segment_ids)
    B, H, Lq, hd = q.shape
    Lk = k.shape[2]
    kern = load_kernels()
    out = torch.empty_like(q)
    stats = None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if with_stats:
            stats = SoftmaxStats(
                l=torch.empty((B, H, Lq), dtype=torch.float32, device=q.device),
                m=torch.empty((B, H, Lq), dtype=torch.float32, device=q.device),
            )
            rc = kern.lib.ircl_flash_attention_stats(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg_q), _ptr(seg_kv),
                B, H, Lq, Lk, hd, float(sm_scale), out.data_ptr(),
                stats.l.data_ptr(), stats.m.data_ptr(), stream,
            )
        else:
            rc = kern.lib.ircl_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg_q), _ptr(seg_kv),
                B, H, Lq, Lk, hd, float(sm_scale), out.data_ptr(), stream,
            )
    kern.check(rc, "flash-attention launch")
    flash_attention.launches += 1
    return out, stats


def _check_backward_lengths(Lq, Lk):
    if Lq % _BLOCK or Lk % _BLOCK:
        raise NotImplementedError(
            f"q_seq_len={Lq}, kv_seq_len={Lk}: the backward kernels take "
            f"sequence lengths that are multiples of {_BLOCK}"
        )


def _backward_inputs(q, k, v, segment_ids, o, stats, do, di):
    """Device, shape and layout checks shared by the two backward wrappers;
    returns di = sum_d o * do, [B, H, Lq] f32 (computed unless given), and
    the int32 segment ids."""
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention backward kernel for device {q.device}")
    B, H, Lq, _ = q.shape
    _check_backward_lengths(Lq, k.shape[2])
    seg_q, seg_kv = _kernel_inputs(q, k, v, segment_ids)
    for name, t, shape in (("o", o, q.shape), ("do", do, q.shape),
                           ("l", stats.l, (B, H, Lq)), ("m", stats.m, (B, H, Lq))):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be float32 {tuple(shape)}")
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must lie on {q.device}, contiguous and 16-byte aligned")
    if di is None:  # as the library computes it, outside its kernels (:273-275)
        di = (o * do).sum(dim=-1)
    return di, seg_q, seg_kv


def flash_attention_bwd_dkv(q, k, v, segment_ids, o, stats, do, sm_scale=1.0,
                            di=None):
    """``(dk, dv)`` ``[B, H, Lk, hd]`` f32 from CUDA tensors: launches the
    dK/dV kernel of ``csrc/flash_attention_bwd.cu``. ``do`` must be
    contiguous; ``di`` is ``(o * do).sum(-1)`` where the caller has it
    already. Plain version: ``flash_attention_bwd_ref(...)[1:]``."""
    from ircl_tpu_torch.utils.kernel_build import load_kernels

    di, seg_q, seg_kv = _backward_inputs(q, k, v, segment_ids, o, stats, do, di)
    B, H, Lq, hd = q.shape
    kern = load_kernels()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = kern.lib.ircl_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg_q), _ptr(seg_kv),
            stats.l.data_ptr(), stats.m.data_ptr(), do.data_ptr(), di.data_ptr(),
            B, H, Lq, k.shape[2], hd, float(sm_scale), dk.data_ptr(), dv.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kern.check(rc, "flash-attention dK/dV launch")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, segment_ids, o, stats, do, sm_scale=1.0,
                           di=None):
    """``dq`` ``[B, H, Lq, hd]`` f32 from CUDA tensors: launches the dQ
    kernel of ``csrc/flash_attention_bwd.cu``. ``do`` and ``di`` as for
    ``flash_attention_bwd_dkv``. Plain version:
    ``flash_attention_bwd_ref(...)[0]``."""
    from ircl_tpu_torch.utils.kernel_build import load_kernels

    di, seg_q, seg_kv = _backward_inputs(q, k, v, segment_ids, o, stats, do, di)
    B, H, Lq, hd = q.shape
    kern = load_kernels()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = kern.lib.ircl_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg_q), _ptr(seg_kv),
            stats.l.data_ptr(), stats.m.data_ptr(), do.data_ptr(), di.data_ptr(),
            B, H, Lq, k.shape[2], hd, float(sm_scale), dq.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kern.check(rc, "flash-attention dQ launch")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0


def _forward_with_stats(q, k, v, segment_ids, sm_scale):
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, segment_ids, sm_scale)
    return _forward_cuda(q, k, v, segment_ids, sm_scale, with_stats=True)


def flash_attention_fwd(q, k, v, segment_ids: SegmentIds = None, sm_scale=1.0):
    """``(o, SoftmaxStats)`` without autograd: the forward of a
    differentiated call, with what it saves for the backward. CUDA tensors
    launch the kernel's statistics entry, CPU tensors run
    ``flash_attention_fwd_ref``."""
    _check_args(q, k, v, None, segment_ids, False)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    with torch.no_grad():
        return _forward_with_stats(q, k, v, segment_ids, sm_scale)


class _FlashAttention(torch.autograd.Function):
    """The differentiated call: the forward keeps the statistics, the
    backward runs the two backward kernels (CPU tensors: the plain
    versions of both)."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, sm_scale):
        segment_ids = None if seg_q is None else SegmentIds(q=seg_q, kv=seg_kv)
        o, stats = _forward_with_stats(q, k, v, segment_ids, sm_scale)
        ctx.save_for_backward(q, k, v, o, stats.l, stats.m)
        ctx.segment_ids = segment_ids
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors  # noqa: E741
        args = (q, k, v, ctx.segment_ids, o, SoftmaxStats(l=l, m=m))
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_ref(*args, do, ctx.sm_scale)
        else:
            # autograd hands over the transposed view of the head merge
            do = do.contiguous()
            di = (o * do).sum(dim=-1)  # once for both kernels
            dk, dv = flash_attention_bwd_dkv(*args, do, ctx.sm_scale, di)
            dq = flash_attention_bwd_dq(*args, do, ctx.sm_scale, di)
        return dq, dk, dv, None, None, None


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
    ``[B, H, Lq, hd]`` f32, differentiable in q, k and v. CUDA tensors launch
    the kernels of ``csrc/flash_attention.cu`` and, in the backward,
    ``csrc/flash_attention_bwd.cu``; CPU tensors run the plain versions."""
    _check_args(q, k, v, ab, segment_ids, causal)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        if q.device.type == "cuda":  # refuse now what the backward would refuse
            _check_backward_lengths(q.shape[2], k.shape[2])
        seg_q, seg_kv = (None, None) if segment_ids is None else segment_ids
        return _FlashAttention.apply(q, k, v, seg_q, seg_kv, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, segment_ids, sm_scale)
    return _forward_cuda(q, k, v, segment_ids, sm_scale, with_stats=False)[0]


flash_attention.launches = 0
