"""Blockwise ring attention over an axis of a mesh (context parallelism).

Counterpart of ``ircl_tpu/ops/ring_attention.py``: Ring Attention (Liu et
al., 2023) for the encoder's non-causal, pad-masked attention. The sequence
is split over a mesh axis (``"seq"``); each rank keeps its query block and
the key, value and pad-bias blocks travel rank i -> i+1, one hop a step, so
no rank forms the ``[L, L]`` score matrix and attention memory a rank stays
O(L_local^2). An online softmax (running max ``m``, normalizer ``l`` and
accumulator ``acc``, all f32, updated in the reference's order) makes the
result equal ``softmax(Q K_global^T / sqrt(D) + bias_global) V_global`` for
the local rows.

The reference lets ``jax.grad`` derive the backward through ``ppermute``
and ``lax.scan``. Here the backward is a second ring written out: the
forward keeps only its output and each row's log-sum-exp; the backward
recomputes each block's probabilities from them, accumulates ``dq``
locally from ``dS = P * (dP - rowsum(dO * O))``, and the ``dk`` and ``dv``
accumulators travel with their key and value block, so that after ``n``
hops they are back on the rank that owns the block. A block of nothing but
pads (-1e9 bias, the reference's value) takes part as it does in the
reference: its weight vanishes once a real key raises the running max, and
a row with no real key at all averages the pads, as the plain softmax does.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ircl_tpu_torch.parallel.common import shift
from ircl_tpu_torch.parallel.mesh import check_mesh


def _scores(q, k_blk, b_blk, scale):
    """``q k^T * scale + bias`` of one block, in f32 ([B, H, Lq, Lk])."""
    return (q @ k_blk.float().transpose(-1, -2)) * scale + b_blk.float()


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        nxt, prv = (r + 1) % n, (r - 1) % n
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf = q.float()
        m = torch.full(q.shape[:3], -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        blk = [k, v, bias]
        for step in range(n):
            k_blk, v_blk, b_blk = blk
            logits = _scores(qf, k_blk, b_blk, scale)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)  # 0 on the first step (m = -inf)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ v_blk.float()
            m = m_new
            if step < n - 1:  # the last hop would only bring the blocks home
                blk = shift(blk, nxt, prv, group)
        out = (acc / l[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, bias, out, m + torch.log(l))
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, bias, out, lse = ctx.saved_tensors
        group = ctx.group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        nxt, prv = (r + 1) % n, (r - 1) % n
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf, do = q.float(), d_out.float()
        delta = (do * out.float()).sum(dim=-1)  # rowsum(dO * O): [B, H, Lq]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk, b_blk = k, v, bias
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step in range(n):
            p = torch.exp(_scores(qf, k_blk, b_blk, scale) - lse[..., None])
            dv_blk = dv_blk + p.transpose(-1, -2) @ do
            ds = p * (do @ v_blk.float().transpose(-1, -2) - delta[..., None])
            dq = dq + (ds @ k_blk.float()) * scale
            dk_blk = dk_blk + (ds.transpose(-1, -2) @ qf) * scale
            if n == 1:
                break
            if step < n - 1:
                k_blk, v_blk, b_blk, dk_blk, dv_blk = shift(
                    [k_blk, v_blk, b_blk, dk_blk, dv_blk], nxt, prv, group)
            else:  # the n-th hop brings each block's gradients to its owner
                dk_blk, dv_blk = shift([dk_blk, dv_blk], nxt, prv, group)
        return dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype), None, None


def ring_attention(
    q: torch.Tensor,  # [B, H, Lq_local, D]: this rank's query block
    k: torch.Tensor,  # [B, H, Lk_local, D]: this rank's key block
    v: torch.Tensor,  # [B, H, Lk_local, D]: this rank's value block
    bias: torch.Tensor,  # [B, 1, 1, Lk_local]: the additive pad bias of the block
    axis: str,
    *,
    mesh,
) -> torch.Tensor:
    """Global-sequence attention of the local query block over ``mesh``'s
    ``axis``, whose ranks hold the sequence's blocks in rank order. The
    softmax runs in f32; the result has ``q``'s dtype. Differentiable in
    ``q``, ``k`` and ``v`` through the hand-written reverse ring."""
    check_mesh(mesh, axis)
    return _RingAttention.apply(q, k, v, bias, mesh.get_group(axis))
