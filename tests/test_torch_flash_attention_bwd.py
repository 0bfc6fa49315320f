"""The port's flash-attention backward against ``jax.grad`` through JAX's
library kernels.

The library's ``custom_vjp`` (its dK/dV and dQ Pallas kernels) runs here in
the TPU interpret mode under ``jax.jit``; the same seeded q, k, v, segment
ids and output gradient go through it, through the port's
``torch.autograd.Function`` (on CPU tensors: the plain versions of the
forward with statistics and of both backward kernels) and through
``flash_attention_bwd_ref`` directly. Tolerance: 1e-5 absolute on dq, dk
and dv, pad rows included (fp32 on both sides, sums in another order). The
output gradient is dense and random: the kernels must be right for any
``do``, though the verdict model's is zero on pad rows. The softmax
statistics l and m are held to what the library's forward returns under
``save_residuals``. Two more witnesses of the plain backward: autograd
through ``flash_attention_ref``, and ``torch.autograd.gradcheck`` of the
``Function`` in float64 at a tiny shape. The CUDA kernels are held to the
plain versions on the card by ``chip_smoke.py`` phase 13.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as lib
from jax.experimental.pallas.tpu import force_tpu_interpret_mode

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu_torch.ops import flash_attention_cuda as fa

ATOL = 1e-5
SM_SCALE = 0.25


def _segments(kind, B, L):
    """[B, L] int32 ids: 1 on real tokens, 0 on pads at the end."""
    seg = np.ones((B, L), np.int32)
    if kind == "pads_at_end":
        seg[0, 70:] = 0
        seg[1, L - 3:] = 0
    elif kind == "one_real":
        seg[0, 1:] = 0  # a row with one real token
        seg[1, L // 2:] = 0
    return seg


def _inputs(L, hd, mask, seed=None):
    rng = np.random.default_rng(L + hd if seed is None else seed)
    q, k, v, do = (rng.normal(size=(2, 2, L, hd)).astype(np.float32) for _ in range(4))
    return q, k, v, do, (None if mask is None else _segments(mask, 2, L))


def _lib_seg(seg):
    return None if seg is None else lib.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))


def _library_grads(q, k, v, do, seg):
    def loss(q, k, v):
        o = lib.flash_attention(q, k, v, segment_ids=_lib_seg(seg), causal=False,
                                sm_scale=SM_SCALE)
        return jnp.sum(o * jnp.asarray(do))

    with force_tpu_interpret_mode():
        return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _seg_t(seg):
    return None if seg is None else fa.SegmentIds(torch.from_numpy(seg),
                                                  torch.from_numpy(seg))


def _port_grads(fn, q, k, v, do, seg):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, _seg_t(seg))
    # as the head merge hands it over: a transposed, non-contiguous view
    grad = torch.from_numpy(do).transpose(1, 2).contiguous().transpose(1, 2)
    assert not grad.is_contiguous()
    out.backward(grad)
    return [t.grad.numpy() for t in leaves]


def _function(q, k, v, seg):
    return fa.flash_attention(q, k, v, segment_ids=seg, causal=False, sm_scale=SM_SCALE)


@pytest.mark.parametrize("L,hd,mask", [
    (128, 64, "pads_at_end"), (128, 64, "no_pads"), (128, 64, "one_real"),
    (256, 64, "pads_at_end"), (256, 64, "one_real"), (128, 16, "pads_at_end"),
    (128, 64, None),
])
def test_backward_matches_jax_grad_through_the_library_kernels(L, hd, mask):
    q, k, v, do, seg = _inputs(L, hd, mask)
    want = _library_grads(q, k, v, do, seg)
    counts = (fa.flash_attention.launches, fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    got = _port_grads(_function, q, k, v, do, seg)
    assert counts == (fa.flash_attention.launches, fa.flash_attention_bwd_dkv.launches,
                      fa.flash_attention_bwd_dq.launches)  # CPU tensors launch nothing
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, stats = fa.flash_attention_fwd_ref(*t, _seg_t(seg), SM_SCALE)
    direct = fa.flash_attention_bwd_ref(*t, _seg_t(seg), o, stats,
                                        torch.from_numpy(do), SM_SCALE)
    for name, g, d, w in zip(("dq", "dk", "dv"), got, direct, want):
        assert g.shape == w.shape and g.dtype == np.float32, name
        assert np.abs(w).max() > 1e-2, name  # a gradient worth comparing
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)
        np.testing.assert_array_equal(d.numpy(), g, err_msg=name)


@pytest.mark.parametrize("L,mask", [(128, "one_real"), (256, "pads_at_end")])
def test_statistics_match_the_library_residuals(L, mask):
    q, k, v, _, seg = _inputs(L, 64, mask)
    bs = lib.BlockSizes.get_default(2, 2, L, L, 64)
    fwd = jax.jit(lambda q, k, v: lib._flash_attention_impl(
        q, k, v, None, _lib_seg(seg), True, False, SM_SCALE, bs.block_b, bs.block_q,
        bs.block_k_major, bs.block_k, False))
    with force_tpu_interpret_mode():
        o, l, m = (np.asarray(x) for x in fwd(*(jnp.asarray(x) for x in (q, k, v))))
    got_o, stats = fa.flash_attention_fwd_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), _seg_t(seg), SM_SCALE)
    assert tuple(stats.l.shape) == tuple(stats.m.shape) == l.shape == (2, 2, L)
    np.testing.assert_allclose(got_o.numpy(), o, rtol=0, atol=ATOL)
    np.testing.assert_allclose(stats.m.numpy(), m, rtol=0, atol=ATOL)
    np.testing.assert_allclose(stats.l.numpy(), l, rtol=1e-5, atol=ATOL)
    assert (stats.l.numpy() >= 1.0).all()  # the largest score contributes exp(0)


@pytest.mark.parametrize("mask", ["pads_at_end", "one_real", None])
def test_backward_matches_autograd_through_the_plain_forward(mask):
    """Second witness: the ``Function``'s backward (the library's
    arithmetic) against autograd's own derivative of ``flash_attention_ref``."""
    q, k, v, do, seg = _inputs(128, 32, mask, seed=9)
    got = _port_grads(_function, q, k, v, do, seg)
    want = _port_grads(lambda q, k, v, s: fa.flash_attention_ref(q, k, v, s, SM_SCALE),
                       q, k, v, do, seg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_gradcheck_of_the_function_in_float64():
    rng = np.random.default_rng(4)
    leaves = [torch.from_numpy(rng.normal(size=(1, 2, 6, 4))).requires_grad_()
              for _ in range(3)]
    seg = torch.tensor([[1, 1, 1, 1, 0, 0]], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa._FlashAttention.apply(q, k, v, seg, seg, 0.5), leaves)
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa._FlashAttention.apply(q, k, v, None, None, 1.0), leaves)


def test_masked_keys_get_no_gradient_from_real_rows():
    """With ``do`` zero on pad rows (the verdict model's case) the pad keys
    and values get exactly zero: every masked p is exactly 0."""
    q, k, v, do, seg = _inputs(128, 16, "pads_at_end", seed=2)
    do = do * seg[:, None, :, None].astype(np.float32)
    dq, dk, dv = _port_grads(_function, q, k, v, do, seg)
    pads = seg == 0
    for g in (dq, dk, dv):
        assert not g.transpose(0, 2, 1, 3)[pads].any()
    assert np.abs(dk.transpose(0, 2, 1, 3)[~pads]).max() > 1e-3


def test_forward_without_grad_stays_the_served_path():
    q, k, v, _, seg = _inputs(128, 16, "pads_at_end")
    t = [torch.from_numpy(x) for x in (q, k, v)]
    served = fa.flash_attention(*t, segment_ids=_seg_t(seg), sm_scale=SM_SCALE)
    leaves = [x.clone().requires_grad_() for x in t]
    trained = fa.flash_attention(*leaves, segment_ids=_seg_t(seg), sm_scale=SM_SCALE)
    assert not served.requires_grad and trained.requires_grad
    assert torch.equal(served, trained.detach())
    with torch.no_grad():
        assert not fa.flash_attention(*leaves, segment_ids=_seg_t(seg)).requires_grad


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_backward_kernel_wrappers_take_cuda_tensors_only(device):
    """The kernel wrappers never run a plain version: other tensors raise."""
    x = torch.zeros(1, 1, 128, 64, device=device)
    stats = fa.SoftmaxStats(l=x[..., 0], m=x[..., 0])
    for wrapper in (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq):
        with pytest.raises(ValueError, match="no flash-attention backward kernel"):
            wrapper(x, x, x, None, x, stats, x)
        assert wrapper.launches == 0
