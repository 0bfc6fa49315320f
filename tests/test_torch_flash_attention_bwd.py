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
``Function`` in float64 at a tiny shape. The CUDA kernels take their
products on the tensor cores, each f32 operand split into two TF32 values
(``utils/precision.py::split_tf32``); ``flash_attention_bwd_ref(...,
products="tf32x3")`` is that arithmetic in plain PyTorch and is held to the
same 1e-5 here, so the split is bounded without a card. The kernels
themselves are held to both plain versions on the card by ``chip_smoke.py``
phase 13.
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
from ircl_tpu_torch.utils.precision import matmul_tf32x3, split_tf32

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


def _q_kv(seg):
    """A pair (q ids, kv ids), or one array for both."""
    return seg if isinstance(seg, tuple) else (seg, seg)


def _lib_seg(seg):
    if seg is None:
        return None
    q, kv = _q_kv(seg)
    return lib.SegmentIds(q=jnp.asarray(q), kv=jnp.asarray(kv))


def _library_grads(q, k, v, do, seg, sm_scale=SM_SCALE):
    def loss(q, k, v):
        o = lib.flash_attention(q, k, v, segment_ids=_lib_seg(seg), causal=False,
                                sm_scale=sm_scale)
        return jnp.sum(o * jnp.asarray(do))

    with force_tpu_interpret_mode():
        return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _seg_t(seg):
    if seg is None:
        return None
    q, kv = _q_kv(seg)
    return fa.SegmentIds(torch.from_numpy(q), torch.from_numpy(kv))


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


SHAPES = [
    (128, 64, "pads_at_end"), (128, 64, "no_pads"), (128, 64, "one_real"),
    (256, 64, "pads_at_end"), (256, 64, "one_real"), (128, 16, "pads_at_end"),
    (128, 64, None),
]


@pytest.mark.parametrize("L,hd,mask", SHAPES)
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


def _plain_backward(q, k, v, do, seg, products, sm_scale=SM_SCALE):
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, stats = fa.flash_attention_fwd_ref(*t, _seg_t(seg), sm_scale)
    return [g.numpy() for g in fa.flash_attention_bwd_ref(
        *t, _seg_t(seg), o, stats, torch.from_numpy(do), sm_scale, products=products)]


@pytest.mark.parametrize("L,hd,mask", SHAPES)
def test_split_tf32_products_match_jax_grad_through_the_library_kernels(L, hd, mask):
    """The kernels' arithmetic (five products as three TF32 products each)
    against the library, at the scale the transformer passes,
    ``1 / sqrt(hd)``, within the bound that full fp32 holds. hi + lo keeps 23
    of x's 24 bits, so a split product's terms are each a few 2^-23 off
    where an FMA's are exact: some three times the distance of the fp32
    plain version from the library (measured here: up to 1.2e-5 against
    4e-6 at this file's sharper ``SM_SCALE``, which the next test bounds)."""
    q, k, v, do, seg = _inputs(L, hd, mask)
    want = _library_grads(q, k, v, do, seg, sm_scale=hd ** -0.5)
    got = _plain_backward(q, k, v, do, seg, "tf32x3", sm_scale=hd ** -0.5)
    exact = _plain_backward(q, k, v, do, seg, "f32", sm_scale=hd ** -0.5)
    for name, g, e, w in zip(("dq", "dk", "dv"), got, exact, want):
        assert g.dtype == np.float32 and g.shape == w.shape, name
        assert np.abs(w).max() > 1e-2, name
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)
        assert not np.array_equal(g, e), name  # another arithmetic, not a no-op


@pytest.mark.parametrize("L,hd,mask", [s for s in SHAPES if s[1] == 64])
def test_split_tf32_products_where_the_softmax_is_sharper(L, hd, mask):
    """At ``SM_SCALE`` 0.25 on 64-wide heads (scores twice the model's) a key
    that many queries attend to sums their errors: the split stays within
    twice the fp32 bound of the library."""
    q, k, v, do, seg = _inputs(L, hd, mask)
    want = _library_grads(q, k, v, do, seg)
    got = _plain_backward(q, k, v, do, seg, "tf32x3")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * ATOL, err_msg=name)


def test_split_tf32_products_at_the_training_length():
    """L=512, hd=64, against the full-fp32 plain version only: the library
    kernels in interpret mode are too slow at this length."""
    q, k, v, do, seg = _inputs(512, 64, "pads_at_end")
    got = _plain_backward(q, k, v, do, seg, "tf32x3")
    want = _plain_backward(q, k, v, do, seg, "f32")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert np.abs(w).max() > 1e-2, name
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)


def test_products_argument_is_checked():
    x = torch.zeros(1, 1, 8, 4)
    stats = fa.SoftmaxStats(l=torch.ones(1, 1, 8), m=torch.zeros(1, 1, 8))
    with pytest.raises(ValueError, match="products"):
        fa.flash_attention_bwd_ref(x, x, x, None, x, stats, x, products="bf16")


def _other_key_ids(L):
    """Query ids and key ids that differ: the keys' real part ends earlier,
    query (0, 5) carries an id no key has (it attends to every key, 1 / L
    each), and the last 32 keys of row 1 carry an id no query has."""
    seg_q = _segments("pads_at_end", 2, L)
    seg_kv = seg_q.copy()
    seg_kv[0, 40:] = 0
    seg_q[0, 5] = 7
    seg_kv[1, 90:96] = 0  # row 1's pad queries keep pad keys
    seg_kv[1, -32:] = 9
    return seg_q, seg_kv


@pytest.mark.parametrize("products", ["f32", "tf32x3"])
def test_key_ids_that_differ_and_a_query_with_no_key(products):
    q, k, v, do, _ = _inputs(128, 64, None, seed=21)
    seg = _other_key_ids(128)
    want = _library_grads(q, k, v, do, seg)
    if products == "f32":  # through the Function, as a train step reaches it
        got = _port_grads(_function, q, k, v, do, seg)
    else:
        got = _plain_backward(q, k, v, do, seg, products)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)
    dq, dk, dv = got
    assert np.abs(dq[0, :, 5]).max() > 1e-4  # the query with no key still learns
    assert not dk[1, :, -32:].any() and not dv[1, :, -32:].any()  # keys with no query
    _, stats = fa.flash_attention_fwd_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), _seg_t(seg), SM_SCALE)
    no_key = stats.m.numpy() < 0.5 * fa.DEFAULT_MASK_VALUE
    assert no_key[0, :, 5].all() and no_key.sum() == 2  # one row, both heads


def test_split_tf32_rounds_as_cvt_rna():
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.normal(size=20000) * 10.0 ** rng.integers(
        -20, 20, size=20000)).astype(np.float32))
    hi, lo = split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32
    for part in (hi, lo):  # 13 zero low mantissa bits
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -21
    assert float(((hi - x).abs() / x.abs()).max()) <= 2.0 ** -11
    # nearest, ties away from zero: 1 + 2^-11 lies halfway between two values
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11])
    np.testing.assert_array_equal(
        split_tf32(tie)[0].numpy(),
        np.float32([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2.0 ** -9]))


def test_split_tf32_keeps_zeros_denormals_and_infinities():
    inf = float("inf")
    tiny = 2.0 ** -136  # a denormal with no bit under the 13th
    x = torch.tensor([0.0, -0.0, inf, -inf, tiny, -3 * tiny, 2.0 ** -140, 3e-39])
    hi, lo = split_tf32(x)
    total = hi + lo
    assert torch.equal(total[:6], x[:6]) and torch.equal(hi[:6], x[:6])
    assert np.signbit(hi.numpy()[1]) and not lo[2:4].any()
    # below the 13th bit a denormal rounds to a multiple of 2^-136: not flushed
    assert float(total[7]) != 0.0
    assert float((total[6:] - x[6:]).abs().max()) <= 2.0 ** -137


def test_matmul_tf32x3_is_close_to_fp32_where_one_product_is_not():
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    one_pass = split_tf32(a)[0] @ split_tf32(b)[0]
    assert float((matmul_tf32x3(a, b) - exact).abs().max()) < 2e-5
    assert float((one_pass - exact).abs().max()) > 1e-3


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
