"""The port's flash attention against JAX's library kernel.

``jax.experimental.pallas.ops.tpu.flash_attention`` runs here in the TPU
interpret mode (``force_tpu_interpret_mode``); the same seeded q, k, v and
segment ids go through it and through ``flash_attention_ref`` and the CPU
path of ``flash_attention`` (which is the plain version). Tolerance: 1e-5
absolute on every output row, pad rows included (fp32 on both sides, sums in
another order). The CUDA kernel is held to the plain version on the card by
``chip_smoke.py`` phase 10. Validation errors must match the library's word
for word. The library runs under ``jax.jit``: dispatched op by op, the
interpret mode's callbacks can wait behind ops queued after the kernel.
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
lib_flash_attention = jax.jit(lib.flash_attention, static_argnames=("causal", "sm_scale"))


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


def _library(q, k, v, seg, **kw):
    segment_ids = None if seg is None else lib.SegmentIds(
        q=jnp.asarray(seg), kv=jnp.asarray(seg))
    with force_tpu_interpret_mode():
        return np.asarray(lib_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            segment_ids=segment_ids, **kw))


@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("mask", ["pads_at_end", "no_pads", "one_real"])
def test_plain_version_matches_the_library_kernel(L, hd, mask):
    rng = np.random.default_rng(L + hd)
    q, k, v = (rng.normal(size=(2, 2, L, hd)).astype(np.float32) for _ in range(3))
    seg = _segments(mask, 2, L)
    want = _library(q, k, v, seg, causal=False, sm_scale=SM_SCALE)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    seg_t = fa.SegmentIds(q=torch.from_numpy(seg), kv=torch.from_numpy(seg))
    ref = fa.flash_attention_ref(*t, seg_t, SM_SCALE).numpy()
    before = fa.flash_attention.launches
    got = fa.flash_attention(*t, segment_ids=seg_t, causal=False,
                             sm_scale=SM_SCALE).numpy()
    assert fa.flash_attention.launches == before  # CPU tensors launch nothing
    assert got.shape == want.shape == (2, 2, L, hd) and got.dtype == np.float32
    np.testing.assert_allclose(ref, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("mask", ["pads_at_end", "no_pads", "one_real"])
@pytest.mark.parametrize("sm_scale", [64 ** -0.5, SM_SCALE])
def test_split_tf32_forward_matches_the_library_kernel(L, mask, sm_scale):
    """The kernel's arithmetic (both products as three TF32 products each,
    ``products="tf32x3"``) against the library on 64-wide heads, at the
    scale the transformer passes, ``1 / sqrt(hd)``, and at this file's
    sharper ``SM_SCALE``. hi + lo keeps 23 of x's 24 bits, so the split is
    further from the library than full fp32 (measured here: up to 1.1e-6 at
    the model's scale and 2.9e-6 at 0.25, against 2.1e-6 for fp32), and
    stays within the same ``ATOL``; the statistics as well (l relative)."""
    rng = np.random.default_rng(L + 64)
    q, k, v = (rng.normal(size=(2, 2, L, 64)).astype(np.float32) for _ in range(3))
    seg = _segments(mask, 2, L)
    want = _library(q, k, v, seg, causal=False, sm_scale=sm_scale)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    seg_t = fa.SegmentIds(q=torch.from_numpy(seg), kv=torch.from_numpy(seg))
    got, stats = fa.flash_attention_fwd_ref(*t, seg_t, sm_scale, products="tf32x3")
    exact, exact_stats = fa.flash_attention_fwd_ref(*t, seg_t, sm_scale)
    assert got.dtype == torch.float32 and got.shape == (2, 2, L, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert not torch.equal(got, exact)  # another arithmetic, not a no-op
    np.testing.assert_allclose(stats.m.numpy(), exact_stats.m.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(stats.l.numpy(), exact_stats.l.numpy(), rtol=ATOL, atol=0)


def test_forward_products_argument_is_checked():
    x = torch.zeros(1, 1, 128, 64)
    with pytest.raises(ValueError, match="products"):
        fa.flash_attention_fwd_ref(x, x, x, products="tf32")


def test_no_segment_ids_matches_the_library_kernel():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(1, 3, 128, 32)).astype(np.float32) for _ in range(3))
    want = _library(q, k, v, None)
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_pad_rows_attend_to_the_pads_only():
    """Segment 0 rows average the pad values, real rows the real ones: the
    library's semantics, which the "xla" path does not share."""
    L = 128
    seg = torch.ones(1, L, dtype=torch.int32)
    seg[0, 100:] = 0
    q = torch.zeros(1, 1, L, 8)
    k = torch.zeros(1, 1, L, 8)
    v = torch.zeros(1, 1, L, 8)
    v[0, 0, 100:] = 2.0
    v[0, 0, :100] = -1.0
    out = fa.flash_attention(q, k, v, segment_ids=fa.SegmentIds(seg, seg))
    torch.testing.assert_close(out[0, 0, :100], torch.full((100, 8), -1.0))
    torch.testing.assert_close(out[0, 0, 100:], torch.full((28, 8), 2.0))


@pytest.mark.parametrize("Lq,Lk", [(64, 64), (200, 200), (96, 256), (128, 200)])
def test_block_errors_match_the_library(Lq, Lk):
    q = np.zeros((1, 1, Lq, 16), np.float32)
    k = np.zeros((1, 1, Lk, 16), np.float32)
    with pytest.raises(ValueError) as want:
        _library(q, k, k, None)
    with pytest.raises(ValueError) as got:
        fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("which", ["batch", "heads", "model", "kv_len", "seg_q"])
def test_shape_errors_match_the_library(which):
    shapes = {"q": (2, 2, 128, 16), "k": (2, 2, 128, 16), "v": (2, 2, 128, 16)}
    seg_shape = (2, 128)
    if which == "batch":
        shapes["k"] = (1, 2, 128, 16)
    elif which == "heads":
        shapes["v"] = (2, 1, 128, 16)
    elif which == "model":
        shapes["k"] = (2, 2, 128, 32)
    elif which == "kv_len":
        shapes["v"] = (2, 2, 256, 16)
    else:
        seg_shape = (2, 256)
    arrays = {n: np.zeros(s, np.float32) for n, s in shapes.items()}
    seg = np.ones(seg_shape, np.int32)
    with pytest.raises(ValueError) as want:
        with force_tpu_interpret_mode():
            lib_flash_attention(
                *(jnp.asarray(arrays[n]) for n in "qkv"),
                segment_ids=lib.SegmentIds(q=jnp.asarray(seg),
                                           kv=jnp.ones((2, 128), jnp.int32)))
    with pytest.raises(ValueError) as got:
        fa.flash_attention(
            *(torch.from_numpy(arrays[n]) for n in "qkv"),
            segment_ids=fa.SegmentIds(torch.from_numpy(seg),
                                      torch.ones(2, 128, dtype=torch.int32)))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["causal", "ab", "bf16", "f16"])
def test_what_the_served_path_never_passes_is_refused(case):
    x = torch.zeros(1, 1, 128, 16)
    if case == "causal":
        with pytest.raises(NotImplementedError, match="causal"):
            fa.flash_attention(x, x, x, causal=True)
    elif case == "ab":
        with pytest.raises(NotImplementedError, match="bias"):
            fa.flash_attention(x, x, x, ab=torch.zeros(1, 1, 128, 128))
    elif case == "bf16":
        with pytest.raises(NotImplementedError, match="f32 q, k and v"):
            fa.flash_attention(*(x.to(torch.bfloat16),) * 3)
    else:
        with pytest.raises(TypeError, match="float32"):
            fa.flash_attention(*(x.half(),) * 3)


def test_other_devices_are_refused():
    x = torch.zeros(1, 1, 128, 16, device="meta")
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="lie on"):
        fa.flash_attention(torch.zeros(1, 1, 128, 16), x, x)


def test_mask_value_is_the_library_constant():
    assert fa.DEFAULT_MASK_VALUE == lib.DEFAULT_MASK_VALUE
