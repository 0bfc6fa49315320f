"""Membership slab: the port against the Pallas kernels run in interpret mode.

The same numpy inputs go to ``ircl_tpu.ops.membership_pallas`` (interpret
mode, as the JAX package's own CPU tests run it) and to
``ircl_tpu_torch.ops.membership_cuda`` on CPU tensors, where the wrappers
run the plain version. Slabs must agree bit for bit (each cell sums the
same terms in the same order); the top-k's scores within rtol 1e-5, because
the GEMM sums in another order, and its ids except across exact ties.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_topk_match, one_torch_thread  # noqa: F401
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.ops import hybrid as j_hy
from ircl_tpu.ops import membership_pallas as mp
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.ell import to_ell
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.ops import hybrid as t_hy
from ircl_tpu_torch.ops import membership_cuda as mc

HASH_SIZE = 2**20


@pytest.fixture(scope="module")
def inputs():
    """ELL doc side (k-major, rows ascending, pads trailing), a batch's
    sorted union and its query side (pads: bucket 0, weight 0)."""
    wiki = generate(num_docs=100, num_claims=24, seed=3)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=HASH_SIZE))
    claims = [c.claim for c in wiki.claims]
    ranker = TfidfRanker(index, "cpu", mode="ell")
    buckets, weights = ranker._vectorize(claims)
    u_pad = ranker._union_slots(buckets, weights, floor=512)
    ell = to_ell(index)
    tt, vt = mc.pad_for_slab(
        np.ascontiguousarray(ell.terms.T),
        np.ascontiguousarray(ell.vals.T),
        d_tile=512,
    )
    qb, qw = mc.pad_for_slab(
        np.ascontiguousarray(buckets.T), np.ascontiguousarray(weights.T),
        d_tile=128,
    )
    assert (qb[qw == 0] == 0).any(), "the query side must carry bucket-0 pads"
    return dict(u=u_pad, tt=tt, vt=vt, qb=qb, qw=qw, num_docs=index.num_docs)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax_slab(windowed, u, terms, vals, u_tile, d_tile):
    fn = mp.membership_slab_windowed if windowed else mp.membership_slab
    return np.asarray(fn(
        jnp.asarray(u), jnp.asarray(terms), jnp.asarray(vals),
        u_tile=u_tile, d_tile=d_tile, interpret=True,
    ))


@pytest.mark.parametrize("windowed", [False, True], ids=["plain", "windowed"])
@pytest.mark.parametrize("u_tile,d_tile", [(128, 256), (256, 512), (512, 128)])
def test_doc_slab_matches_pallas(inputs, windowed, u_tile, d_tile):
    want = _jax_slab(
        windowed, inputs["u"], inputs["tt"], inputs["vt"], u_tile, d_tile
    )
    fn = mc.membership_slab_windowed if windowed else mc.membership_slab
    got = fn(
        _t(inputs["u"]), _t(inputs["tt"]), _t(inputs["vt"]),
        u_tile=u_tile, d_tile=d_tile,
    )
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.count_nonzero(want) > 100


@pytest.mark.parametrize("u_tile", [128, 512])
def test_query_slab_with_bucket0_pads_matches_pallas(inputs, u_tile):
    want = _jax_slab(False, inputs["u"], inputs["qb"], inputs["qw"], u_tile, 128)
    got = mc.membership_slab(_t(inputs["u"]), _t(inputs["qb"]), _t(inputs["qw"]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_bucket_colliding_with_real_slot_zero_accumulates():
    """Bucket 0 may be a real union slot; a query's pads (bucket 0, weight 0)
    must add nothing to it, and a real weight on bucket 0 must survive."""
    sentinel = HASH_SIZE
    u = np.full(128, sentinel, np.int32)
    u[:4] = [0, 5, 9, 77]
    qb = np.zeros((8, 128), np.int32)  # every slot a bucket-0 pad...
    qw = np.zeros((8, 128), np.float32)
    qb[0, 0], qw[0, 0] = 0, 1.5  # ...except a real bucket 0 in query 0
    qb[1, 0], qw[1, 0] = 9, 2.0
    qb[0, 3], qw[0, 3] = 77, 0.25  # a real term after a pad
    want = _jax_slab(False, u, qb, qw, 128, 128)
    got = mc.membership_slab(_t(u), _t(qb), _t(qw)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 1.5 and got[2, 0] == 2.0 and got[3, 3] == 0.25
    assert np.count_nonzero(got) == 3


def test_membership_topk_fused_matches_pallas(inputs):
    k = 7
    js, ji = mp.membership_topk_fused(
        jnp.asarray(inputs["tt"]), jnp.asarray(inputs["vt"]),
        jnp.asarray(inputs["u"]), jnp.asarray(inputs["qb"]),
        jnp.asarray(inputs["qw"]), k=k, num_real_docs=inputs["num_docs"],
        interpret=True,
    )
    js, ji = np.asarray(js), np.asarray(ji)
    ts, ti = mc.membership_topk_fused(
        _t(inputs["tt"]), _t(inputs["vt"]), _t(inputs["u"]),
        _t(inputs["qb"]), _t(inputs["qw"]), k=k,
        num_real_docs=inputs["num_docs"],
    )
    ts, ti = ts.numpy(), ti.numpy()
    assert ti.dtype == np.int32
    assert_topk_match(ts, ti, js, ji)
    assert (ti[:24] >= 0).all() and (ti[24:] == -1).all()


def test_slab_shapes_need_no_tile_padding():
    """The CUDA contract drops the Pallas tiling asserts: any U, N, K."""
    u = np.array([1, 4, 6], np.int32)
    terms = np.array([[4, -1, 1], [6, 1, -1]], np.int32)  # [K=2, N=3]
    vals = np.array([[1.0, 0.0, 3.0], [2.0, 5.0, 0.0]], np.float32)
    got = mc.membership_slab(_t(u), _t(terms), _t(vals)).numpy()
    np.testing.assert_array_equal(
        got, [[0, 5, 3], [1, 0, 0], [2, 0, 0]]
    )


def test_cpu_calls_do_not_count_launches(inputs):
    before = (mc.membership_slab.launches, mc.membership_slab_windowed.launches)
    mc.membership_slab(_t(inputs["u"]), _t(inputs["qb"]), _t(inputs["qw"]))
    mc.membership_slab_windowed(_t(inputs["u"]), _t(inputs["tt"]), _t(inputs["vt"]))
    assert before == (
        mc.membership_slab.launches, mc.membership_slab_windowed.launches
    )


@pytest.fixture(scope="module")
def buckets():
    """Two width buckets of a hybrid ranker (rows ascending, pads trailing,
    tile-padded as the ranker pads them) and a batch's union."""
    wiki = generate(num_docs=150, num_claims=40, seed=13)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=HASH_SIZE))
    ranker = TfidfRanker(index, "cpu", mode="hybrid", df_threshold=4,
                         width_buckets=2, d_tile=256)
    b, w = ranker._vectorize([c.claim for c in wiki.claims])
    u = ranker.hybrid_host_inputs(b, w)[0]
    heavy = [x.numpy() for x in (*ranker._heavy_a, *ranker._heavy_b)]
    assert heavy[0].shape[0] != heavy[2].shape[0]  # two widths
    return u, heavy


def test_bucketed_membership_fills_one_buffer(buckets):
    """``_bucketed_membership`` writes both buckets into one [U, Na + Nb]
    buffer: equal to the reference's (Pallas in interpret mode, then a
    concatenation) and to ``torch.cat`` of the two plain slabs, bit for bit."""
    u, heavy = buckets
    want, want_tile = j_hy._bucketed_membership(
        jnp.asarray(u), *(jnp.asarray(x) for x in heavy), 256, True)
    got, u_tile = t_hy._bucketed_membership(_t(u), *(_t(x) for x in heavy), 256)
    assert u_tile == want_tile
    assert got.shape == (len(u), heavy[0].shape[1] + heavy[2].shape[1])
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cat = torch.cat([mc.membership_slab_ref(_t(u), _t(heavy[0]), _t(heavy[1])),
                     mc.membership_slab_ref(_t(u), _t(heavy[2]), _t(heavy[3]))], dim=1)
    assert torch.equal(got, cat)
    assert np.count_nonzero(want) > 100


@pytest.mark.parametrize("windowed", [False, True], ids=["plain", "windowed"])
def test_out_and_col_offset_are_honoured(inputs, windowed):
    """The windowed wrapper's plain path writes the slab into ``out``'s
    columns [col_offset, col_offset + N), returns that view and leaves the
    other columns alone; ``membership_slab`` keeps the reference's arguments
    (no ``out``) and returns the same slab on its own."""
    u, tt, vt = _t(inputs["u"]), _t(inputs["tt"]), _t(inputs["vt"])
    n = tt.shape[1]
    out = torch.full((u.shape[0], n + 12), 7.0)
    want = mc.membership_slab_ref(u, tt, vt)
    if not windowed:
        with pytest.raises(TypeError):
            mc.membership_slab(u, tt, vt, out=out, col_offset=5)
        assert (out == 7.0).all()
        mc.membership_slab_windowed(u, tt, vt, out=out, col_offset=5)
        assert torch.equal(mc.membership_slab(u, tt, vt), out[:, 5 : 5 + n])
        return
    got = mc.membership_slab_windowed(u, tt, vt, out=out, col_offset=5)
    assert got.data_ptr() == out[:, 5:].data_ptr() and got.shape == want.shape
    assert torch.equal(got, want) and torch.equal(out[:, 5 : 5 + n], want)
    assert (out[:, :5] == 7.0).all() and (out[:, 5 + n :] == 7.0).all()
    assert torch.equal(
        mc.membership_slab_windowed(u, tt, vt, out=torch.empty(u.shape[0], n)), want)


@pytest.mark.parametrize(
    "case,exc",
    [
        ("terms_int64", TypeError),
        ("vals_f64", TypeError),
        ("shape_mismatch", ValueError),
        ("u_2d", ValueError),
        ("not_contiguous", ValueError),
        ("meta_device", ValueError),
        ("out_rows", ValueError),
        ("out_1d", ValueError),
        ("out_f64", TypeError),
        ("out_meta_device", ValueError),
        ("out_not_contiguous", ValueError),
        ("col_offset_past_out", ValueError),
        ("col_offset_negative", ValueError),
        ("col_offset_without_out", ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc):
    u = torch.tensor([1, 2, 3], dtype=torch.int32)
    terms = torch.tensor([[1, 2], [3, -1]], dtype=torch.int32)
    vals = torch.ones((2, 2), dtype=torch.float32)
    kw = {}
    if case == "out_rows":
        kw = dict(out=torch.zeros((2, 4)))
    elif case == "out_1d":
        kw = dict(out=torch.zeros(12))
    elif case == "out_f64":
        kw = dict(out=torch.zeros((3, 4), dtype=torch.float64))
    elif case == "out_meta_device":
        kw = dict(out=torch.zeros((3, 4), device="meta"))
    elif case == "out_not_contiguous":
        kw = dict(out=torch.zeros((4, 3)).T)
    elif case == "col_offset_past_out":
        kw = dict(out=torch.zeros((3, 4)), col_offset=3)
    elif case == "col_offset_negative":
        kw = dict(out=torch.zeros((3, 4)), col_offset=-1)
    elif case == "col_offset_without_out":
        kw = dict(col_offset=2)
    if case == "terms_int64":
        terms = terms.long()
    elif case == "vals_f64":
        vals = vals.double()
    elif case == "shape_mismatch":
        vals = torch.ones((2, 3))
    elif case == "u_2d":
        u = u[None]
    elif case == "not_contiguous":
        terms, vals = terms.T, vals.T
    elif case == "meta_device":  # neither CPU nor CUDA: no kernel, no fallback
        u, terms, vals = (x.to("meta") for x in (u, terms, vals))
    # out= and col_offset= are the windowed wrapper's alone
    for fn in ((mc.membership_slab_windowed,) if kw else
               (mc.membership_slab, mc.membership_slab_windowed)):
        with pytest.raises(exc):
            fn(u, terms, vals, **kw)


def test_kernel_geometry_is_checked():
    """What the CUDA kernel cannot take raises before a launch; the plain
    version takes any U, N and K."""
    terms = torch.zeros((2, 5), dtype=torch.int32)
    mc._check_slab_geometry(torch.zeros(64 * 65535, dtype=torch.int32), terms)
    with pytest.raises(ValueError, match="union"):
        mc._check_slab_geometry(
            torch.empty(64 * 65535 + 1, dtype=torch.int32, device="meta"), terms)
    with pytest.raises(ValueError, match="grid"):
        mc._check_slab_geometry(torch.zeros(4, dtype=torch.int32),
                                torch.empty((1, 128 * 2**31), dtype=torch.int32,
                                            device="meta"))


def test_scores_matmul_restores_precision():
    prev = torch.get_float32_matmul_precision()
    a, b = torch.ones(3, 4), torch.ones(4, 2)
    for tf32 in (False, True):
        np.testing.assert_array_equal(
            mc.scores_matmul(a, b, tf32=tf32).numpy(), np.full((3, 2), 4.0)
        )
        assert torch.get_float32_matmul_precision() == prev
    assert math.isclose(float(mc.scores_matmul(a, b).sum()), 24.0)
