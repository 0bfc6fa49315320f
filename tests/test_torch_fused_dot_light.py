"""The fused dot + light add kernel's plain version against the composition
that ``scripts/probe_fused_dot_light.py`` holds its kernel to.

The probe's Pallas kernel is a closure inside its ``main()`` and cannot be
imported, so the reference here is what the probe itself compares with: the
hi/lo bf16 split, three ``dot_general``s with fp32 accumulation, then
``ircl_tpu.ops.light_add_pallas.light_add_topk_t`` in interpret mode. Every
product of two bf16 values is exact in fp32, so the two sides differ only in
the order of the fp32 sums: per-tile scores rtol 1e-5, rows equal except
across ties. Against the exact fp32 fused engine the bound is the probe's
own (rtol 2e-5, atol 1e-5: the dropped lo.lo term). On CPU tensors the
wrapper runs the plain version; the CUDA kernel is held to it on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.ops.light_add_pallas import light_add_topk_t as j_light_add
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.ops import hybrid as t_hy
from ircl_tpu_torch.ops.fused_dot_light_cuda import (
    fused_dot_light_topk,
    fused_dot_light_topk_ref,
    split_hi_lo,
)

HASH_SIZE = 2**20


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16).numpy()


@pytest.fixture(scope="module")
def slabs():
    """The fused engine's operands on a 150-doc corpus: the slab m, the query
    slab wt (128 columns), the doc-sorted pools, and the host inputs."""
    wiki = generate(num_docs=150, num_claims=50, seed=13)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=HASH_SIZE))
    ranker = TfidfRanker(index, "cpu", mode="hybrid", df_threshold=8, width_buckets=2)
    buckets, weights = ranker._vectorize([c.claim for c in wiki.claims])
    host = [_t(x) for x in ranker.hybrid_host_inputs(buckets, weights)]
    u, qb, qw, ld, lc = host
    m, u_tile = t_hy._bucketed_membership(u, *ranker._heavy_a, *ranker._heavy_b, 1024)
    wt = t_hy._query_slab(u, qb, qw, u_tile, True)[:, :128].contiguous()
    pad = torch.nn.functional.pad
    B = ld.shape[0]
    sd_t = pad(ld, (0, 0, 0, 128 - B)).T.contiguous()
    sv_t = pad(lc, (0, 0, 0, 128 - B)).T.contiguous()
    return ranker, host, m, wt, sd_t, sv_t, B


def test_split_hi_lo_matches_the_reference_split():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 96)) * 10.0 ** rng.uniform(-3, 3, size=(64, 96))).astype(
        np.float32)
    hi, lo = split_hi_lo(_t(x))
    j_hi = jnp.asarray(x).astype(jnp.bfloat16)
    j_lo = (jnp.asarray(x) - j_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(hi), np.asarray(j_hi).view(np.int16))
    np.testing.assert_array_equal(_bits(lo), np.asarray(j_lo).view(np.int16))
    # hi + lo keeps x to 2^-16 relative
    back = hi.to(torch.float32) + lo.to(torch.float32)
    np.testing.assert_allclose(back.numpy(), x, rtol=2.0**-16, atol=0)


@pytest.mark.parametrize("d_tile", [256, 1024])
def test_plain_version_matches_the_probes_reference(slabs, d_tile):
    ranker, host, m, wt, sd_t, sv_t, B = slabs
    mh, ml = split_hi_lo(m)
    wh, wl = split_hi_lo(wt)
    s, i = fused_dot_light_topk(mh, ml, wh, wl, sd_t, sv_t, k=5, d_tile=d_tile)

    @jax.jit
    def reference(m, wt, sd_t, sv_t):
        def hilo(x):
            hi = x.astype(jnp.bfloat16)
            return hi, (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)

        dot = functools.partial(
            jax.lax.dot_general, dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        (jmh, jml), (jwh, jwl) = hilo(m), hilo(wt)
        h_t = dot(jmh, jwh) + dot(jml, jwh) + dot(jmh, jwl)
        return j_light_add(h_t, sd_t, sv_t, k=5, b_tile=128, d_tile=d_tile,
                           interpret=True)

    js, ji = reference(*(jnp.asarray(x.numpy()) for x in (m, wt, sd_t, sv_t)))
    js, ji = np.asarray(js), np.asarray(ji)
    assert s.shape == js.shape and i.dtype == torch.int32
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-5, atol=0)
    differ = i.numpy() != ji  # equal scores: only another doc of a tie
    assert (s.numpy()[differ] == js[differ]).all()
    k8 = 8
    pad = (np.arange(s.shape[0]) % k8) >= 5
    assert (i.numpy()[pad] == -1).all() and (s.numpy()[pad] == np.float32(-3.4e38)).all()


def test_fused_dot_light_within_the_probes_bound_of_the_fused_engine(slabs):
    """Final top-5 of the per-tile winners against ``hybrid_topk_bucketed_fused``
    (exact fp32 scores) at the probe's bound."""
    ranker, host, m, wt, sd_t, sv_t, B = slabs
    mh, ml = split_hi_lo(m)
    wh, wl = split_hi_lo(wt)
    tile_s, tile_i = fused_dot_light_topk(mh, ml, wh, wl, sd_t, sv_t, k=5, d_tile=1024)
    top_s, top_pos = torch.topk(tile_s.T[:B], 5, dim=1)
    top_i = torch.gather(tile_i.T[:B], 1, top_pos)
    rs, ri = t_hy.hybrid_topk_bucketed_fused(
        *ranker._heavy_a, *ranker._heavy_b, *host, k=5, queries_sorted=True,
        pools_sorted=True, d_tile=1024,
    )
    live = ri.numpy() >= 0
    s, i = top_s.numpy(), top_i.numpy()
    np.testing.assert_allclose(s[live], rs.numpy()[live], rtol=2e-5, atol=1e-5)
    assert (s[~live] <= 1e-5).all()
    bad = (i != ri.numpy()) & live & ~np.isclose(s, rs.numpy(), rtol=2e-5, atol=1e-5)
    assert not bad.any()
    # the split is not a no-op here: lo halves carry part of the scores
    assert float(ml.to(torch.float32).abs().max()) > 0


def test_plain_version_sums_in_the_probes_order():
    """(hh + lh) + hl on a case where the grouping changes the last bit."""
    rng = np.random.default_rng(4)
    m = rng.normal(size=(64, 256)).astype(np.float32)
    w = rng.normal(size=(64, 128)).astype(np.float32)
    mh, ml = split_hi_lo(_t(m))
    wh, wl = split_hi_lo(_t(w))
    docs = torch.full((8, 128), 256, dtype=torch.int32)
    contribs = torch.zeros((8, 128))
    s, i = fused_dot_light_topk_ref(mh, ml, wh, wl, docs, contribs, k=5, d_tile=256)
    f = lambda x: x.to(torch.float32)  # noqa: E731
    h_t = (f(mh).T @ f(wh) + f(ml).T @ f(wh)) + f(mh).T @ f(wl)
    want, _ = torch.topk(h_t, 5, dim=0)
    np.testing.assert_array_equal(s[:5].numpy(), want.numpy())
    # within 2^-15 of the exact fp32 product: only lo.lo is dropped
    exact, _ = torch.topk(_t(m).T.double() @ _t(w).double(), 5, dim=0)
    np.testing.assert_allclose(s[:5].numpy(), exact.numpy(), rtol=1e-4, atol=1e-4)


def test_arguments_are_checked():
    bf = torch.bfloat16
    m = torch.zeros((64, 256), dtype=bf)
    w = torch.zeros((64, 128), dtype=bf)
    d = torch.zeros((8, 128), dtype=torch.int32)
    c = torch.zeros((8, 128))
    with pytest.raises(TypeError, match="dtypes"):
        fused_dot_light_topk(m.float(), m, w, w, d, c)
    with pytest.raises(ValueError, match="m_hi and m_lo"):
        fused_dot_light_topk(m, m[:, :128].contiguous(), w, w, d, c, d_tile=256)
    with pytest.raises(ValueError, match="w_hi and w_lo"):
        fused_dot_light_topk(m, m, w[:32].contiguous(), w[:32].contiguous(), d, c,
                             d_tile=256)
    with pytest.raises(ValueError, match="d_tile"):
        fused_dot_light_topk(m, m, w, w, d, c, d_tile=1024)
    with pytest.raises(ValueError, match="k must be"):
        fused_dot_light_topk(m, m, w, w, d, c, k=0, d_tile=256)
    s, i = fused_dot_light_topk(m, m, w, w, d, c, k=5, d_tile=256)
    assert s.shape == (8, 128) and fused_dot_light_topk.launches == 0
