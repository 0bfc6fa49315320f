"""The one-pass fused hybrid engine: ``ircl_tpu_torch.ops.fused_hybrid_cuda``
against ``ircl_tpu.ops.fused_hybrid_pallas`` in interpret mode, and against
the port's staged and ragged engines.

Same numpy inputs into both packages; on CPU tensors the port's wrapper runs
its plain version (the CUDA kernel is held to that plain version on the
card). Per-tile scores within rtol 1e-5 (the slab product sums in another
order), positions equal except across exact ties; pad rows equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_topk_match, one_torch_thread  # noqa: F401
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.ops import fused_hybrid_pallas as j_fh
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.ops import fused_hybrid_cuda as t_fh
from ircl_tpu_torch.ops import hybrid as t_hy

HASH_SIZE = 2**20
NEG = np.float32(-3.4e38)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def setup():
    wiki = generate(num_docs=150, num_claims=50, seed=13)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=HASH_SIZE))
    return index, [c.claim for c in wiki.claims]


def _inputs(index, claims, threshold, **kw):
    ranker = TfidfRanker(index, "cpu", mode="hybrid", df_threshold=threshold,
                         width_buckets=2, **kw)
    buckets, weights = ranker._vectorize(claims)
    heavy = [x.numpy() for x in (*ranker._heavy_a, *ranker._heavy_b)]
    return ranker, heavy, ranker.hybrid_host_inputs(buckets, weights)


def _tile_inputs(ranker, heavy, host, b_pad=128):
    """(u, wt [U, b_pad], pools [P, b_pad]) as ``hybrid_topk_onepass`` makes
    them, in numpy."""
    u, qb, qw, ld, lc = host
    wt = t_hy._query_slab(_t(u), _t(qb), _t(qw), 128, True).numpy()[:, :b_pad]
    B = ld.shape[0]
    sd = np.pad(ld, ((0, b_pad - B), (0, 0)), constant_values=2**31 - 1)
    sv = np.pad(lc, ((0, b_pad - B), (0, 0)))
    return u, np.ascontiguousarray(wt), np.ascontiguousarray(sd.T), np.ascontiguousarray(sv.T)


def _assert_tiles_match(got, want, k):
    (s, i), (js, ji) = got, want
    s, i, js, ji = (np.asarray(x) for x in (s, i, js, ji))
    assert s.shape == js.shape and i.shape == ji.shape and i.dtype == np.int32
    k8 = -(-k // 8) * 8
    pad = (np.arange(s.shape[0]) % k8) >= k
    assert (s[pad] == NEG).all() and (i[pad] == -1).all()
    np.testing.assert_array_equal(js[pad], s[pad])
    np.testing.assert_array_equal(ji[pad], i[pad])
    np.testing.assert_allclose(s[~pad], js[~pad], rtol=1e-5, atol=0)
    # positions may differ only where scores tie (to rounding) inside a tile
    differ = (i != ji) & ~pad[:, None]
    for r, c in zip(*np.nonzero(differ)):
        t0 = r // k8 * k8
        near = np.isclose(js[t0 : t0 + k, c], js[r, c], rtol=1e-5, atol=0).sum()
        assert near > 1, (r, c)


@pytest.mark.parametrize("threshold", [4, 16])
def test_tile_topk_matches_jax(setup, threshold):
    """Both buckets' per-tile outputs; bucket b starts at ``base = na``."""
    index, claims = setup
    ranker, heavy, host = _inputs(index, claims, threshold)
    u, wt, sd_t, sv_t = _tile_inputs(ranker, heavy, host)
    na = heavy[0].shape[1]
    for terms, vals, base in ((heavy[0], heavy[1], 0), (heavy[2], heavy[3], na)):
        kw = dict(k=5, u_tile=512, d_tile=256, b_tile=128, base=base)
        want = j_fh.fused_hybrid_tile_topk(
            *(jnp.asarray(x) for x in (terms, vals, u, wt, sd_t, sv_t)),
            interpret=True, **kw,
        )
        got = t_fh.fused_hybrid_tile_topk(
            *(_t(x) for x in (terms, vals, u, wt, sd_t, sv_t)), **kw
        )
        _assert_tiles_match(got, want, 5)
        live = np.asarray(got[1])
        live = live[live >= 0]
        assert live.min() >= base and live.max() < base + terms.shape[1]


@pytest.mark.parametrize("threshold", [4, 16])
def test_onepass_matches_jax_and_the_ports_engines(setup, threshold):
    """Mirror of ``tests/test_hybrid.py::test_onepass_matches_staged``: the
    one-pass engine against the reference's in interpret mode, and against
    the port's staged, fused and ragged engines."""
    index, claims = setup
    ranker, heavy, host = _inputs(index, claims, threshold)
    kw = dict(k=5, d_tile=256, b_tile=128)
    js, ji = j_fh.hybrid_topk_onepass(
        *(jnp.asarray(x) for x in heavy), *(jnp.asarray(x) for x in host),
        interpret=True, **kw,
    )
    args = (*(_t(x) for x in heavy), *(_t(x) for x in host))
    s, i = t_fh.hybrid_topk_onepass(*args, **kw)
    assert s.shape == (len(claims), 5) and i.dtype == torch.int32
    assert_topk_match(s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji))
    assert (i.numpy()[:, 0] >= 0).all()

    ekw = dict(k=5, queries_sorted=True, pools_sorted=True, d_tile=256)
    for engine in (t_hy.hybrid_topk_bucketed, t_hy.hybrid_topk_bucketed_fused):
        es, ei = engine(*args, **ekw)
        assert_topk_match(s.numpy(), i.numpy(), es.numpy(), ei.numpy())

    pos2old = ranker._bucketed.pos2old
    ids = np.where(i.numpy() >= 0, pos2old[np.maximum(i.numpy(), 0)], -1)
    ref = TfidfRanker(index, "cpu", mode="ragged").closest_docs_batch(claims, k=5)
    doc2idx = index.doc2idx
    for b, (ids_r, sc_r) in enumerate(ref):
        keep = ids[b] >= 0
        np.testing.assert_allclose(
            np.sort(s.numpy()[b][keep]), np.sort(sc_r), rtol=1e-5, atol=1e-6
        )
        cut = float(np.min(sc_r)) * (1 + 1e-4) + 1e-4
        got = {int(d) for d, v in zip(ids[b][keep], s.numpy()[b][keep]) if v > cut}
        assert got == {doc2idx[d] for d, v in zip(ids_r, sc_r) if v > cut}


def test_onepass_pads_a_narrow_union_and_a_ragged_batch(setup):
    """``fixed_union_cap=64`` gives a union narrower than ``u_tile``: the
    reference pads it with copies of its last value over zero rows of the
    query slab, the port (whose kernel has no u-tiles) takes it as it is, and
    both return the same top-k; 37 queries pad to the batch tile with 2^31-1
    pools."""
    index, claims = setup
    ranker, heavy, host = _inputs(index, claims[:37], 16, fixed_union_cap=64,
                                  fixed_max_terms=24)
    assert host[0].shape[0] % 512
    kw = dict(k=5, d_tile=256, b_tile=128)
    js, ji = j_fh.hybrid_topk_onepass(
        *(jnp.asarray(x) for x in heavy), *(jnp.asarray(x) for x in host),
        interpret=True, **kw,
    )
    s, i = t_fh.hybrid_topk_onepass(
        *(_t(x) for x in heavy), *(_t(x) for x in host), **kw
    )
    assert s.shape == (37, 5)
    assert_topk_match(s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji))


def test_union_whose_last_value_is_repeated_by_padding(setup):
    """A union with no sentinel slack, padded with copies of its last REAL
    value over zero rows of wt: a term equal to that value must read the
    first (real) slot, and the copies add nothing. Equal to the
    sentinel-padded union's outputs, and to the reference's."""
    index, claims = setup
    ranker, heavy, host = _inputs(index, claims, 4)
    u, wt, sd_t, sv_t = _tile_inputs(ranker, heavy, host)
    n_real = int((u < HASH_SIZE).sum())
    assert 0 < n_real < len(u)
    u_rep = u.copy()
    u_rep[n_real:] = u[n_real - 1]  # copies of the last real value
    assert (wt[n_real:] == 0).all() and (wt[n_real - 1] != 0).any()
    last = int(u[n_real - 1])
    assert ((heavy[0] == last).sum() + (heavy[2] == last).sum()) > 0
    for terms, vals in ((heavy[0], heavy[1]), (heavy[2], heavy[3])):
        kw = dict(k=5, u_tile=512, d_tile=256, b_tile=128)
        rest = (_t(wt), _t(sd_t), _t(sv_t))
        plain = t_fh.fused_hybrid_tile_topk(_t(terms), _t(vals), _t(u), *rest, **kw)
        rep = t_fh.fused_hybrid_tile_topk(_t(terms), _t(vals), _t(u_rep), *rest, **kw)
        np.testing.assert_array_equal(rep[0].numpy(), plain[0].numpy())
        np.testing.assert_array_equal(rep[1].numpy(), plain[1].numpy())
        want = j_fh.fused_hybrid_tile_topk(
            *(jnp.asarray(x) for x in (terms, vals, u_rep, wt, sd_t, sv_t)),
            interpret=True, **kw,
        )
        _assert_tiles_match(rep, want, 5)


def test_ties_go_to_the_largest_row_at_a_tile_edge():
    """Every doc scores the same: each tile returns its LAST k rows, in
    descending order, positions offset by ``base``; a pool entry lifts one
    doc at a tile's first row above the rest. Equal to the reference."""
    n, k, d_tile, base = 512, 5, 256, 1024
    terms = np.full((8, n), -1, np.int32)
    vals = np.zeros((8, n), np.float32)
    terms[0], vals[0] = 7, 1.5
    u = np.array([3, 7] + [HASH_SIZE] * 126, np.int32)
    wt = np.zeros((128, 128), np.float32)
    wt[1] = 2.0
    docs_t = np.full((8, 128), 2**31 - 1, np.int32)
    contribs_t = np.zeros((8, 128), np.float32)
    docs_t[0, 0], contribs_t[0, 0] = base + 256, 0.25  # first row of tile 1
    docs_t[0, 1], contribs_t[0, 1] = base - 1, 9.0  # the other bucket's doc
    args = (terms, vals, u, wt, docs_t, contribs_t)
    kw = dict(k=k, u_tile=128, d_tile=d_tile, b_tile=128, base=base)
    s, i = t_fh.fused_hybrid_tile_topk(*(_t(x) for x in args), **kw)
    js, ji = j_fh.fused_hybrid_tile_topk(
        *(jnp.asarray(x) for x in args), interpret=True, **kw
    )
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    i = i.numpy()
    assert i[:k, 5].tolist() == [base + 255 - r for r in range(k)]
    assert i[8 : 8 + k, 5].tolist() == [base + 511 - r for r in range(k)]
    assert i[8 : 8 + k, 0].tolist() == [base + 256] + [base + 511 - r for r in range(k - 1)]
    assert s.numpy()[8, 0] == np.float32(3.25) and s.numpy()[0, 1] == np.float32(3.0)


def test_arguments_are_checked():
    z = torch.zeros((8, 256), dtype=torch.int32)
    v = torch.zeros((8, 256))
    u = torch.zeros(128, dtype=torch.int32)
    wt = torch.zeros((128, 128))
    d = torch.zeros((8, 128), dtype=torch.int32)
    c = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="d_tile"):
        t_fh.fused_hybrid_tile_topk(z, v, u, wt, d, c, d_tile=100)
    with pytest.raises(TypeError, match="dtypes"):
        t_fh.fused_hybrid_tile_topk(z, v, u, wt.double(), d, c, d_tile=256)
    with pytest.raises(ValueError, match="B_pad"):
        t_fh.fused_hybrid_tile_topk(z, v, u, wt, d[:, :64].contiguous(),
                                    c[:, :64].contiguous(), d_tile=256)
    with pytest.raises(ValueError, match="unknown precision"):
        t_fh.fused_hybrid_tile_topk(z, v, u, wt, d, c, d_tile=256, precision="bf16")
    with pytest.raises(ValueError, match="k must be"):
        t_fh.fused_hybrid_tile_topk(z, v, u, wt, d, c, d_tile=256, k=0)
    assert t_fh.fused_hybrid_tile_topk.launches == 0  # CPU tensors launch nothing

    # what the CUDA kernel cannot take (the plain version takes it all)
    geo = t_fh._check_kernel_geometry
    geo(z, u, wt, 256, 0)  # the shapes above fit
    with pytest.raises(ValueError, match="d_tile % 32"):
        geo(torch.zeros((8, 240), dtype=torch.int32), u, wt, 48, 0)
    wide = torch.zeros((500, 256), dtype=torch.int32)
    assert t_fh._kernel_shared_bytes(500, 128) > 227 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        geo(wide, u, wt, 256, 0)
    # bench_scale.py's buckets fit: ELL widths 64 and 80 at U=512
    assert t_fh._kernel_shared_bytes(80, 512) < 227 * 1024 // 4
    with pytest.raises(ValueError, match="16 bytes"):
        geo(z, u, torch.zeros((128, 130)), 256, 0)
    with pytest.raises(ValueError, match="16 bytes"):  # wt 4 bytes off alignment
        geo(z, u, torch.zeros(128 * 128 + 1)[1:].view(128, 128), 256, 0)
    with pytest.raises(ValueError, match="grid"):
        geo(torch.empty((8, 32 * 65536), dtype=torch.int32, device="meta"), u, wt, 32, 0)
    with pytest.raises(ValueError, match="overflow int32"):
        geo(z, u, wt, 256, 2**31 - 100)
