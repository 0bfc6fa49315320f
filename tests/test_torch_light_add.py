"""light_add_topk_t: the port against the Pallas kernel in interpret mode.

The same numpy inputs (made from a seed) go to
``ircl_tpu.ops.light_add_pallas.light_add_topk_t`` (interpret mode) and to
``ircl_tpu_torch.ops.light_add_cuda.light_add_topk_t`` on CPU tensors, where
the wrapper runs its plain version. Scores within rtol 1e-6 (the pools are
added in the same order, so in practice they are equal); ids equal except
across exact ties (both follow the largest-row rule, so in practice equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_topk_match, one_torch_thread  # noqa: F401
from ircl_tpu.ops import light_add_pallas as lp
from ircl_tpu_torch.ops import light_add_cuda as lc


def _inputs(seed, n_pad, B, P):
    """Scores with many exact ties (small integers, half zeros) and
    doc-ascending pools whose tail is padded with ``n_pad``, as the ranker
    pads them."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 6, size=(n_pad, B)).astype(np.float32)
    h *= rng.random((n_pad, B)) < 0.5
    docs = np.sort(rng.integers(0, n_pad, size=(P, B)), axis=0).astype(np.int32)
    fill = rng.integers(P // 2, P + 1, size=B)
    docs = np.where(np.arange(P)[:, None] < fill[None, :], docs, n_pad)
    contribs = np.where(
        docs < n_pad, rng.integers(1, 4, size=(P, B)) * 0.5, 0.0
    ).astype(np.float32)
    return h, docs.astype(np.int32), contribs


def _both(h, docs, contribs, k, d_tile, b_tile=8):
    js, ji = lp.light_add_topk_t(
        jnp.asarray(h), jnp.asarray(docs), jnp.asarray(contribs),
        k=k, b_tile=b_tile, d_tile=d_tile, interpret=True,
    )
    ts, ti = lc.light_add_topk_t(
        torch.from_numpy(h), torch.from_numpy(docs), torch.from_numpy(contribs),
        k=k, b_tile=b_tile, d_tile=d_tile,
    )
    return np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy()


@pytest.mark.parametrize(
    "k,d_tile", [(5, 256), (8, 256), (10, 512), (3, 1024)]
)
def test_matches_pallas(k, d_tile):
    h, docs, contribs = _inputs(k, n_pad=1024, B=16, P=48)
    js, ji, ts, ti = _both(h, docs, contribs, k, d_tile)
    assert ts.dtype == np.float32 and ti.dtype == np.int32
    k8 = -(-k // 8) * 8
    assert ts.shape == ti.shape == (1024 // d_tile * k8, 16)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)
    # per-tile lists are columns here: compare them as rows
    n_dt = 1024 // d_tile
    for t in range(n_dt):
        rows = slice(t * k8, t * k8 + k)
        assert_topk_match(ts[rows].T, ti[rows].T, js[rows].T, ji[rows].T, rtol=1e-6)
    np.testing.assert_array_equal(ti, ji)  # same tie rule: largest row
    pad = np.arange(n_dt * k8) % k8 >= k
    assert (ts[pad] == np.float32(-3.4e38)).all() and (ti[pad] == -1).all()


def test_light_add_is_exact_against_numpy():
    """Totals equal H + the pool sums, and ``h_t`` itself is left alone."""
    h, docs, contribs = _inputs(7, n_pad=512, B=8, P=32)
    h_t = torch.from_numpy(h.copy())
    s, i = lc.light_add_topk_t(
        h_t, torch.from_numpy(docs), torch.from_numpy(contribs), k=4, d_tile=256
    )
    np.testing.assert_array_equal(h_t.numpy(), h)
    total = h.astype(np.float64)
    for p in range(docs.shape[0]):
        for b in range(docs.shape[1]):
            if docs[p, b] < 512:
                total[docs[p, b], b] += contribs[p, b]
    s, i = s.numpy(), i.numpy()
    live = i >= 0
    np.testing.assert_allclose(
        s[live], total[i[live], np.nonzero(live)[1]], rtol=1e-6
    )


def test_empty_pools_and_k_equal_to_tile():
    h, docs, contribs = _inputs(3, n_pad=64, B=8, P=16)
    docs[:] = 64  # pools hold pads only
    contribs[:] = 0.0
    js, ji, ts, ti = _both(h, docs, contribs, k=32, d_tile=32)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize(
    "case", ["k_over_tile", "k_zero", "tile_not_dividing", "tile_not_8",
             "docs_int64", "h_f64", "cols_mismatch", "meta_device"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    h = torch.zeros((512, 8))
    docs = torch.zeros((4, 8), dtype=torch.int32)
    con = torch.zeros((4, 8))
    k, d_tile = 5, 256
    if case == "k_over_tile":
        k = 257
    elif case == "k_zero":
        k = 0
    elif case == "tile_not_dividing":
        d_tile = 384
    elif case == "tile_not_8":
        d_tile = 4
        h = torch.zeros((12, 8))
    elif case == "docs_int64":
        docs = docs.long()
    elif case == "h_f64":
        h = h.double()
    elif case == "cols_mismatch":
        docs, con = docs[:, :4].contiguous(), con[:, :4].contiguous()
    elif case == "meta_device":  # neither CPU nor CUDA: no kernel, no fallback
        h, docs, con = h.to("meta"), docs.to("meta"), con.to("meta")
    before = lc.light_add_topk_t.launches
    with pytest.raises((ValueError, TypeError)):
        lc.light_add_topk_t(h, docs, con, k=k, d_tile=d_tile)
    assert lc.light_add_topk_t.launches == before


def _row_group_emulation(h, docs, contribs, k, d_tile, groups=8, list_len=8):
    """The CUDA kernel's algorithm for k <= 8 in plain numpy: each d-tile's
    rows split into ``groups`` equal groups; a group's rows walked from the
    last to the first, each total the score plus its pool run added in pool
    order (f32), kept in a best-``list_len`` list where a later (smaller)
    row enters only on a strictly larger score; then the groups' lists
    merged in any order by (score, then the larger row) and the first k
    emitted, then the pads."""
    n_pad, B = h.shape
    n_dt, k8 = n_pad // d_tile, -(-k // 8) * 8
    rows = d_tile // groups
    out_s = np.full((n_dt * k8, B), np.float32(-3.4e38), np.float32)
    out_i = np.full((n_dt * k8, B), -1, np.int32)
    beats = lambda a, b: a[0] > b[0] or (a[0] == b[0] and a[1] > b[1])  # noqa: E731
    for b in range(B):
        col = docs[:, b]
        for t in range(n_dt):
            merged = []
            for g in range(groups):
                lo = t * d_tile + g * rows
                top = []
                for d in range(lo + rows - 1, lo - 1, -1):
                    x = np.float32(h[d, b])
                    for p in np.nonzero(col == d)[0]:  # pool order
                        x = np.float32(x + contribs[p, b])
                    j = len(top)
                    while j > 0 and x > top[j - 1][0]:
                        j -= 1
                    top.insert(j, (x, d))
                    del top[list_len:]
                merged.extend(top)
            best = []
            for e in merged[::-1]:  # any order gives the same list
                j = len(best)
                while j > 0 and beats(e, best[j - 1]):
                    j -= 1
                best.insert(j, e)
                del best[list_len:]
            for r, (x, d) in enumerate(best[:k]):
                out_s[t * k8 + r, b], out_i[t * k8 + r, b] = x, d
    return out_s, out_i


@pytest.mark.parametrize("case,k,d_tile", [
    ("ties", 1, 256), ("ties", 5, 256), ("ties", 8, 512), ("ties", 5, 1024),
    ("straddle", 5, 256), ("one tile", 5, 256), ("empty pools", 8, 512),
])
def test_row_group_split_and_merge_match_pallas(case, k, d_tile):
    """The kernel's split of a tile into 8 row groups and the merge of their
    lists keep the Pallas outputs bit for bit, ties included: inputs with
    many exact ties (``_inputs``), runs of equal scores across the groups'
    borders, a column whose whole pool falls in one d-tile, empty pools."""
    h, docs, contribs = _inputs(11 + k, n_pad=1024, B=8, P=24)
    if case == "straddle":  # equal scores on both sides of each border
        h[:] = 0.0
        border = np.arange(d_tile // 8, 1024, d_tile // 8)
        for off in (-2, -1, 0, 1):
            h[border + off, :] = 3.0
    elif case == "one tile":
        docs[:, 0] = np.sort(np.random.default_rng(5).integers(256, 512, size=24))
        contribs[:, 0] = 0.5
    elif case == "empty pools":
        docs[:] = 1024
        contribs[:] = 0.0
    js, ji, _, _ = _both(h, docs, contribs, k, d_tile)
    es, ei = _row_group_emulation(h, docs, contribs, k, d_tile)
    np.testing.assert_array_equal(es, js)
    np.testing.assert_array_equal(ei, ji)
