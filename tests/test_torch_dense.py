"""The port's dense top-k against ``ircl_tpu``'s on the same seeded inputs.

``dense/scorer.py`` and ``ops/dense_topk_cuda.py`` (kernel #4's plain
version on CPU tensors) against ``ircl_tpu.dense.scorer`` and
``ircl_tpu.ops.dense_topk_pallas`` run as ``tests/test_dense.py`` runs them
(the Pallas kernel in interpret mode). Tolerances: scores rtol 1e-6 where
both sides are the same fp32 sums in another order; ids equal except across
exact ties. Chunk maxima agree within 1e-6 absolute on unit cosines (fp32
summation order), and exactly against the Pallas kernel's own products.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _torch_parity import assert_topk_match, one_torch_thread  # noqa: F401
from ircl_tpu.dense import scorer as j_sc
from ircl_tpu.ops import dense_topk_pallas as j_fused
from ircl_tpu_torch.dense import scorer as t_sc
from ircl_tpu_torch.ops import dense_topk_cuda as t_fused
from ircl_tpu_torch.utils.precision import split_hi_lo


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    Q = _norm(rng.normal(size=(16, 32))).astype(np.float32)
    C = _norm(rng.normal(size=(200, 32))).astype(np.float32)
    return Q, C


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _match(got, want, rtol=1e-6):
    assert_topk_match(got[0].numpy(), got[1].numpy(), *map(np.asarray, want), rtol=rtol)


@pytest.mark.parametrize("k,block", [(7, 0), (5, 50), (5, 64), (5, 199), (3, 500)])
def test_cosine_topk_matches_jax(data, k, block):
    """Flat, blocked, and blocked with a ragged tail (64 and 199 do not
    divide 200: the last block re-reads and masks rows already seen)."""
    Q, C = data
    want = j_sc.cosine_topk(jnp.asarray(Q), jnp.asarray(C), k=k, block=block)
    got = t_sc.cosine_topk(_t(Q), _t(C), k=k, block=block)
    assert got[1].dtype == torch.int32
    _match(got, want)
    ref = Q @ C.T
    np.testing.assert_allclose(
        got[0].numpy(), np.sort(ref, axis=1)[:, ::-1][:, :k], rtol=1e-5
    )


@pytest.mark.parametrize("chunk", [25, 64, 128])
def test_cosine_topk_twophase_matches_jax(data, chunk):
    """chunk 64 and 128 do not divide M=200: the -inf column pad."""
    Q, C = data
    want = j_sc.cosine_topk_twophase(jnp.asarray(Q), jnp.asarray(C), k=5, chunk=chunk)
    _match(t_sc.cosine_topk_twophase(_t(Q), _t(C), k=5, chunk=chunk), want)


def test_cosine_topk_twophase_clustered_matches_jax():
    """All true top-k packed into one chunk, near-ties at the k-th value."""
    rng = np.random.default_rng(3)
    M, D, chunk = 512, 16, 64
    C = rng.normal(size=(M, D)).astype(np.float32) * 0.01
    q = _norm(rng.normal(size=(1, D))).astype(np.float32)
    for j in range(5):
        C[3 * chunk + 10 + j] = q[0] * (1.0 - 1e-4 * j)
    C = _norm(C).astype(np.float32)
    want = j_sc.cosine_topk_twophase(jnp.asarray(q), jnp.asarray(C), k=5, chunk=chunk)
    got = t_sc.cosine_topk_twophase(_t(q), _t(C), k=5, chunk=chunk)
    _match(got, want)
    assert set(got[1][0].tolist()) == set(range(3 * chunk + 10, 3 * chunk + 15))


@pytest.mark.parametrize("extra", [0, 3])
def test_cosine_topk_scan_matches_jax(data, extra):
    Q, C = data
    want = j_sc.cosine_topk_scan(
        jnp.asarray(Q), jnp.asarray(C), k=5, chunk=10, block=50, extra_chunks=extra
    )
    got = t_sc.cosine_topk_scan(_t(Q), _t(C), k=5, chunk=10, block=50,
                                extra_chunks=extra)
    _match(got, want)


def test_small_corpus_k_exceeds_chunks_matches_jax():
    rng = np.random.default_rng(9)
    Q = _norm(rng.normal(size=(4, 16))).astype(np.float32)
    C = _norm(rng.normal(size=(200, 16))).astype(np.float32)
    _match(t_sc.cosine_topk_twophase(_t(Q), _t(C), k=5),
           j_sc.cosine_topk_twophase(jnp.asarray(Q), jnp.asarray(C), k=5))
    _match(t_sc.cosine_topk_scan(_t(Q), _t(C), k=5, chunk=50, block=100),
           j_sc.cosine_topk_scan(jnp.asarray(Q), jnp.asarray(C), k=5, chunk=50,
                                 block=100))


def test_scorer_argument_errors_match_jax(data):
    Q, C = data
    with pytest.raises(KeyError):
        j_sc.cosine_topk_twophase(jnp.asarray(Q), jnp.asarray(C), k=5, precision="x")
    with pytest.raises(KeyError):
        t_sc.cosine_topk_twophase(_t(Q), _t(C), k=5, precision="x")
    with pytest.raises(AssertionError):  # the reference asserts
        j_sc.cosine_topk_scan(jnp.asarray(Q), jnp.asarray(C), k=5, block=64)
    with pytest.raises(ValueError, match="multiple of block"):
        t_sc.cosine_topk_scan(_t(Q), _t(C), k=5, block=64)


@pytest.fixture(scope="module")
def sharded():
    """13 docs whose cosines with query 0 are all strongly negative, on 8
    ranks (3 zero pad rows, which must not outrank them): the port's three
    sharded functions in one launch of an 8-rank gloo group
    (``tests/_torch_ranks.py``), the reference's on its 8-device mesh."""
    from _torch_ranks import dense_functions
    from ircl_tpu.parallel.mesh import make_mesh
    from ircl_tpu_torch.parallel.launch import launch

    rng = np.random.default_rng(4)
    q = _norm(rng.normal(size=(6, 16))).astype(np.float32)
    c = _norm(-q[:1] + 0.01 * rng.normal(size=(13, 16))).astype(np.float32)
    mesh = make_mesh(("corpus",))
    shard, m = j_sc.shard_corpus(c, mesh)
    want = dict(
        shard_corpus=(np.asarray(shard), m),
        make_sharded_topk=j_sc.make_sharded_topk(mesh, 5, true_m=m)(jnp.asarray(q), shard),
        sharded_cosine_topk=j_sc.sharded_cosine_topk(q, c, k=5, mesh=mesh),
    )
    return q, c, want, launch(dense_functions, 8, q, c, 5, device="cpu")


@pytest.mark.parametrize(
    "fn,nargs", [("shard_corpus", 2), ("make_sharded_topk", 2),
                 ("sharded_cosine_topk", 4)]
)
def test_sharded_scorer_waits_for_item_12(sharded, fn, nargs):
    """Once a raise naming ROADMAP.md queue 1 item 12, now each sharded
    function (``nargs`` positional arguments) against the reference's: the
    ranks' row blocks, the merged top-k of the shards, the wrapper's
    normalized result (scores rtol 1e-5, ids up to exact ties)."""
    q, c, want, got = sharded
    if fn == "shard_corpus":
        (blocks, m), (want_rows, want_m) = got[fn], want[fn]
        assert m == want_m == 13 and blocks.shape == want_rows.shape == (16, 16)
        np.testing.assert_array_equal(blocks, want_rows)
        return
    s, i = got[fn]
    assert_topk_match(s, i, *map(np.asarray, want[fn]), rtol=1e-5)
    assert (i >= 0).all() and (i < c.shape[0]).all()


@pytest.mark.parametrize("m_tile", [64, 100, 128, 256])
def test_pad_corpus_t_matches_jax(data, m_tile):
    _, C = data
    want, wm = j_fused.pad_corpus_t(C, m_tile=m_tile)
    got, gm = t_fused.pad_corpus_t(C, m_tile=m_tile)
    assert gm == wm == 200
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    got_t, _ = t_fused.pad_corpus_t(_t(C), m_tile=m_tile)  # a tensor in
    np.testing.assert_array_equal(got_t.numpy(), want)


def _jax_chunk_max(Q, ct, chunk, m_tile, m_real, precision, epilogue):
    """The TPU kernel itself (``_cmax_kernel``) in interpret mode, with the
    reference's grid and blocks (``dense_topk_pallas.py:207-230``)."""
    B, d = Q.shape
    m = ct.shape[1]
    return np.asarray(pl.pallas_call(
        functools.partial(
            j_fused._cmax_kernel, chunk=chunk, m_real=m_real,
            precision=precision, epilogue=epilogue,
        ),
        grid=(m // m_tile,),
        in_specs=[
            pl.BlockSpec((B, d), lambda i: (0, 0)),
            pl.BlockSpec((d, m_tile), lambda i: (0, i)),
        ],
        out_specs=pl.BlockSpec((B, m_tile // chunk), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((B, m // chunk), jnp.float32),
        interpret=True,
    )(jnp.asarray(Q), ct))


@pytest.mark.parametrize("epilogue", ["loop", "fold"])
@pytest.mark.parametrize("precision,bf16", [
    ("highest", False), ("high3", False), ("default", True),
])
def test_chunk_max_matches_the_pallas_kernel(data, epilogue, precision, bf16):
    """Phase 1 alone, ``m_real`` below ``M_pad`` (the -inf pad columns):
    the plain version against the Pallas kernel, within 1e-6 absolute (the
    same exact bf16 or fp32 products, summed in another order)."""
    Q, C = data
    ct, m_real = j_fused.pad_corpus_t(C, m_tile=128)  # 200 -> 256
    j_ct = jnp.asarray(ct).astype(jnp.bfloat16) if bf16 else jnp.asarray(ct)
    want = _jax_chunk_max(Q, j_ct, 16, 128, m_real, precision, epilogue)
    t_ct = _t(ct).to(torch.bfloat16) if bf16 else _t(ct)
    got = t_fused.chunk_max(_t(Q), t_ct, 16, 128, m_real, precision, epilogue)
    assert got.shape == want.shape == (16, 16)
    pad = ~np.isfinite(want)
    # loop: the last 3 chunks (columns 208-255) hold pads only; fold: every
    # chunk of the last tile spans columns 128-255 and holds real ones
    assert pad.sum() == (16 * 3 if epilogue == "loop" else 0)
    np.testing.assert_array_equal(~np.isfinite(got.numpy()), pad)
    np.testing.assert_allclose(got.numpy()[~pad], want[~pad], rtol=0, atol=1e-6)


def test_chunk_max_default_precision_is_the_bf16_one_pass_dot(data):
    """``None``/``"default"`` on an f32 corpus: the TPU runs the bf16
    1-pass dot, which interpret mode on the CPU does not reproduce (it dots
    in f32), so the reference here is numpy on bf16-rounded inputs, held to
    1e-6 absolute."""
    Q, C = data
    ct, m_real = j_fused.pad_corpus_t(C, m_tile=64)
    r = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    s = r(Q) @ r(ct)
    s[:, m_real:] = -np.inf
    want = s.reshape(16, -1, 8).max(axis=2)
    for precision in (None, "default"):
        got = t_fused.chunk_max(_t(Q), _t(ct), 8, 64, m_real, precision, "loop")
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _jax_fused(Q, ct, **kw):
    return j_fused.cosine_topk_fused(jnp.asarray(Q), jnp.asarray(ct), interpret=True, **kw)


@pytest.mark.parametrize("kw", [
    dict(chunk=25, m_tile=100),
    dict(chunk=16, m_tile=128, epilogue="fold"),
    dict(chunk=32, m_tile=128, epilogue="fold"),
    dict(chunk=16, m_tile=128, epilogue="fold", precision="high3"),
    dict(chunk=8, m_tile=64, epilogue="loop", precision="highest"),
    dict(chunk=32, m_tile=256, epilogue="fold", precision="highest", k=7),
], ids=["loop", "fold16", "fold32", "fold-high3", "loop-highest", "fold-highest"])
def test_cosine_topk_fused_matches_jax(data, kw):
    Q, C = data
    kw = dict(kw)
    k = kw.pop("k", 5)
    ct, m_real = j_fused.pad_corpus_t(C, m_tile=kw["m_tile"])
    want = _jax_fused(Q, ct, k=k, m_real=m_real, **kw)
    got = t_fused.cosine_topk_fused(_t(Q), _t(ct), k=k, m_real=m_real, **kw)
    assert got[1].dtype == torch.int32
    _match(got, want)


def test_cosine_topk_fused_bf16_corpus_with_slack_matches_jax(data):
    Q, C = data
    ct, m_real = j_fused.pad_corpus_t(C, m_tile=100)
    rows = np.ascontiguousarray(ct.T)
    want = j_fused.cosine_topk_fused(
        jnp.asarray(Q), jnp.asarray(ct).astype(jnp.bfloat16), k=5, chunk=25,
        m_tile=100, m_real=m_real, precision="default", extra_chunks=2,
        corpus_rows=jnp.asarray(rows), interpret=True,
    )
    got = t_fused.cosine_topk_fused(
        _t(Q), _t(ct).to(torch.bfloat16), k=5, chunk=25, m_tile=100,
        m_real=m_real, precision="default", extra_chunks=2, corpus_rows=_t(rows),
    )
    _match(got, want)


def test_cosine_topk_fused_negative_cosines_never_lose_to_pads():
    """Every cosine negative: the zero-padded columns (cosine 0) must never
    be returned, in phase 1 or in the rescore."""
    rng = np.random.default_rng(4)
    Q = _norm(rng.normal(size=(6, 16))).astype(np.float32)
    C = _norm(-Q[:1] + 0.01 * rng.normal(size=(13, 16))).astype(np.float32)
    ct, m_real = j_fused.pad_corpus_t(C, m_tile=32)
    want = _jax_fused(Q, ct, k=5, chunk=8, m_tile=32, m_real=m_real)
    got = t_fused.cosine_topk_fused(_t(Q), _t(ct), k=5, chunk=8, m_tile=32,
                                    m_real=m_real)
    assert int(got[1].max()) < 13
    _match(got, want)


def _fused_errors(mod, Q, ct, ct_bf16, rows):
    """Each refused argument combination, as (name, call)."""
    return [
        ("m_tile", lambda: mod.cosine_topk_fused(Q, ct, k=5, chunk=20, m_tile=100)),
        ("chunk", lambda: mod.cosine_topk_fused(Q, ct, k=5, chunk=24, m_tile=64)),
        ("unknown", lambda: mod.cosine_topk_fused(Q, ct, k=5, chunk=16, m_tile=64,
                                                  precision="fast")),
        ("high", lambda: mod.cosine_topk_fused(Q, ct, k=5, chunk=16, m_tile=64,
                                               precision="high")),
        ("no rows", lambda: mod.cosine_topk_fused(Q, ct_bf16, k=5, chunk=16,
                                                  m_tile=64, precision="default",
                                                  extra_chunks=2)),
        ("bf16 high3", lambda: mod.cosine_topk_fused(Q, ct_bf16, k=5, chunk=16,
                                                     m_tile=64, corpus_rows=rows)),
        ("bf16 highest", lambda: mod.cosine_topk_fused(Q, ct_bf16, k=5, chunk=16,
                                                       m_tile=64, corpus_rows=rows,
                                                       precision="highest")),
        ("fold npt", lambda: mod.cosine_topk_fused(Q, ct, k=5, chunk=16, m_tile=192,
                                                   epilogue="fold")),
        ("fold chunk", lambda: mod.cosine_topk_fused(Q, ct, k=5, chunk=12,
                                                     m_tile=48, epilogue="fold")),
    ]


def test_fused_refuses_what_the_reference_refuses(data):
    """Every ValueError of ``dense_topk_pallas.py:171-203``, and its asserts
    (which the port raises as ValueError: asserts vanish under -O)."""
    Q, C = data
    ct, _ = j_fused.pad_corpus_t(C, m_tile=192 * 4)  # 768: divides 48, 64, 192
    j_args = (jnp.asarray(Q), jnp.asarray(ct),
              jnp.asarray(ct).astype(jnp.bfloat16), jnp.asarray(ct.T))
    t_args = (_t(Q), _t(ct), _t(ct).to(torch.bfloat16), _t(ct.T))
    j_cases = dict(_fused_errors(j_fused, *j_args))
    t_cases = _fused_errors(t_fused, *t_args)
    for name, call in t_cases:
        with pytest.raises((ValueError, AssertionError)):
            j_cases[name]()
        with pytest.raises(ValueError):
            call()
    assert len(t_cases) == 9


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cosine_topk_fused_config_fuzz_matches_jax(seed):
    """``tests/test_dense.py``'s config fuzz, port against the Pallas kernel:
    random (M, D, m_tile, chunk, epilogue, k), pads included."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(6):
        B = int(rng.integers(2, 9))
        D = int(rng.choice([8, 16, 32]))
        M = int(rng.integers(40, 400))
        m_tile = int(rng.choice([64, 128, 256]))
        chunk = min(int(rng.choice([8, 16, 32])), m_tile)
        k = int(rng.integers(1, 6))
        epi = str(rng.choice(["loop", "fold"]))
        Q = _norm(rng.normal(size=(B, D))).astype(np.float32)
        C = _norm(rng.normal(size=(M, D))).astype(np.float32)
        ct, m_real = j_fused.pad_corpus_t(C, m_tile=m_tile)
        kw = dict(k=k, chunk=chunk, m_tile=m_tile, m_real=m_real, epilogue=epi)
        want = _jax_fused(Q, ct, **kw)
        got = t_fused.cosine_topk_fused(_t(Q), _t(ct), **kw)
        _match(got, want, rtol=1e-5)


def test_chunk_max_refuses_other_devices_and_counts_only_launches(data):
    Q, C = data
    ct, m_real = j_fused.pad_corpus_t(C, m_tile=64)
    before = t_fused.chunk_max.launches
    t_fused.chunk_max(_t(Q), _t(ct), 16, 64, m_real)  # CPU: the plain version
    assert t_fused.chunk_max.launches == before
    with pytest.raises(ValueError, match="no chunk-max kernel"):
        t_fused.chunk_max(_t(Q).to("meta"), _t(ct).to("meta"), 16, 64, m_real)
    with pytest.raises(TypeError):
        t_fused.chunk_max(_t(Q).double(), _t(ct), 16, 64, m_real)


# ---- the pre-split corpus (scripts/probe_dense_presplit.py) ------------------

def _probe_presplit_topk():
    """``make_presplit_topk()`` of the probe script, loaded from its file
    (``scripts/`` is not a package)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "probe_dense_presplit.py")
    spec = importlib.util.spec_from_file_location("probe_dense_presplit", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_presplit_topk()


def _presplit(C, m_tile):
    ct, m_real = t_fused.pad_corpus_t(_t(C), m_tile)
    hi, lo = split_hi_lo(ct)
    return ct, hi, lo, m_real


@pytest.mark.parametrize("k,m_tile,chunk", [(5, 128, 16), (3, 256, 32), (7, 64, 8)])
def test_presplit_topk_matches_the_probe_kernel(data, k, m_tile, chunk):
    """``cosine_topk_fused_presplit`` against the probe's Pallas kernel and
    phase 2, run in TPU interpret mode under its own ``jax.jit``: the same
    exact bf16 products summed in another order select the same chunks, and
    both rescore in fp32 (rtol 1e-6)."""
    from jax.experimental.pallas.tpu import force_tpu_interpret_mode

    Q, C = data
    ct, hi, lo, m_real = _presplit(C, m_tile)
    rows = ct.T.contiguous()
    got = t_fused.cosine_topk_fused_presplit(
        _t(Q), hi, lo, rows, k=k, chunk=chunk, m_tile=m_tile, m_real=m_real
    )
    j_hi = jnp.asarray(ct.numpy()).astype(jnp.bfloat16)
    j_lo = (jnp.asarray(ct.numpy()) - j_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(hi.view(torch.int16).numpy(),
                                  np.asarray(j_hi).view(np.int16))
    np.testing.assert_array_equal(lo.view(torch.int16).numpy(),
                                  np.asarray(j_lo).view(np.int16))
    with force_tpu_interpret_mode():
        want = _probe_presplit_topk()(
            jnp.asarray(Q), j_hi, j_lo, jnp.asarray(rows.numpy()),
            k=k, chunk=chunk, m_tile=m_tile, m_real=m_real,
        )
    assert got[1].dtype == torch.int32
    _match(got, want)
    exact = np.sort(Q @ C.T, axis=1)[:, ::-1][:, :k]
    np.testing.assert_allclose(got[0].numpy(), exact, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("epilogue", ["fold", "loop"])
def test_chunk_max_presplit_equals_high3_on_the_same_corpus(data, epilogue):
    """On the halves of an f32 corpus the pre-split chunk maxima are
    ``chunk_max(precision="high3")``'s bit for bit (the same products and
    grouping), -inf pads included; the full top-k then agrees too."""
    Q, C = data
    ct, hi, lo, m_real = _presplit(C, 128)
    got = t_fused.chunk_max_presplit(_t(Q), hi, lo, 16, 128, m_real, epilogue)
    want = t_fused.chunk_max(_t(Q), ct, 16, 128, m_real, "high3", epilogue)
    assert got.shape == (16, 16)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        t_fused.chunk_max_presplit_ref(_t(Q), hi, lo, 16, 128, m_real, epilogue).numpy(),
        want.numpy(),
    )
    rows = ct.T.contiguous()
    a = t_fused.cosine_topk_fused_presplit(
        _t(Q), hi, lo, rows, k=5, chunk=16, m_tile=128, m_real=m_real, epilogue=epilogue)
    b = t_fused.cosine_topk_fused(
        _t(Q), ct, k=5, chunk=16, m_tile=128, m_real=m_real, epilogue=epilogue,
        precision="high3", corpus_rows=rows)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


def test_presplit_refuses_mismatched_halves(data):
    Q, C = data
    ct, hi, lo, m_real = _presplit(C, 128)
    with pytest.raises(TypeError, match="bfloat16"):
        t_fused.chunk_max_presplit(_t(Q), ct, ct, 16, 128, m_real)
    with pytest.raises(ValueError, match="must match"):
        t_fused.chunk_max_presplit(_t(Q), hi, lo[:, :128].contiguous(), 16, 128, m_real)
    with pytest.raises(ValueError, match="multiple of m_tile"):
        t_fused.chunk_max_presplit(_t(Q), hi, lo, 16, 100, m_real)
    with pytest.raises(ValueError, match="power-of-two"):
        t_fused.chunk_max_presplit(_t(Q), hi[:, :240].contiguous(),
                                   lo[:, :240].contiguous(), 40, 120, 200)
    assert t_fused.chunk_max_presplit.launches == 0


# ---- which kernel of csrc/dense_cmax.cu takes a call --------------------------

@pytest.mark.parametrize("mode,D,chunk,m_tile,epilogue,want", [
    (1, 128, 32, 8192, "fold", "mma"),   # bench_dense.py's shape, high3
    (2, 128, 32, 8192, "fold", "mma"),   # its precision=None
    (3, 128, 32, 8192, "fold", "mma"),   # a bf16 corpus
    (4, 128, 32, 8192, "fold", "mma"),   # the pre-split corpus
    (0, 128, 32, 8192, "fold", "simt"),  # "highest": fp32 products
    (0, 128, 32, 1024, "loop", "simt"),
    (1, 128, 128, 512, "fold", "simt"),  # the defaults: 4 chunks a tile
    (1, 128, 16, 1024, "fold", "mma"),   # 64 chunks a tile
    (1, 128, 32, 1024, "fold", "simt"),  # 32 chunks a tile
    (1, 32, 32, 1024, "loop", "mma"),
    (2, 48, 16, 128, "loop", "mma"),
    (3, 16, 8, 64, "loop", "mma"),
    (1, 128, 64, 1024, "loop", "simt"),  # a chunk wider than a warp's columns
    (1, 128, 32, 96, "loop", "simt"),    # m_tile not a multiple of 64
    (1, 40, 32, 8192, "fold", "simt"),   # D not a multiple of 16
    (1, 144, 32, 8192, "fold", "simt"),  # D past the shared-memory tile
    (3, 8, 8, 64, "loop", "simt"),
])
def test_chunk_max_route(mode, D, chunk, m_tile, epilogue, want):
    assert t_fused.chunk_max_route(mode, D, chunk, m_tile, epilogue) == want
    # the pre-split corpus (mode 4) goes where high3 (mode 1) goes
    if mode == 1:
        assert t_fused.chunk_max_route(4, D, chunk, m_tile, epilogue) == want


@pytest.mark.parametrize("precision,bf16,mode,route", [
    (None, False, 2, "mma"),
    ("default", False, 2, "mma"),
    ("high3", False, 1, "mma"),
    ("highest", False, 0, "simt"),
    ("high3", True, 3, "mma"),
    ("highest", True, 3, "mma"),  # a bf16 corpus runs the 1-pass dot
])
def test_each_precision_takes_its_mode_and_route(precision, bf16, mode, route):
    dtype = torch.bfloat16 if bf16 else torch.float32
    got = t_fused._mode(precision, dtype)
    assert got == mode
    assert t_fused.chunk_max_route(got, 128, 32, 8192, "fold") == route


def test_cpu_tensors_launch_no_route(data):
    Q, C = data
    ct, hi, lo, m_real = _presplit(C, 128)
    before = (t_fused.chunk_max.launches, dict(t_fused.chunk_max.launches_by_route),
              t_fused.chunk_max_presplit.launches,
              dict(t_fused.chunk_max_presplit.launches_by_route))
    t_fused.chunk_max(_t(Q), ct, 16, 128, m_real, "high3", "loop")
    t_fused.chunk_max_presplit(_t(Q), hi, lo, 16, 128, m_real, "fold")
    assert before == (t_fused.chunk_max.launches, t_fused.chunk_max.launches_by_route,
                      t_fused.chunk_max_presplit.launches,
                      t_fused.chunk_max_presplit.launches_by_route)
    assert set(before[1]) == {"mma", "simt"}


def test_launch_checks_come_before_the_kernels_load():
    """What the launch refuses before it builds anything: a corpus that is
    not contiguous, a tensor the tensor-core kernel cannot read 16 bytes at a
    time, and more chunks than either grid holds."""
    q = torch.zeros(4, 32)
    ct = torch.zeros(32, 2048)
    launch = functools.partial(t_fused._launch_chunk_max, t_fused.chunk_max)
    with pytest.raises(ValueError, match="contiguous"):
        launch(q, ct.T.contiguous().T, None, 32, 2048, 2048, 1, "fold")
    shifted = torch.zeros(32 * 2048 + 1)[1:].view(32, 2048)
    with pytest.raises(ValueError, match="16-byte aligned"):
        launch(q, shifted, None, 32, 2048, 2048, 1, "fold")
    wide = torch.empty(32, 65536 * 128 * 8, device="meta")
    with pytest.raises(ValueError, match="mma kernel's grid"):
        launch(q.to("meta"), wide, None, 8, 512, wide.shape[1], 1, "fold")
    with pytest.raises(ValueError, match="simt kernel's grid"):
        launch(q.to("meta"), wide, None, 8, 512, wide.shape[1], 0, "fold")
