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


@pytest.mark.parametrize(
    "fn,nargs", [("shard_corpus", 2), ("make_sharded_topk", 2),
                 ("sharded_cosine_topk", 4)]
)
def test_sharded_scorer_waits_for_item_12(fn, nargs):
    with pytest.raises(NotImplementedError, match="item 12"):
        getattr(t_sc, fn)(*([None] * nargs))


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
