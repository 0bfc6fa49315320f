"""The port's pure-tensor ELL scorer (``ircl_tpu_torch/ops/membership.py``)
against ``ircl_tpu.ops.membership`` and against the port's
``membership_topk_fused``.

Inputs are ``tests/test_membership.py``'s: an 80-doc synthetic corpus
(``generate(seed=3)``), its 40 claims, bigrams hashed into 2^20 buckets, the
doc-major ELL index, the batch's sorted union and its padded query arrays.
Tolerances: ``build_w`` exactly equal (each cell adds one weight to zero);
``membership_dense_scores`` within rtol 1e-5 (full fp32 products, summed in
another order); the top-k's scores within rtol 1e-5 and its ids equal
except across exact ties (``assert_topk_match``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_topk_match, one_torch_thread  # noqa: F401
from ircl_tpu.corpus.store import MemoryDocStore
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.index.build import build_count_index
from ircl_tpu.index.ell import to_ell
from ircl_tpu.index.ranker import TfidfRanker
from ircl_tpu.index.tfidf import tfidf_transform
from ircl_tpu.ops import membership as j_mem
from ircl_tpu_torch.ops import membership as t_mem
from ircl_tpu_torch.ops import membership_cuda as mc

HASH_SIZE = 2**20
RTOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    wiki = generate(num_docs=80, num_claims=40, seed=3)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=HASH_SIZE))
    ranker = TfidfRanker(index, mode="ell")
    buckets, weights = ranker._vectorize([c.claim for c in wiki.claims])
    ell = to_ell(index)
    u_pad = ranker._union_slots(buckets, weights)
    return dict(terms=np.asarray(ell.terms, np.int32), vals=np.asarray(ell.vals, np.float32),
                u=np.asarray(u_pad, np.int32), qb=buckets.astype(np.int32),
                qw=np.asarray(weights, np.float32), num_docs=index.num_docs)


def _args(s, lib):
    conv = jnp.asarray if lib == "jax" else (lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    return tuple(conv(s[n]) for n in ("terms", "vals", "u", "qb", "qw"))


def test_build_w_matches_reference(setup):
    _, _, u, qb, qw = _args(setup, "jax")
    want = np.asarray(j_mem.build_w(u, qb, qw))
    _, _, u, qb, qw = _args(setup, "torch")
    got = t_mem.build_w(u, qb, qw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).any() and (setup["qw"] == 0).any()  # weights and pads


def test_build_w_drops_buckets_outside_the_union():
    u = np.array([3, 7, 9, 2**20], np.int32)  # sentinel-padded
    qb = np.array([[7, 5, 9, 0], [3, 3, 11, 2**20]], np.int32)
    qw = np.array([[1.5, 2.0, 0.25, 0.0], [1.0, 2.0, 4.0, 8.0]], np.float32)
    want = np.asarray(j_mem.build_w(*map(jnp.asarray, (u, qb, qw))))
    got = t_mem.build_w(*map(torch.from_numpy, (u, qb, qw)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[1, 0] == 3.0 and want[1, 3] == 8.0  # a repeated bucket adds


def test_dense_scores_match_reference(setup):
    want = np.asarray(j_mem.membership_dense_scores(*_args(setup, "jax")))
    got = t_mem.membership_dense_scores(*_args(setup, "torch"))
    assert got.shape == (len(setup["qb"]), setup["num_docs"])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    assert (want > 0).sum(axis=1).min() > 0


@pytest.mark.parametrize("k,doc_block", [(5, 1024), (5, 16), (3, 33), (200, 64)])
def test_topk_matches_reference_and_the_fused_engine(setup, k, doc_block):
    """Against ``ircl_tpu.ops.membership.membership_topk`` (one doc block,
    several, a block that does not divide N, k past N) and against the
    port's ``membership_topk_fused`` on the same index."""
    want_s, want_i = j_mem.membership_topk(*_args(setup, "jax"), k=k, doc_block=doc_block)
    got_s, got_i = t_mem.membership_topk(*_args(setup, "torch"), k=k, doc_block=doc_block)
    assert got_i.dtype == torch.int32
    assert_topk_match(got_s.numpy(), got_i.numpy(), want_s, want_i, rtol=RTOL)

    tt, vt = mc.pad_for_slab(np.ascontiguousarray(setup["terms"].T),
                             np.ascontiguousarray(setup["vals"].T), d_tile=256)
    qb, qw = mc.pad_for_slab(np.ascontiguousarray(setup["qb"].T),
                             np.ascontiguousarray(setup["qw"].T), d_tile=128)
    u = setup["u"]
    fused_s, fused_i = mc.membership_topk_fused(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (tt, vt, u, qb, qw)),
        k=k, num_real_docs=setup["num_docs"])
    B, kk = got_s.shape
    assert_topk_match(got_s.numpy(), got_i.numpy(), fused_s[:B, :kk].numpy(),
                      fused_i[:B, :kk].numpy(), rtol=RTOL)
