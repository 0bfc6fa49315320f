"""The port's ``ContrastiveTrainer``, checkpoints, pair sampling, similarity
and intrinsic metric against the JAX package's (``tests/test_trainer.py``,
``tests/test_data.py``, ``tests/test_intrinsic.py``).

``data/`` and ``pipeline/intrinsic.py`` are host numpy carried over line for
line, so batches, pair scores and metrics must be equal, not close. The
trainer runs from one state (the JAX trainer's, carried across by
``utils/convert.py``) over one sampler seed: its ``train_loss`` per
``log_step`` within 1e-4, as ``tests/test_torch_verdict_train.py`` holds
the verdict trainer's history, and its final parameters by that file's
Adam rule (no element further than 2 * N learning rates apart, at most one
in a thousand more than 1e-5).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from test_torch_contrastive_train import carry
from ircl_tpu.contrastive import state as j_state
from ircl_tpu.contrastive import trainer as j_trainer
from ircl_tpu.corpus.fever import Claim as JClaim
from ircl_tpu.corpus.synthetic import generate
from ircl_tpu.data import pairs as j_pairs
from ircl_tpu.data import similarity as j_sim
from ircl_tpu.models import encoder as j_enc
from ircl_tpu.models import featurizer as j_feat
from ircl_tpu.pipeline import intrinsic as j_intr
from ircl_tpu_torch import data as t_data
from ircl_tpu_torch.contrastive import state as t_state
from ircl_tpu_torch.contrastive import trainer as t_trainer
from ircl_tpu_torch.corpus.fever import Claim
from ircl_tpu_torch.data import pairs as t_pairs
from ircl_tpu_torch.data import similarity as t_sim
from ircl_tpu_torch.models import encoder as t_enc
from ircl_tpu_torch.models import featurizer as t_feat
from ircl_tpu_torch.pipeline import intrinsic as t_intr
from ircl_tpu_torch.utils import checkpoint as t_ckpt
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.utils.tree import tree_leaves

LR = 1e-3
ENC = dict(input_size=16, hidden_size=8, output_size=8, num_layers=1)
CFG = dict(queue_size=16, queue_start_steps=2, micro_batch=8, accum_steps=2,
           learning_rate=LR, cluster_start_steps=3, cluster_update_steps=2,
           num_clusters=(3, 4), num_neg_proto=2)
FEAT = dict(dim=16, max_len=8, vocab_buckets=1 << 10)


def _configs(**kw):
    kw = dict(CFG, **kw)
    return (j_state.TrainConfig(encoder=j_enc.EncoderConfig(**ENC), **kw),
            t_state.TrainConfig(encoder=t_enc.EncoderConfig(**ENC), **kw))


@pytest.fixture(scope="module")
def wiki():
    return generate(num_docs=40, num_claims=5, seed=5)


@pytest.fixture(scope="module")
def feats():
    j_f = j_feat.HashEmbedFeaturizer(j_feat.FeaturizerConfig(**FEAT))
    t_f = t_feat.HashEmbedFeaturizer(
        t_feat.FeaturizerConfig(**FEAT), device="cpu",
        params=convert.hash_featurizer_params_from_numpy(
            jax.tree.map(np.asarray, j_f.params), device="cpu"))
    return j_f, t_f


def _samplers(wiki, sample="uniform", seed=0):
    docs = list(wiki.sentences.values())
    sims = ((j_sim.sentence_pair_similarity(docs, hash_size=1 << 16),
             t_sim.sentence_pair_similarity(docs, hash_size=1 << 16))
            if sample == "tf_idf" else (None, None))
    return (j_pairs.DocPairSampler(docs, sample=sample, similarity=sims[0], seed=seed),
            t_pairs.DocPairSampler(docs, sample=sample, similarity=sims[1], seed=seed))


# -- data/ against the originals -------------------------------------------


@pytest.mark.parametrize("sample", ["uniform", "tf_idf", "augment"])
def test_pair_batches_are_equal(wiki, feats, sample):
    j_s, t_s = _samplers(wiki, sample, seed=3)
    j_f, t_f = feats
    want = list(j_s.batches(j_f, accum_steps=2, micro_batch=4, num_steps=3))
    got = list(t_s.batches(t_f, accum_steps=2, micro_batch=4, num_steps=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):  # doc_idx, ids_a, mask_a, ids_k, mask_k
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert t_s.sample_pairs(7)[1:] == j_s.sample_pairs(7)[1:]


@pytest.mark.parametrize("stem", [False, True])
def test_pair_scores_are_equal(stem):
    wiki = generate(num_docs=60, num_claims=5, seed=42, inflect_prob=0.4)
    docs = list(wiki.sentences.values()) + [["only one sentence here"], []]
    got = t_sim.sentence_pair_similarity(docs, hash_size=1 << 16, stem=stem)
    assert got == j_sim.sentence_pair_similarity(docs, hash_size=1 << 16, stem=stem)
    assert got[-2] == [((0, 0), 1.0)] and got[-1] == []


def test_data_exports_and_sources_match():
    """The copies export what the originals export and differ from them in
    the import lines and the note in the module docstring only."""
    import ircl_tpu.data as j_data

    assert t_data.__all__ == j_data.__all__
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("data/pairs", "data/similarity", "pipeline/intrinsic"):
        want = open(os.path.join(root, "ircl_tpu", name + ".py")).read()
        got = open(os.path.join(root, "ircl_tpu_torch", name + ".py")).read()
        want_lines = [ln.replace("ircl_tpu.", "ircl_tpu_torch.") for ln in want.splitlines()]
        extra = [ln for ln in got.splitlines() if ln not in set(want_lines)]
        assert len(extra) <= 3 and all("arried over" in ln or "imports" in ln
                                        or "JAX package" in ln for ln in extra), (name, extra)
        assert [ln for ln in want_lines if ln not in set(got.splitlines())] == [], name


def test_mean_claim_evidence_cosine_is_equal():
    """``tests/test_intrinsic.py``'s case through both modules."""
    sents = {"DocA": ["alpha beta evidence", "other"], "DocB": ["x", "gamma delta text"]}
    rows = [(1, "alpha beta", "SUPPORTS", {"DocA": [0]}),
            (2, "gamma delta", "SUPPORTS", {"DocB": [1]}),
            (3, "missing doc", "SUPPORTS", {"Nope": [0]})]

    def embed(texts):
        out = []
        for t in texts:
            v = np.array([float("alpha" in t), float("gamma" in t)]) + 1e-3
            out.append(v / np.linalg.norm(v))
        return np.stack(out)

    got = t_intr.mean_claim_evidence_cosine(embed, [Claim(*r) for r in rows], sents, seed=1)
    want = j_intr.mean_claim_evidence_cosine(embed, [JClaim(*r) for r in rows], sents,
                                             seed=1)
    assert got == want and got["pairs"] == 2 and got["mean_cosine"] > 0.99
    assert got["shuffled_cosine"] <= got["mean_cosine"]
    assert t_intr.claim_evidence_pairs([Claim(*r) for r in rows], sents) == (
        j_intr.claim_evidence_pairs([JClaim(*r) for r in rows], sents))


# -- the trainer ------------------------------------------------------------


def _losses(path, name="train_loss"):
    return [(r["step"], r[name]) for r in map(json.loads, open(path)) if name in r]


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _assert_same_state(a, b):
    """Equal bits, leaf by leaf by name (a state carried from the JAX package
    has its dict keys sorted, a fresh one the port's order)."""
    got, want = dict(_named(vars(a))), dict(_named(vars(b)))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_trainer_matches_the_reference_and_resumes(tmp_path, wiki, feats):
    """InfoNCE from one state and one sampler seed, across
    ``queue_start_steps``: the history and the final parameters; then the
    port's checkpoint, ``latest_checkpoint`` and a fresh trainer's
    ``maybe_resume``."""
    j_cfg, t_cfg = _configs()
    j_f, t_f = feats
    j_s, t_s = _samplers(wiki, seed=4)
    j_tr = j_trainer.ContrastiveTrainer(j_cfg, j_f, j_s, ckptdir=str(tmp_path / "jc"),
                                        logdir=str(tmp_path / "jl"), seed=5)
    t_tr = t_trainer.ContrastiveTrainer(t_cfg, t_f, t_s, ckptdir=str(tmp_path / "tc"),
                                        logdir=str(tmp_path / "tl"), seed=5, device="cpu")
    t_tr.state = carry(j_tr.state)
    j_tr.train(total_steps=4, log_step=2)
    state = t_tr.train(total_steps=4, log_step=2)
    want, got = _losses(j_tr.metrics.path), _losses(t_tr.metrics.path)
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 4]
    for (_, g), (_, w) in zip(got, want):
        assert abs(g - w) <= 1e-4
    for tree in ("params_q", "params_k"):
        w, g = dict(_named(jax.tree.map(np.asarray, getattr(j_tr.state, tree)))), dict(
            _named(getattr(state, tree)))
        for name in w:
            diff = np.abs(g[name] - w[name])
            assert diff.max() <= 2 * 4 * LR and (diff > 1e-5).mean() <= 1e-3, name
    np.testing.assert_allclose(state.queue.numpy(), np.asarray(j_tr.state.queue),
                               rtol=0, atol=1e-4)
    assert state.step == 4 and state.queue_ptr == int(j_tr.state.queue_ptr)

    path = t_ckpt.latest_checkpoint(str(tmp_path / "tc"), t_tr.tag)
    assert path and path.endswith("_4") and t_tr.tag == "uniform_InfoNCE_LSTM"
    assert t_ckpt.latest_checkpoint(str(tmp_path / "none"), t_tr.tag) is None
    fresh = t_trainer.ContrastiveTrainer(t_cfg, t_f, _samplers(wiki, seed=1)[1],
                                         ckptdir=str(tmp_path / "tc"),
                                         logdir=str(tmp_path / "tl"), device="cpu")
    assert fresh.maybe_resume() == 4
    _assert_same_state(fresh.state, state)
    assert fresh.train(total_steps=6, log_step=2).step == 6


def test_checkpoint_round_trip_and_refusals(tmp_path):
    _, cfg = _configs(optimizer="sgd")
    st = t_state.init_train_state(3, cfg, device="cpu")
    st.queue_ptr, st.step = 8, 12
    path = t_ckpt.save_state(str(tmp_path / "c"), "tag", st)
    assert os.path.basename(path) == "tag_12"
    assert os.listdir(tmp_path / "c") == ["tag_12"]  # no temporary file left
    back = t_ckpt.restore_state(path, t_state.init_train_state(4, cfg, device="cpu"))
    _assert_same_state(back, st)
    with pytest.raises(ValueError):  # another optimizer's state
        t_ckpt.restore_state(path, t_state.init_train_state(4, _configs()[1], device="cpu"))
    with pytest.raises(ValueError):  # another queue size
        t_ckpt.restore_state(path, t_state.init_train_state(
            4, _configs(optimizer="sgd", queue_size=32)[1], device="cpu"))
    # the sharded checkpoint without a mesh: whole tensors in this process
    # (the ranks' layouts: tests/test_torch_sharded_checkpoint.py)
    tree = {"params": st.params_q, "opt": st.opt_state}
    path = t_ckpt.save_sharded(str(tmp_path / "sharded"), tree)
    like = {"params": t_state.init_train_state(4, cfg, device="cpu").params_q,
            "opt": t_state.init_train_state(4, cfg, device="cpu").opt_state}
    before = [t.clone() for t in tree_leaves(like) if isinstance(t, torch.Tensor)]
    back = t_ckpt.restore_sharded(path, like)
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b
    after = [t for t in tree_leaves(like) if isinstance(t, torch.Tensor)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))  # like is untouched


@pytest.mark.parametrize("loss", ["ProtoNCE", "HProtoNCE"])
def test_proto_trainers_run_and_checkpoint(tmp_path, wiki, feats, loss):
    """``tests/test_trainer.py``'s ProtoNCE and HProtoNCE runs on the port:
    a refresh at step 4 (from ``cluster_start_steps`` 3, every 2 steps), a
    checkpoint at step 5 that a fresh trainer resumes from, which refreshes
    at once (5 is off the schedule) and again at step 6."""
    _, cfg = _configs(loss=loss)
    kw = dict(ckptdir=str(tmp_path / "c"), logdir=str(tmp_path / "l"), device="cpu")
    tr = t_trainer.ContrastiveTrainer(cfg, feats[1], _samplers(wiki)[1], **kw)
    state = tr.train(total_steps=5, log_step=5)
    assert state.step == 5 and tr.refresh_count == 1 and tr.refresh_seconds > 0
    cr = tr.cluster_result
    assert cr.num_granularities == 2
    for c, d in zip(cr.centroids, cr.density):
        np.testing.assert_allclose(torch.linalg.vector_norm(c, dim=1).numpy(), 1.0,
                                   rtol=1e-5)
        assert torch.isfinite(d).all() and (d > 0).all()
    assert all(np.isfinite(v) for _, v in _losses(tr.metrics.path))
    again = t_trainer.ContrastiveTrainer(cfg, feats[1], _samplers(wiki, seed=2)[1], **kw)
    assert again.maybe_resume() == 5
    again.train(total_steps=7, log_step=7)
    assert again.refresh_count == 2 and again.state.step == 7


def test_trainer_refusals(tmp_path, wiki, feats):
    _, cfg = _configs()
    kw = dict(ckptdir=str(tmp_path / "c"), logdir=str(tmp_path / "l"))
    with pytest.raises(TypeError, match="DeviceMesh"):  # mesh=: a DeviceMesh
        t_trainer.ContrastiveTrainer(cfg, feats[1], _samplers(wiki)[1], mesh=object(),
                                     device="cpu", **kw)
    if not torch.cuda.is_available():  # no device named: the card, or an error
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_trainer.ContrastiveTrainer(cfg, feats[1], _samplers(wiki)[1], **kw)
