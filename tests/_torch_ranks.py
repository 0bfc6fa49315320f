"""Rank targets of the port's multi-rank parity tests.

``ircl_tpu_torch.parallel.launch`` runs these in spawned ranks of a gloo
group on the CPU, which import this module afresh: so it imports neither
JAX nor the JAX package (``tests/conftest.py`` is not loaded there), and
the test modules, which import JAX at their top, hand it numpy inputs.
Each target checks that every rank returned rank 0's bits, then returns
rank 0's results as numpy arrays.
"""

import contextlib
import io
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist


def _no_tensorflow():
    """The trainer's MetricsLogger mirrors to TensorBoard, whose import
    loads TensorFlow where it is installed (tens of seconds a rank); hidden,
    the writer takes tensorboard's own stub."""
    sys.modules["tensorflow"] = None


def _same_on_every_rank(out):
    """Rank 0's ``out``, after checking every rank holds its bits."""
    blobs = [None] * dist.get_world_size()
    dist.all_gather_object(blobs, pickle.dumps(out))
    if any(b != blobs[0] for b in blobs):
        raise AssertionError("the ranks returned different results")
    return out


def _np(tree):
    from ircl_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else x, tree)


def state_np(st):
    return dict(params_q=_np(st.params_q), params_k=_np(st.params_k),
                opt_state=_np(st.opt_state), queue=st.queue.numpy(),
                queue_ptr=st.queue_ptr, step=st.step)


# ---- corpus-sharded scoring ----------------------------------------------------


def sharded_scoring(cases):
    """Every sharded scorer on one ``corpus`` mesh; ``embed_corpus`` on a
    ``data`` mesh of the same ranks."""
    from ircl_tpu_torch.dense.scorer import sharded_cosine_topk
    from ircl_tpu_torch.parallel.mesh import make_mesh
    from ircl_tpu_torch.parallel.sharded_hybrid import ShardedHybridIndex
    from ircl_tpu_torch.parallel.sharded_index import ShardedEllIndex

    mesh = make_mesh(("corpus",), device="cpu")
    out = {}
    for name, c in cases.get("ell", {}).items():
        out[name] = ShardedEllIndex(c["ell"], mesh).topk(
            c["u"], c["qb_t"], c["qw_t"], k=c["k"])
    if "hybrid" in cases:
        c = cases["hybrid"]
        idx = ShardedHybridIndex(c["split"], mesh)
        out["hybrid"] = idx.topk(c["u"], c["qb_t"], c["qw_t"], c["light_docs"],
                                 c["light_contribs"], k=c["k"])
        out["hybrid_routed"] = idx.route_light(c["light_docs"], c["light_contribs"])
    for name, (q, corpus, k) in cases.get("dense", {}).items():
        out[name] = sharded_cosine_topk(q, corpus, k, mesh)
    if "embed" in cases:
        out["embed"] = _embed(**cases["embed"])
    return _same_on_every_rank(out)


def _embed(cfg, feat_cfg, feat_params, params_q, texts, batch_size):
    from ircl_tpu_torch.contrastive.train import make_embed_fn
    from ircl_tpu_torch.dense.embed import embed_corpus
    from ircl_tpu_torch.parallel.mesh import make_mesh
    from ircl_tpu_torch.utils import convert

    feat = _featurizer(feat_cfg, feat_params)
    params = convert.encoder_params_from_numpy(params_q, device="cpu")
    return embed_corpus(make_embed_fn(cfg, feat), params, feat, texts,
                        batch_size=batch_size, mesh=make_mesh(("data",), device="cpu"))


def dense_functions(q, corpus, k):
    """``shard_corpus``, ``make_sharded_topk`` and ``sharded_cosine_topk``
    one by one: each rank's block of rows, the merged top-k of the shards,
    and the wrapper's result."""
    from ircl_tpu_torch.dense import scorer
    from ircl_tpu_torch.parallel.common import all_gather_rows
    from ircl_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(("corpus",), device="cpu")
    shard, m = scorer.shard_corpus(corpus, mesh)
    blocks = torch.cat(all_gather_rows(shard, mesh, "corpus")).numpy()
    s, i = scorer.make_sharded_topk(mesh, k, true_m=m)(q, shard)
    return _same_on_every_rank(dict(
        shard_corpus=(blocks, m),
        make_sharded_topk=(s.numpy(), i.numpy()),
        sharded_cosine_topk=scorer.sharded_cosine_topk(q, corpus, k, mesh),
    ))


# ---- data-parallel training ----------------------------------------------------


def _featurizer(feat_cfg, feat_params):
    from ircl_tpu_torch.models.featurizer import HashEmbedFeaturizer
    from ircl_tpu_torch.utils import convert

    return HashEmbedFeaturizer(feat_cfg, device="cpu",
                               params=convert.hash_featurizer_params_from_numpy(
                                   feat_params, device="cpu"))


def dp_runs(step_cases, trainer_cases):
    """The DP step cases and the trainer cases on one ``data`` mesh."""
    _no_tensorflow()
    from ircl_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(("data",), device="cpu")
    return _same_on_every_rank(dict(
        placed=_placed(mesh, **step_cases["nt-xent"]),
        steps={name: _dp_steps(mesh, **c) for name, c in step_cases.items()},
        trainers={name: _dp_trainers(mesh, **c) for name, c in trainer_cases.items()},
    ))


def _placed(mesh, cfg, feat_cfg, feat_params, **_):
    """``place_state`` of a state whose values differ by rank (rank r's is
    ``init_train_state(r)``): rank 0's values on every rank, each leaf in
    its own layout (``init_train_state``'s recurrent weights are transposed
    views)."""
    from ircl_tpu_torch.contrastive.state import init_train_state
    from ircl_tpu_torch.parallel.dp import make_dp_train_step
    from ircl_tpu_torch.utils.tree import tree_leaves

    place_state = make_dp_train_step(cfg, _featurizer(feat_cfg, feat_params), mesh)[1]
    mine = init_train_state(dist.get_rank(), cfg, device="cpu")
    placed = place_state(mine)

    def leaves(st):
        return tree_leaves(st.params_q) + tree_leaves(st.params_k) + [st.queue]

    return dict(values=state_np(placed),
                same_layout=all(a.stride() == b.stride()
                                for a, b in zip(leaves(placed), leaves(mine))),
                transposed=sum(not a.is_contiguous() for a in leaves(placed)))


def _dp_steps(mesh, cfg, feat_cfg, feat_params, state, steps):
    """``make_dp_train_step`` from a carried state over ``steps``; per step
    the loss and gradient norm, then the state."""
    from ircl_tpu_torch.parallel.dp import make_dp_train_step
    from ircl_tpu_torch.utils import convert

    step, place_state, place_batch, place_proto = make_dp_train_step(
        cfg, _featurizer(feat_cfg, feat_params), mesh)
    st = place_state(convert.train_state_from_numpy(**state, device="cpu"))
    hist = []
    for batch, proto in steps:
        st, loss, norm = step(st, *place_batch(*batch), place_proto(proto))
        hist.append((float(loss), float(norm)))
    return dict(hist=hist, state=state_np(st))


def _rank_dependent(run):
    """``run`` whose results move by this rank's number, as float atomics
    can make the ranks' k-means differ on the card: rank 0's stay as they
    are."""
    from ircl_tpu_torch.contrastive.cluster import ClusterResult

    def wrapped(*args, **kwargs):
        cr, r = run(*args, **kwargs), dist.get_rank()
        return ClusterResult([(e + r) % c.shape[0] for e, c in zip(cr.emb2cluster, cr.centroids)],
                             [c + r for c in cr.centroids], [d + r for d in cr.density])

    return wrapped


def _dp_trainers(mesh, cfg, feat_cfg, feat_params, docs, steps, log_step, ckptdir,
                 logdir, rank_dependent_refresh=False):
    """``ContrastiveTrainer(mesh=)`` for ``steps`` steps and a fresh one that
    resumes from rank 0's checkpoint; beside them the single-device trainer
    (in a directory of each rank's own); with ``rank_dependent_refresh``,
    also the DP trainer whose ranks' cluster refreshes differ."""
    from unittest import mock

    from ircl_tpu_torch.contrastive import trainer as trainer_module
    from ircl_tpu_torch.contrastive.trainer import ContrastiveTrainer
    from ircl_tpu_torch.data.pairs import DocPairSampler

    feat = _featurizer(feat_cfg, feat_params)

    def trainer(mesh, sub):
        return ContrastiveTrainer(
            cfg, feat, DocPairSampler(docs, sample="uniform", seed=3),
            ckptdir=f"{ckptdir}/{sub}", logdir=f"{logdir}/{sub}", seed=5, mesh=mesh,
            device="cpu")

    out = {}
    for sub, m in (("dp", mesh), (f"single{dist.get_rank()}", None)):
        t = trainer(m, sub)
        st = t.train(total_steps=steps, log_step=log_step)
        out[sub] = dict(state=state_np(st), refreshes=t.refresh_count)
    if rank_dependent_refresh:
        with mock.patch.object(trainer_module, "run_kmeans",
                               _rank_dependent(trainer_module.run_kmeans)):
            t = trainer(mesh, "rank_dependent")
            st = t.train(total_steps=steps, log_step=log_step)
        out["rank_dependent"] = dict(state=state_np(st), refreshes=t.refresh_count)
    resumed = trainer(mesh, "dp")
    out["dp"].update(
        resumed_at=resumed.maybe_resume(),
        resumed_equal=pickle.dumps(state_np(resumed.state)) == pickle.dumps(
            out["dp"]["state"]),
        checkpoints=sorted(f[len(resumed.tag):] for f in os.listdir(f"{ckptdir}/dp")),
    )
    out["single"] = out.pop(f"single{dist.get_rank()}")
    return out


def cli_main(argv):
    """``python -m ircl_tpu_torch.cli`` in this rank; its standard output."""
    _no_tensorflow()
    from ircl_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def loaded_jax_modules():
    """A 2-rank ``sharded_cosine_topk``; the JAX modules each rank loaded."""
    from ircl_tpu_torch.dense.scorer import sharded_cosine_topk
    from ircl_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    c = rng.normal(size=(13, 8)).astype(np.float32)
    sharded_cosine_topk(c[:3], c, 5, make_mesh(("corpus",), device="cpu"))
    mine = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "ircl_tpu"))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def raise_on_rank(bad):
    """Rank ``bad`` raises; the others wait for it in a collective."""
    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} was told to fail")
    dist.barrier()
